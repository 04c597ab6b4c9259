"""PyTorch port, the ViT slice: models/vit.py + convert.py +
train/optim.py (AdamW) + parallel/step.py + ckpt/checkpoint.py against the
JAX package on the CPU.

A small ViT (depth 2, dim 64, 2 heads of 32, patch 4 on a 48×48 crop: 144
patches + cls = 145 tokens) keeps the sequence at 128 tokens or more, so
both sides take their flash path: the JAX package's Pallas kernels in
interpret mode, the port's kernel wrappers on their plain versions. The
JAX model's params are carried into the port with ``convert.py`` (the
ViT's leaves pass through in the JAX layout, stacked ``[depth, ...]``).
"""

import os

import jax
import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu.ckpt import checkpoint as jax_ckpt
from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.config import ModelConfig as JaxModelConfig
from dml_cnn_cifar10_tpu.config import OptimConfig as JaxOptimConfig
from dml_cnn_cifar10_tpu.models import param_count as jax_param_count
from dml_cnn_cifar10_tpu.models import vit as jax_vit
from dml_cnn_cifar10_tpu.models.registry import get_model as jax_get_model
from dml_cnn_cifar10_tpu.parallel import step as jax_step
from dml_cnn_cifar10_tpu_torch import ckpt, convert
from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig, OptimConfig
from dml_cnn_cifar10_tpu_torch.models.vit import ViT, param_count
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

torch.set_num_threads(2)

CPU = torch.device("cpu")
SMALL = dict(name="vit_tiny", vit_dim=64, vit_depth=2, vit_heads=2,
             logit_relu=False)
CROP = dict(crop_height=48, crop_width=48)


def _cfgs(**model):
    kw = {**SMALL, **model}
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(mcfg, seed=0):
    return _np(jax_vit.init_params(jax.random.key(seed), mcfg,
                                   JaxDataConfig(**CROP)))


def _port_model(pcfg, params_np=None):
    model = ViT(pcfg, DataConfig(**CROP))
    model.reset_parameters(torch.Generator().manual_seed(0))
    if params_np is not None:
        model.load_state_dict(convert.params_from_jax(params_np))
    return model


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 48, 48, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_param_count_and_convert_round_trip_are_exact(pool):
    jcfg, pcfg = _cfgs(pool=pool)
    params = _jax_params(jcfg, seed=1)
    model = _port_model(pcfg, params)
    assert param_count(model) == jax_param_count(params)
    assert model.seq == 144 + (pool == "cls")
    named = dict(model.named_parameters())
    flat = convert.params_from_jax(params)
    assert sorted(named) == sorted(flat)
    assert ("cls" in named) == (pool == "cls")
    # Stacked per-block leaves keep the JAX layout: [depth, ...], no
    # transpose of the 2-D LayerNorm/bias stacks.
    assert named["blocks.ln1.scale"].shape == (2, 64)
    assert named["blocks.qkv.bias"].shape == (2, 192)
    assert named["blocks.qkv.kernel"].shape == (2, 64, 192)
    assert named["patch.kernel"].shape == (4, 4, 3, 64)          # HWIO
    back = convert.params_to_jax({k: v.detach() for k, v in named.items()})
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for path, want in leaves:
        got = back
        for key in path:
            got = got[key.key]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_full_width_vit_tiny_matches_the_jax_geometry():
    """ViT-Ti at the main path's 64×64 crop: 257 tokens, 5,399,626 f32
    params, the same leaf shapes as the JAX model."""
    jcfg = JaxModelConfig(name="vit_tiny", logit_relu=False)
    data = dict(crop_height=64, crop_width=64)
    shapes = jax.eval_shape(lambda: jax_vit.init_params(
        jax.random.key(0), jcfg, JaxDataConfig(**data)))
    model = ViT(ModelConfig(name="vit_tiny", logit_relu=False),
                DataConfig(**data))
    assert model.seq == 257 and param_count(model) == 5_399_626
    want = {".".join(k.key for k in path): tuple(s.shape)
            for path, s in jax.tree_util.tree_leaves_with_path(shapes)}
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == want


@pytest.mark.parametrize("kw", [dict(), dict(pool="mean"),
                                dict(attn_causal=True),
                                dict(attn_window=24, pool="mean")],
                         ids=["cls", "mean", "causal", "window"])
def test_forward_matches_jax(kw):
    jcfg, pcfg = _cfgs(**kw)
    params = _jax_params(jcfg, seed=2)
    images, _ = _images(4, seed=3)
    want = np.asarray(jax_vit.apply(params, images, jcfg))
    with torch.no_grad():
        got = _port_model(pcfg, params)(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_remat_gives_the_same_grads():
    _, pcfg = _cfgs()
    _, remat_cfg = _cfgs(remat=True)
    images = torch.from_numpy(_images(2, seed=4)[0])
    grads = []
    for cfg in (pcfg, remat_cfg):
        model = _port_model(cfg)
        loss = torch.sin(model(images)).sum()
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def _jax_setup(mcfg, **optim):
    ocfg = JaxOptimConfig(**optim)
    model_def = jax_get_model("vit_tiny")
    state = jax_step.init_train_state(jax.random.key(0), model_def, mcfg,
                                      JaxDataConfig(**CROP), ocfg)
    return model_def, ocfg, state


def _port_state(pcfg, params_np, **optim):
    model = ViT(pcfg, DataConfig(**CROP))
    ocfg = OptimConfig(**optim)
    state = step_lib.init_train_state(model, ocfg, CPU,
                                      torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, value in convert.params_from_jax(params_np).items():
            state.params[name].copy_(value)
    return model, ocfg, state


# AdamW's first steps move each weight by about lr·sign(g), so an element
# whose gradient is rounding noise in both frameworks may land up to 2·lr
# away per step. The attention key bias is such an element: a key bias
# adds q_i·b_k to every score of row i, which softmax cancels, so its exact
# gradient is 0 (measured: 9.2e-4 apart after five steps at lr 1e-3).
# Those elements are held to 5 steps x 2·lr; every other element of the
# params and of both moments to the SGD pin, 1e-5.
OPTIMS = [dict(learning_rate=0.01, momentum=0.9, weight_decay=5e-4),
          dict(optimizer="adamw", learning_rate=1e-3, weight_decay=0.05,
               schedule="cosine", warmup_steps=2, cosine_decay_steps=10)]


@pytest.mark.parametrize("optim", OPTIMS, ids=["sgd_momentum", "adamw"])
def test_five_train_steps_match_jax(optim):
    jcfg, pcfg = _cfgs()
    model_def, jocfg, jstate = _jax_setup(jcfg, **optim)
    model, ocfg, state = _port_state(pcfg, _np(jstate.params), **optim)
    jtrain = jax_step.make_train_step(model_def, jcfg, jocfg)
    train = step_lib.make_train_step(model, ocfg)
    for i in range(5):
        images, labels = _images(8, seed=10 + i)
        jstate, jm = jtrain(jstate, images, labels)
        state, m = train(state, torch.from_numpy(images),
                         torch.from_numpy(labels.astype(np.int64)))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert float(m["accuracy"]) == float(jm["accuracy"])
    assert int(state.step) == int(jstate.step) == 5
    for key, have in (("params", state.params),
                      *((k, state.opt[k]) for k in ("momentum", "mu", "nu")
                        if k in state.opt)):
        tree = jstate.params if key == "params" else jstate.opt[key]
        want = convert.params_from_jax(_np(tree))
        assert sorted(want) == sorted(have)
        for name, t in have.items():
            got, ref = t.detach().numpy(), want[name].numpy()
            if name == "blocks.qkv.bias" and key == "params" \
                    and ocfg.optimizer == "adamw":
                # [depth, heads, q|k|v, head_dim]: the key slice.
                got, ref = (a.reshape(2, 2, 3, 32) for a in (got, ref))
                np.testing.assert_allclose(got[:, :, 1], ref[:, :, 1],
                                           rtol=0,
                                           atol=5 * 2 * ocfg.learning_rate)
                got, ref = got[:, :, 0::2], ref[:, :, 0::2]
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5,
                                       err_msg=f"{key}.{name}")


# The long-context recipe's path at the test's width: bf16 compute, mean
# pool, remat, AdamW. Both frameworks round to bf16 (unit roundoff U =
# 2^-8) after every op, but not at the same places (JAX's LayerNorm rounds
# each elementwise op, torch's rounds its output once), so the pins are
# multiples of U:
# - loss: U relative (an f32 loss of bf16 logits moves by one rounding of
#   them; measured 1.9e-4);
# - AdamW's moments mu and nu, linear and quadratic in the gradients, by
#   relative Frobenius distance per leaf: 8 U. The JAX package's own bf16
#   run is up to 0.024 (6 U) from its f32 run, and two such runs that
#   round at different places may differ by their sum; measured at most
#   0.021 (5.3 U). A 2% error in the bf16 attention scale reaches 0.038.
#   The LayerNorm leaves 128 U, because torch's CPU layer-norm backward
#   sums their gradient over the 1,152 rows of the batch with bf16 partial
#   sums (measured at most 0.32 on ln_f.bias, whose gradient also cancels
#   over the batch);
# - params: AdamW moves an element by up to lr a step whatever its
#   gradient's size, so 5 steps x 2·lr, as for the f32 key bias above.
# A wrong factor or sign in a gradient gives a distance near 1 or above.
BF16_U = 2.0 ** -8


def test_five_bf16_train_steps_match_jax():
    optim = OPTIMS[1]
    jcfg, pcfg = _cfgs(compute_dtype="bfloat16", pool="mean", remat=True)
    model_def, jocfg, jstate = _jax_setup(jcfg, **optim)
    model, ocfg, state = _port_state(pcfg, _np(jstate.params), **optim)
    jtrain = jax_step.make_train_step(model_def, jcfg, jocfg)
    train = step_lib.make_train_step(model, ocfg)
    for i in range(5):
        images, labels = _images(8, seed=10 + i)
        jstate, jm = jtrain(jstate, images, labels)
        state, m = train(state, torch.from_numpy(images),
                         torch.from_numpy(labels.astype(np.int64)))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=BF16_U)
        assert float(m["accuracy"]) == float(jm["accuracy"])
    assert int(state.step) == int(jstate.step) == 5
    for key in ("mu", "nu"):
        want = convert.params_from_jax(_np(jstate.opt[key]))
        assert sorted(want) == sorted(state.opt[key])
        for name, t in state.opt[key].items():
            got, ref = t.numpy(), want[name].numpy()
            layer_norm = name.startswith(("ln_f.", "blocks.ln"))
            pin = (128 if layer_norm else 8) * BF16_U
            dist = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert dist <= pin, f"{key}.{name}: {dist:.3g} > {pin:.3g}"
    want = convert.params_from_jax(_np(jstate.params))
    for name, t in state.params.items():
        np.testing.assert_allclose(t.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=5 * 2 * ocfg.learning_rate,
                                   err_msg=f"params.{name}")


def _adamw_jax_state(steps=2):
    jcfg, _ = _cfgs()
    model_def, ocfg, state = _jax_setup(jcfg, optimizer="adamw",
                                        learning_rate=1e-3)
    train = jax_step.make_train_step(model_def, jcfg, ocfg)
    for i in range(steps):
        state, _ = train(state, *_images(4, seed=20 + i))
    return state


def test_jax_adamw_checkpoint_restores_into_port_and_resaves_same_bytes(
        tmp_path):
    jstate = _adamw_jax_state()
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpath = jax_ckpt.save_checkpoint(jdir, jstate, step=2)
    _, pcfg = _cfgs()
    model = ViT(pcfg, DataConfig(**CROP))
    state = step_lib.init_train_state(model, OptimConfig(optimizer="adamw"),
                                      CPU, torch.Generator().manual_seed(1))
    assert ckpt.restore_checkpoint(jdir, state) is state
    assert int(state.step) == 2
    for key, tree in (("params", jstate.params), ("mu", jstate.opt["mu"]),
                      ("nu", jstate.opt["nu"])):
        have = state.params if key == "params" else state.opt[key]
        for name, value in convert.params_from_jax(_np(tree)).items():
            assert torch.equal(have[name], value), (key, name)
    ppath = ckpt.save_checkpoint(pdir, state, step=2)
    with open(ppath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    with open(ppath + ".sha256") as a, open(jpath + ".sha256") as b:
        assert a.read() == b.read()


def test_port_adamw_checkpoint_restores_into_jax(tmp_path):
    _, pcfg = _cfgs(pool="mean")
    model = ViT(pcfg, DataConfig(**CROP))
    ocfg = OptimConfig(optimizer="adamw", learning_rate=1e-3)
    state = step_lib.init_train_state(model, ocfg, CPU,
                                      torch.Generator().manual_seed(2))
    train = step_lib.make_train_step(model, ocfg)
    for i in range(2):
        images, labels = _images(4, seed=30 + i)
        state, _ = train(state, torch.from_numpy(images),
                         torch.from_numpy(labels.astype(np.int64)))
    ckpt.save_checkpoint(str(tmp_path), state, step=2)
    jcfg, _ = _cfgs(pool="mean")
    _, _, target = _jax_setup(jcfg, optimizer="adamw", learning_rate=1e-3)
    restored = jax_ckpt.restore_checkpoint(str(tmp_path), target)
    assert int(restored.step) == 2
    assert sorted(restored.opt) == sorted(state.opt) == ["mu", "nu", "step"]
    for key, have in (("params", state.params), ("mu", state.opt["mu"]),
                      ("nu", state.opt["nu"])):
        tree = restored.params if key == "params" else restored.opt[key]
        got = convert.params_from_jax(_np(tree))
        for name, t in have.items():
            assert torch.equal(got[name], t.detach()), (key, name)
    assert os.path.isfile(tmp_path / "ckpt_2.msgpack")
