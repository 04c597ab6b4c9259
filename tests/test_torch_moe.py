"""PyTorch port, the MoE rung: ops/moe.py and ``vit_moe`` (models/vit.py,
parallel/step.py, convert.py, ckpt/checkpoint.py, cli/main.py) against the
JAX package on the CPU, one process.

The layer (dim 64, hidden 256, 4 experts, 2 x 10 tokens) against JAX
``moe_mlp``: both dispatch forms, top-1 and top-2, capacity factors 1.25
and 0.5 (where tokens drop). Every token's chosen experts and kept slots
equal JAX's (its routing recomputed in JAX arithmetic from the JAX
package's formulas), y and the gradients of ``sum(sin(y)) + aux_loss``
by x and every leaf within rtol 2e-5, atol 2e-6, ``dropped_frac`` and
``expert_load`` equal, ``aux_loss`` within rtol 1e-6.

``vit_moe`` (depth 2, dim 64, 2 heads, patch 8, 24 px: 10 tokens; 4
experts) against JAX ``apply_with_aux`` (f32, bf16, remat), five SGD and
five AdamW ``make_train_step`` steps (the router stats in the metrics),
``param_count``, msgpack bytes in both directions, the FLOP count of both
dispatch forms, the CLI's flags and guards.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dml_cnn_cifar10_tpu.ckpt import checkpoint as jax_ckpt
from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.config import ModelConfig as JaxModelConfig
from dml_cnn_cifar10_tpu.config import OptimConfig as JaxOptimConfig
from dml_cnn_cifar10_tpu.models import param_count as jax_param_count
from dml_cnn_cifar10_tpu.models import vit as jax_vit
from dml_cnn_cifar10_tpu.models.registry import get_model as jax_get_model
from dml_cnn_cifar10_tpu.ops import moe as jax_moe
from dml_cnn_cifar10_tpu.parallel import step as jax_step
from dml_cnn_cifar10_tpu_torch import ckpt, convert
from dml_cnn_cifar10_tpu_torch.cli.main import build_parser, config_from_args
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              OptimConfig, TrainConfig)
from dml_cnn_cifar10_tpu_torch.models.vit import ViT, param_count
from dml_cnn_cifar10_tpu_torch.ops import moe
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
from dml_cnn_cifar10_tpu_torch.utils import profiling

torch.set_num_threads(2)

CPU = torch.device("cpu")
PIN = dict(rtol=2e-5, atol=2e-6)
SMALL = dict(name="vit_moe", vit_dim=64, vit_depth=2, vit_heads=2,
             patch_size=8, moe_experts=4, logit_relu=False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# The layer.
# ---------------------------------------------------------------------------


def _jax_routing(x, gate, factor, top_k):
    """``[(expert, slot, kept)]`` a choice: the JAX package's routing
    (``ops/moe.py:100-146``) in JAX arithmetic."""
    t, e = x.shape[0] * x.shape[1], gate.shape[-1]
    cap = max(1, int(np.ceil(t / e * factor * top_k)))
    probs = jax.nn.softmax(jnp.asarray(x).reshape(t, -1) @ gate, axis=-1)
    masked, offset, out = probs, jnp.zeros((e,), jnp.int32), []
    for _ in range(top_k):
        idx = jnp.argmax(masked, axis=-1)
        oh = jax.nn.one_hot(idx, e, dtype=jnp.int32)
        pos = jnp.take_along_axis(jnp.cumsum(oh, 0) - 1 + offset[None],
                                  idx[:, None], 1)[:, 0]
        out.append((np.asarray(idx), np.asarray(pos), np.asarray(pos < cap)))
        offset = offset + oh.sum(0)
        masked = masked * (1.0 - oh)
    return out


LAYER_CASES = [(d, k, f) for d in ("einsum", "scatter") for k in (1, 2)
               for f in (1.25, 0.5)]


@pytest.mark.parametrize("dispatch,top_k,factor", LAYER_CASES,
                         ids=[f"{d}-top{k}-cf{f}" for d, k, f in LAYER_CASES])
def test_layer_matches_jax(dispatch, top_k, factor):
    params = _np(jax_moe.init_moe_params(jax.random.key(0), 64, 256, 4))
    for name in ("b1", "b2"):
        params[name] = np.asarray(0.1 * jax.random.normal(
            jax.random.key(2), params[name].shape), np.float32)
    x = np.asarray(jax.random.normal(jax.random.key(3), (2, 10, 64)),
                   np.float32)

    def jax_loss(x, p):
        y, st = jax_moe.moe_mlp(x, p, factor, top_k=top_k, dispatch=dispatch)
        return jnp.sum(jnp.sin(y)) + st["aux_loss"], (y, st)

    (_, (jy, jst)), (jgx, jgp) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), params)
    flat = convert.params_from_jax(params)
    leaves = {n: t.requires_grad_() for n, t in flat.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, st = moe.moe_mlp(tx, leaves, factor, top_k=top_k, dispatch=dispatch)
    grads = torch.autograd.grad(torch.sin(y).sum() + st["aux_loss"],
                                [tx, *leaves.values()])

    want = _jax_routing(x, params["gate"]["kernel"], factor, top_k)
    got = moe.assignments(torch.from_numpy(x), flat["gate.kernel"], factor,
                          top_k)
    for (je, jslot, jkeep), (pe, pslot, pkeep) in zip(want, got):
        np.testing.assert_array_equal(pe.numpy(), je)
        np.testing.assert_array_equal(pkeep.numpy(), jkeep)
        np.testing.assert_array_equal(pslot.numpy()[jkeep], jslot[jkeep])
    if factor < 1:
        assert float(st["dropped_frac"]) > 0
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **PIN)
    assert float(st["dropped_frac"]) == float(jst["dropped_frac"])
    np.testing.assert_array_equal(st["expert_load"].numpy(),
                                  np.asarray(jst["expert_load"]))
    np.testing.assert_allclose(float(st["aux_loss"]),
                               float(jst["aux_loss"]), rtol=1e-6)
    assert not st["dropped_frac"].requires_grad
    assert not st["expert_load"].requires_grad
    jflat = convert.params_from_jax(_np(jgp))
    _close(grads[0].numpy(), np.asarray(jgx), "x")
    for (name, _), g in zip(leaves.items(), grads[1:]):
        _close(g.numpy(), jflat[name].numpy(), name)


def _close(got, want, what):
    """Within :data:`PIN`, the absolute part on the leaf's scale: an
    element of a gradient is a float32 sum whose rounding follows its
    terms, not its value (the gate's gradient reaches 34 here, and one of
    its elements of 0.046 is 3.0e-6 apart, 1e-7 of that scale)."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=PIN["rtol"],
                               atol=PIN["atol"] * scale, err_msg=what)


def test_layer_errors_and_capacity():
    params = {n: torch.zeros(s) for n, s in
              moe.param_shapes(8, 16, 4).items()}
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match=r"top_k=5 must be in \[1, "
                                         r"num_experts=4\]"):
        moe.moe_mlp(x, params, 1.25, top_k=5)
    with pytest.raises(ValueError, match="dispatch must be 'einsum' or "
                                         "'scatter', got 'gather'"):
        moe.moe_mlp(x, params, 1.25, dispatch="gather")
    # max(1, ceil(T/E · f · k)), in the JAX package's float order.
    for t, e, f, k in ((80, 4, 1.25, 1), (80, 4, 0.5, 2), (3, 8, 0.25, 1),
                       (32896, 8, 1.25, 1)):
        assert moe.capacity(t, e, f, k) == max(1, int(np.ceil(t / e * f * k)))
    assert moe.capacity(32896, 8, 1.25, 1) == 5140


# ---------------------------------------------------------------------------
# vit_moe.
# ---------------------------------------------------------------------------


def _cfgs(**kw):
    kw = {**SMALL, **kw}
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0.5, 0.5, (n, 24, 24, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _jax_params(jcfg, seed=0):
    return _np(jax_vit.init_params(jax.random.key(seed), jcfg,
                                   JaxDataConfig()))


def _port_model(pcfg, params):
    model = ViT(pcfg, DataConfig())
    model.load_state_dict(convert.params_from_jax(params))
    return model


@pytest.mark.parametrize("kw", [dict(), dict(moe_dispatch="scatter"),
                                dict(moe_top_k=2, moe_capacity_factor=0.5),
                                dict(remat=True)],
                         ids=["einsum", "scatter", "top2_drops", "remat"])
def test_apply_with_aux_matches_jax(kw):
    jcfg, pcfg = _cfgs(**kw)
    params = _jax_params(jcfg, seed=1)
    images, _ = _images(8, seed=2)
    jlogits, jaux = jax_vit.apply_with_aux(params, images, jcfg)
    model = _port_model(pcfg, params)
    logits, aux = model(torch.from_numpy(images))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **PIN)
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=1e-6)
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    np.testing.assert_array_equal(aux["expert_load"].numpy(),
                                  np.asarray(jaux["expert_load"]))
    assert abs(float(aux["expert_load"].sum()) - 1.0) < 1e-6


BF16_U = 2.0 ** -8


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_bf16_layer_matches_jax(dispatch):
    """The layer on the same bf16 tokens and leaves: the router (f32 from
    the bf16 values) routes alike, y within 2^-8 of its scale."""
    params = jax.tree.map(lambda a: np.asarray(a, jnp.bfloat16), _np(
        jax_moe.init_moe_params(jax.random.key(4), 64, 256, 4)))
    x = np.asarray(jax.random.normal(jax.random.key(5), (2, 10, 64)),
                   jnp.bfloat16)
    jy, jst = jax_moe.moe_mlp(jnp.asarray(x), params, 0.5, top_k=2,
                              dispatch=dispatch)
    leaves = {n: torch.from_numpy(np.asarray(v, np.float32)).bfloat16()
              for n, v in convert.params_from_jax(
                  jax.tree.map(lambda a: a.astype(np.float32),
                               params)).items()}
    y, st = moe.moe_mlp(torch.from_numpy(x.astype(np.float32)).bfloat16(),
                        leaves, 0.5, top_k=2, dispatch=dispatch)
    assert y.dtype == torch.bfloat16
    # y passes three bf16 roundings (an expert's output, its product with
    # the weight, the pair's sum): 4 U of its scale (measured one bf16
    # ulp, 2 U, at its largest element).
    want = np.asarray(jy, np.float32)
    assert np.abs(y.float().numpy() - want).max() \
        <= 4 * BF16_U * np.abs(want).max()
    assert float(st["dropped_frac"]) == float(jst["dropped_frac"]) > 0
    np.testing.assert_array_equal(st["expert_load"].numpy(),
                                  np.asarray(jst["expert_load"]))
    np.testing.assert_allclose(float(st["aux_loss"]),
                               float(jst["aux_loss"]), rtol=1e-6)


def test_bf16_forward_matches_jax():
    """The whole model in bf16 (the router in f32 from the bf16-rounded
    gate). The two frameworks' bf16 LayerNorms round at different places
    (the dense ViT's bf16 logits here part by up to 1.1% of their scale),
    so a block's tokens reach the router a few bf16 ulps apart, and a
    token whose two best experts are that close picks another one: block
    0's token 41 (image 4) goes to expert 2 in the port and to 3 in the
    JAX package, whose router probabilities for the two are 3.76e-4 apart
    (ROADMAP.md Queue 3). Every image's logits are held within 8 U of
    their scale (U = 2^-8; the flipped image's are 2.7% apart, the
    others' at most 1.6%), the aux loss within U relative, and the
    dropped fraction within one assignment of the 2 x 80."""
    jcfg, pcfg = _cfgs(compute_dtype="bfloat16")
    params = _jax_params(jcfg, seed=3)
    images, _ = _images(8, seed=4)
    jlogits, jaux = jax_vit.apply_with_aux(params, images, jcfg)
    with torch.no_grad():
        logits, aux = _port_model(pcfg, params)(torch.from_numpy(images))
    assert logits.dtype == torch.float32
    want = np.asarray(jlogits)
    assert np.abs(logits.numpy() - want).max() \
        <= 8 * BF16_U * np.abs(want).max()
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=BF16_U)
    assert abs(float(aux["dropped_frac"]) - float(jaux["dropped_frac"])) \
        <= 1 / 80 + 1e-7


def test_remat_gives_the_same_grads_and_stats():
    _, pcfg = _cfgs()
    _, remat_cfg = _cfgs(remat=True)
    params = _jax_params(_cfgs()[0], seed=5)
    images = torch.from_numpy(_images(4, seed=6)[0])
    out = []
    for cfg in (pcfg, remat_cfg):
        model = _port_model(cfg, params)
        logits, aux = model(images)
        loss = torch.sin(logits).sum() + aux["aux_loss"]
        out.append((torch.autograd.grad(loss, list(model.parameters())),
                    aux))
    for a, b in zip(out[0][0], out[1][0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k in ("aux_loss", "dropped_frac", "expert_load"):
        assert torch.equal(out[0][1][k], out[1][1][k])


def _jax_setup(jcfg, **optim):
    ocfg = JaxOptimConfig(**optim)
    model_def = jax_get_model("vit_moe")
    state = jax_step.init_train_state(jax.random.key(0), model_def, jcfg,
                                      JaxDataConfig(), ocfg)
    return model_def, ocfg, state


def _port_state(pcfg, params, **optim):
    model = ViT(pcfg, DataConfig())
    ocfg = OptimConfig(**optim)
    state = step_lib.init_train_state(model, ocfg, CPU,
                                      torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, value in convert.params_from_jax(params).items():
            state.params[name].copy_(value)
    return model, ocfg, state


OPTIMS = [dict(learning_rate=0.05), dict(optimizer="adamw",
                                         learning_rate=1e-3,
                                         weight_decay=0.05)]


@pytest.mark.parametrize("optim", OPTIMS, ids=["sgd", "adamw"])
def test_five_train_steps_match_jax(optim):
    """Losses rtol 1e-5 with the router stats of every step; parameters
    at the dense ViT's pin (``test_torch_vit.py``: 1e-5), AdamW's
    flat-gradient elements (the key bias) as it holds them, to 5 x
    2·lr."""
    jcfg, pcfg = _cfgs(moe_capacity_factor=1.0)
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
        np.testing.assert_allclose(float(m["moe_aux_loss"]),
                                   float(jm["moe_aux_loss"]), rtol=1e-6)
        # A float32 ulp of 1: the JAX package's jitted step divides by
        # a count as a product with its reciprocal, where its op-by-op
        # layer (and the port) divide.
        np.testing.assert_allclose(float(m["moe_dropped_frac"]),
                                   float(jm["moe_dropped_frac"]),
                                   rtol=0, atol=2.0 ** -24)
        np.testing.assert_allclose(m["moe_expert_load"].numpy(),
                                   np.asarray(jm["moe_expert_load"]),
                                   rtol=0, atol=2.0 ** -24)
    want = convert.params_from_jax(_np(jstate.params))
    lr = ocfg.learning_rate
    for name, t in state.params.items():
        got, ref = t.detach().numpy(), want[name].numpy()
        if name == "blocks.qkv.bias" and ocfg.optimizer == "adamw":
            got, ref = (a.reshape(2, 2, 3, 32) for a in (got, ref))
            np.testing.assert_allclose(got[:, :, 1], ref[:, :, 1], rtol=0,
                                       atol=5 * 2 * lr)
            got, ref = got[:, :, 0::2], ref[:, :, 0::2]
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5,
                                   err_msg=name)


def test_param_count_and_checkpoints_interchange_with_jax(tmp_path):
    jcfg, pcfg = _cfgs()
    model_def, jocfg, jstate = _jax_setup(jcfg, learning_rate=0.05,
                                          momentum=0.9)
    jtrain = jax_step.make_train_step(model_def, jcfg, jocfg)
    jstate, _ = jtrain(jstate, *_images(8, seed=20))
    model = ViT(pcfg, DataConfig())
    assert param_count(model) == jax_param_count(jstate.params)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {
        n: tuple(t.shape) for n, t in
        convert.params_from_jax(_np(jstate.params)).items()}
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpath = jax_ckpt.save_checkpoint(jdir, jstate, step=1)
    ocfg = OptimConfig(learning_rate=0.05, momentum=0.9)
    state = step_lib.init_train_state(model, ocfg, CPU,
                                      torch.Generator().manual_seed(1))
    ckpt.restore_checkpoint(jdir, state)
    ppath = ckpt.save_checkpoint(pdir, state, step=1)
    with open(ppath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    # The port's own training, restored by the JAX package.
    train = step_lib.make_train_step(model, ocfg)
    images, labels = _images(8, seed=21)
    train(state, torch.from_numpy(images),
          torch.from_numpy(labels.astype(np.int64)))
    ckpt.save_checkpoint(pdir, state, step=2)
    restored = jax_ckpt.restore_checkpoint(pdir, jstate)
    assert int(restored.step) == 2
    for key, have in (("params", state.params),
                      ("momentum", state.opt["momentum"])):
        tree = restored.params if key == "params" else restored.opt[key]
        got = convert.params_from_jax(_np(tree))
        for name, t in have.items():
            assert torch.equal(got[name], t.detach()), (key, name)


def test_step_flops_count_the_dispatch():
    """On ``meta``: the einsum form counts its two [T, E, C] contractions
    (forward 2, backward 3: 10·E·T·C·D a block), the scatter form's
    indexed writes and reads count nothing but its experts run one spare
    slot more (12·D·H an expert a block: two products forward, four
    backward)."""
    flops = {}
    for dispatch in ("einsum", "scatter"):
        cfg = TrainConfig(batch_size=8)
        cfg.model = ModelConfig(**{**SMALL, "moe_dispatch": dispatch})
        flops[dispatch], label = profiling.step_flops(cfg)
        assert label == "exact"
    t, e, d, depth = 8 * 10, 4, 64, 2
    c = moe.capacity(t, e, 1.25, 1)
    assert flops["einsum"] - flops["scatter"] == depth * (
        10 * e * t * c * d - 12 * e * d * 4 * d)


def test_cli_flags_and_guards():
    def cfg(*argv):
        return config_from_args(build_parser().parse_args(list(argv)))

    c = cfg("--model", "vit_moe")
    assert (c.model.moe_experts, c.model.moe_top_k, c.model.moe_dispatch) \
        == (8, 1, "einsum")
    c = cfg("--model", "vit_moe", "--moe_experts", "4", "--moe_top_k", "2",
            "--moe_dispatch", "scatter")
    assert (c.model.moe_experts, c.model.moe_top_k, c.model.moe_dispatch) \
        == (4, 2, "scatter")
    with pytest.raises(SystemExit, match="--moe_experts requires --model "
                                         "vit_moe \\(got vit_tiny\\)"):
        cfg("--model", "vit_tiny", "--moe_experts", "4")
    with pytest.raises(SystemExit):
        cfg("--model", "vit_moe", "--moe_dispatch", "gather")
    with pytest.raises(ValueError, match="vit_moe needs moe_experts >= 2"):
        ViT(ModelConfig(name="vit_moe", moe_experts=1), DataConfig())
    with pytest.raises(ValueError, match="vit_tiny is the dense ViT"):
        ViT(ModelConfig(name="vit_tiny", moe_experts=4), DataConfig())


def test_export_artifact_serves_the_live_forward(tmp_path):
    """``--mode export``'s artifact of ``vit_moe`` (logits only, a
    symbolic batch: the capacity stays symbolic), saved and loaded, equals
    the live weights' serving forward at every batch size."""
    from dml_cnn_cifar10_tpu_torch import export as export_lib

    jcfg, pcfg = _cfgs(moe_dispatch="scatter")
    model = _port_model(pcfg, _jax_params(jcfg, seed=7))
    path = str(tmp_path / export_lib.ARTIFACT_NAME)
    export_lib.save_exported(path, export_lib.export_forward(model,
                                                             DataConfig()))
    served = export_lib.load_exported(path)
    live = export_lib.make_serving_fn(model, DataConfig())
    rng = np.random.default_rng(8)
    for b in (1, 3, 32):
        images = torch.from_numpy(rng.integers(0, 256, (b, 32, 32, 3),
                                               dtype=np.uint8))
        with torch.no_grad():
            got, want = served(images), live(images)
        assert got.shape == (b, 10)
        assert torch.equal(got, want), b


def test_unported_combinations_raise():
    """MoE with sequence parallelism, and ``grad_accum`` microbatches that
    would span data ranks, raise naming the queue that ports them; the
    microbatches a data rank runs when it holds JAX's whole."""
    from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh

    _, pcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        ViT(pcfg, DataConfig(), mesh=Mesh(world=2, seq=2))
    model = ViT(pcfg, DataConfig(), mesh=Mesh(world=2, data=2))
    assert step_lib.moe_microbatches(model, 1, model.moe_mesh) == (1, True)
    assert step_lib.moe_microbatches(model, 4, model.moe_mesh) == (2, False)
    with pytest.raises(NotImplementedError, match="open sharding items"):
        step_lib.moe_microbatches(model, 3, model.moe_mesh)
    dense = ViT(ModelConfig(**{**SMALL, "name": "vit_tiny",
                               "moe_experts": 0}), DataConfig())
    assert step_lib.moe_microbatches(dense, 3, Mesh(world=2, data=2)) == \
        (3, True)
