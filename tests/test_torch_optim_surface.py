"""PyTorch port, the rest of the optimizer surface against the JAX package
on the CPU: global-norm clipping, gradient accumulation, async-staleness
emulation, label smoothing, and the LARS, LAMB and Adafactor families
(``train/optim.py``, ``parallel/step.py``).

From the same params (carried over with ``convert.py``) on the same five
batches of the synthetic set (``normalize=scale``, batch 16), the two
frameworks' train steps must give the same per-step loss (rtol 1e-5) and
the same params and optimizer state after them (atol 1e-5) — the pins of
``tests/test_torch_step.py``. Checkpoints of these states interchange:
a JAX checkpoint restores into the port and re-saves byte for byte, and
a port checkpoint restores into JAX with every value equal.
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
from dml_cnn_cifar10_tpu.models.registry import get_model as jax_get_model
from dml_cnn_cifar10_tpu.parallel import step as jax_step
from dml_cnn_cifar10_tpu_torch import ckpt, convert
from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig, OptimConfig
from dml_cnn_cifar10_tpu_torch.data import pipeline
from dml_cnn_cifar10_tpu_torch.models.registry import get_model
from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
from dml_cnn_cifar10_tpu_torch.train import optim as optim_lib

torch.set_num_threads(2)

CPU = torch.device("cpu")
CNN = dict(name="cnn", logit_relu=False)
# A small ViT: 16x16 crop, patch 4 -> 17 tokens with the cls token.
VIT = dict(name="vit_tiny", logit_relu=False, vit_dim=32, vit_depth=2,
           vit_heads=2)
VIT_DATA = dict(image_height=20, image_width=20, crop_height=16,
                crop_width=16)


def _batches(tmp_path_factory, data_kw):
    cfg = DataConfig(dataset="synthetic", normalize="scale",
                     data_dir=str(tmp_path_factory.mktemp("synth")),
                     synthetic_train_records=200, synthetic_test_records=40,
                     **data_kw)
    it = pipeline.input_pipeline(cfg, 16, train=True, seed=0)
    return [next(it) for _ in range(5)]


@pytest.fixture(scope="module")
def cnn_batches(tmp_path_factory):
    return _batches(tmp_path_factory, {})


@pytest.fixture(scope="module")
def vit_batches(tmp_path_factory):
    return _batches(tmp_path_factory, VIT_DATA)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(model_kw, data_kw, optim):
    """JAX state and train step, and the port's from the same params."""
    mcfg = JaxModelConfig(**model_kw)
    jocfg = JaxOptimConfig(**optim)
    model_def = jax_get_model(mcfg.name)
    jstate = jax_step.init_train_state(jax.random.key(0), model_def, mcfg,
                                       JaxDataConfig(**data_kw), jocfg)
    model = get_model(model_kw["name"])(ModelConfig(**model_kw),
                                        DataConfig(**data_kw))
    ocfg = OptimConfig(**optim)
    state = step_lib.init_train_state(model, ocfg, CPU,
                                      torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, value in convert.params_from_jax(
                _np(jstate.params)).items():
            state.params[name].copy_(value)
    # The optimizer state (the staleness ring, the EMA) from those params.
    state.opt = optim_lib.sgd_init(state.params, ocfg, CPU)
    return (jax_step.make_train_step(model_def, mcfg, jocfg), jstate,
            step_lib.make_train_step(model, ocfg), state)


def _opt_trees(jstate, state):
    """``(key, port tensors, JAX values in the port's layout)`` for every
    tree of the optimizer state."""
    for key, value in state.opt.items():
        if isinstance(value, dict):
            want = convert.params_from_jax(
                _np(jstate.opt[key]),
                layout=convert.OPT_LAYOUTS.get(key, "port"))
            yield key, value, want


CASES = {
    "clip_momentum": (CNN, {}, dict(learning_rate=0.01, momentum=0.9,
                                    grad_clip_norm=0.5)),
    "grad_accum": (CNN, {}, dict(learning_rate=0.01, grad_accum=2)),
    "staleness2": (CNN, {}, dict(learning_rate=0.01, async_staleness=2)),
    "staleness3": (CNN, {}, dict(learning_rate=0.01, async_staleness=3,
                                 momentum=0.9)),
    "label_smoothing": (CNN, {}, dict(learning_rate=0.01,
                                      label_smoothing=0.1)),
    "lars": (CNN, {}, dict(learning_rate=0.5, optimizer="lars",
                           weight_decay=1e-4)),
    "lamb": (CNN, {}, dict(learning_rate=1e-3, optimizer="lamb",
                           weight_decay=1e-4)),
    # Adafactor at lr 1e-3: its factored normalization scales a leaf whose
    # true gradient is 0 (the key third of the ViT's qkv bias: softmax is
    # shift-invariant; a CNN channel the ReLU keeps dead) from round-off to
    # an O(1) update of lr·1e-3 in either framework, whose round-off
    # differs (ROADMAP.md Queue 3).
    "adafactor": (CNN, {}, dict(learning_rate=1e-3, optimizer="adafactor",
                                weight_decay=1e-4)),
    "adafactor_vit": (VIT, VIT_DATA, dict(learning_rate=1e-3,
                                          optimizer="adafactor",
                                          grad_clip_norm=1.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_five_train_steps_match_jax(request, case):
    model_kw, data_kw, optim = CASES[case]
    batches = request.getfixturevalue(
        "vit_batches" if model_kw is VIT else "cnn_batches")
    jtrain, jstate, train, state = _setup(model_kw, data_kw, optim)
    fused.reset_launches()
    for b in batches:
        jstate, jm = jtrain(jstate, b.images, b.labels)
        state, m = train(state, *pipeline.to_device(b, CPU))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert float(m["accuracy"]) == float(jm["accuracy"])
    assert int(state.step) == int(jstate.step) == 5
    # On the CPU the fused update runs its plain version: no launch.
    assert sum(fused.LAUNCHES.values()) == 0
    want = convert.params_from_jax(_np(jstate.params))
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    keys = set()
    for key, have, want in _opt_trees(jstate, state):
        keys.add(key)
        assert sorted(have) == sorted(want), key
        for name, t in have.items():
            assert t.shape == want[name].shape, (key, name)
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{key}.{name}")
    assert keys == {k for k in jstate.opt if k != "step"}


def test_grad_accum_launches_the_update_once_a_step():
    """Two microbatches, one update: the fused update (K1 on the card) is
    called once a step, counted by a recording stand-in."""
    calls = []
    model = get_model("cnn")(ModelConfig(**CNN), DataConfig())
    ocfg = OptimConfig(learning_rate=0.01, grad_accum=2)
    state = step_lib.init_train_state(model, ocfg, CPU,
                                      torch.Generator().manual_seed(0))
    train = step_lib.make_train_step(model, ocfg)
    real = fused.fused_sgd_update
    try:
        fused.fused_sgd_update = lambda *a, **k: (calls.append(1),
                                                  real(*a, **k))[1]
        x = torch.rand(8, 24, 24, 3)
        y = torch.randint(0, 10, (8,))
        for _ in range(3):
            train(state, x, y)
    finally:
        fused.fused_sgd_update = real
    assert len(calls) == 3
    with pytest.raises(ValueError, match="not divisible by grad_accum"):
        train(state, x[:7], y[:7])


def test_staleness_rejects_coupled_weight_decay():
    model = get_model("cnn")(ModelConfig(**CNN), DataConfig())
    params = dict(model.named_parameters())
    for opt in ("sgd", "lars"):
        with pytest.raises(ValueError, match="async semantics"):
            optim_lib.sgd_init(params, OptimConfig(
                optimizer=opt, async_staleness=2, weight_decay=1e-4))
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim_lib.sgd_init(params, OptimConfig(optimizer="adagrad"))


STATES = {
    "staleness": (CNN, {}, dict(learning_rate=0.01, async_staleness=2,
                                momentum=0.9)),
    "lars": CASES["lars"],
    "lamb": CASES["lamb"],
    "adafactor": CASES["adafactor"],
    "adafactor_vit": CASES["adafactor_vit"],
}


@pytest.mark.parametrize("case", list(STATES))
def test_checkpoints_interchange_byte_for_byte(tmp_path, request, case):
    model_kw, data_kw, optim = STATES[case]
    b = request.getfixturevalue(
        "vit_batches" if model_kw is VIT else "cnn_batches")[0]
    jtrain, jstate, train, state = _setup(model_kw, data_kw, optim)
    jstate, _ = jtrain(jstate, b.images, b.labels)
    # JAX -> port -> file: the same bytes.
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpath = jax_ckpt.save_checkpoint(jdir, jstate, step=1)
    ckpt.restore_checkpoint(jdir, state)
    ppath = ckpt.save_checkpoint(pdir, state, step=1)
    with open(ppath, "rb") as x, open(jpath, "rb") as y:
        assert x.read() == y.read()
    # port (one step of its own) -> JAX: every value equal.
    state, _ = train(state, *pipeline.to_device(b, CPU))
    ckpt.save_checkpoint(pdir, state, step=2)
    restored = jax_ckpt.restore_checkpoint(pdir, jstate)
    assert int(restored.step) == 2
    got = convert.params_from_jax(_np(restored.params))
    for name, p in state.params.items():
        assert torch.equal(got[name], p.detach()), name
    for key, have, want in _opt_trees(restored, state):
        for name, t in have.items():
            assert torch.equal(want[name], t), (key, name)
