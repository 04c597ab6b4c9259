"""PyTorch port, the ResNet-18 training path: ``parallel/step.py`` with the
BatchNorm ``model_state``, ``train/optim.py`` (the K2 path through its
plain version on the CPU), ``ckpt/`` and ``train/loop.py``, against the
JAX package on the CPU.

- Five train steps from the same params and running stats (JAX's init,
  carried over by ``convert.py``) on the same five synthetic batches
  (32 px stored, 24 px crop, batch 8, ``normalize=scale``, lr 0.02 as
  the port's other CPU training tests): SGD with momentum 0.9 and weight
  decay 5e-4, and the same with ``grad_accum 2`` and an EMA
  (``ema_mstate``). Pins: the per-step loss within rtol 2e-5 (measured
  at most 1.0e-6); params, ``model_state``, ``ema`` and ``ema_mstate``
  within ``max|Δ| / max(1, max|jax|)`` 1e-4 (measured at most 1.5e-5);
  the momentum, which holds the last gradients undamped, within a
  relative norm ``‖Δ‖₂ / ‖jax‖₂`` of 2e-3 over the tree (measured 2.2e-4
  with accumulation: a ReLU whose input lies within rounding of 0 takes
  a different side in the two frameworks and moves one leaf's gradient
  by up to 1.5e-3, ``test_torch_resnet.py``; ROADMAP.md Queue 3).
- The JAX package's checkpoint of the stepped state restores into the
  port and the port writes it back byte for byte (``model_state``'s
  ``None`` leaves and list stages included, ``ema_mstate`` too); the
  port's restores into JAX.
- ``on_nonfinite skip`` through the Trainer against the JAX Trainer: the
  skip puts the BN running stats back with the params.
- Exact resume: 2 + 2 steps through a msgpack or a ``.sharded``
  checkpoint equal 4 steps bit for bit, running stats included.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu.ckpt import checkpoint as jax_ckpt
from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.config import ModelConfig as JaxModelConfig
from dml_cnn_cifar10_tpu.config import OptimConfig as JaxOptimConfig
from dml_cnn_cifar10_tpu.config import TrainConfig as JaxTrainConfig
from dml_cnn_cifar10_tpu.models.registry import get_model as jax_get_model
from dml_cnn_cifar10_tpu.parallel import step as jax_step
from dml_cnn_cifar10_tpu.train.loop import Trainer as JaxTrainer
from dml_cnn_cifar10_tpu_torch import ckpt, convert
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              OptimConfig, TrainConfig)
from dml_cnn_cifar10_tpu_torch.data import pipeline
from dml_cnn_cifar10_tpu_torch.models.resnet import ResNet
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
from dml_cnn_cifar10_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

CPU = torch.device("cpu")
LOSS_RTOL, STATE_ATOL, MOMENTUM_RTOL = 2e-5, 1e-4, 2e-3
DATA = dict(dataset="synthetic", normalize="scale",
            synthetic_train_records=96, synthetic_test_records=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("synth"))


@pytest.fixture(scope="module")
def batches(data_dir):
    cfg = DataConfig(data_dir=data_dir, **DATA)
    it = pipeline.input_pipeline(cfg, 8, train=True, seed=0)
    return [next(it) for _ in range(5)]


def _jax_setup(**optim):
    mcfg = JaxModelConfig(name="resnet18", logit_relu=False)
    ocfg = JaxOptimConfig(**optim)
    model_def = jax_get_model("resnet18")
    state = jax_step.init_train_state(jax.random.key(0), model_def, mcfg,
                                      JaxDataConfig(), ocfg)
    return model_def, mcfg, ocfg, state


def _port_state(jstate, **optim):
    """The port's ResNet-18 state holding ``jstate``'s values."""
    model = ResNet(ModelConfig(name="resnet18", logit_relu=False),
                   DataConfig())
    ocfg = OptimConfig(**optim)
    state = step_lib.init_train_state(model, ocfg, CPU,
                                      torch.Generator().manual_seed(0))
    pairs = [(state.params, jstate.params),
             (state.model_state, jstate.model_state)]
    pairs += [(state.opt[k], jstate.opt[k]) for k in
              ("momentum", "ema", "ema_mstate") if k in state.opt]
    with torch.no_grad():
        for dst, tree in pairs:
            src = convert.params_from_jax(_np(tree))
            assert set(src) == set(dst)
            for name, value in src.items():
                dst[name].copy_(value)
    return model, ocfg, state


def _close(got, tree, what):
    """``max|Δ| / max(1, max|jax|)`` of each leaf at most STATE_ATOL; the
    momentum by its relative norm over the tree."""
    want = convert.params_from_jax(_np(tree))
    assert set(got) == set(want), what
    if what == "momentum":
        num = sum(float(((t.detach().double() - want[n].double()) ** 2)
                        .sum()) for n, t in got.items())
        den = sum(float((w.double() ** 2).sum()) for w in want.values())
        assert (num / den) ** 0.5 <= MOMENTUM_RTOL, what
        return
    for name, t in got.items():
        w = want[name].numpy()
        err = np.abs(t.detach().numpy() - w).max() / max(1.0,
                                                          np.abs(w).max())
        assert err <= STATE_ATOL, f"{what}.{name}: {err:.3g}"


CASES = {
    "momentum_wd": dict(learning_rate=0.02, momentum=0.9,
                        weight_decay=5e-4),
    "accum2_ema": dict(learning_rate=0.02, momentum=0.9, weight_decay=5e-4,
                       grad_accum=2, ema_decay=0.9),
}


@pytest.mark.parametrize("case", list(CASES))
def test_five_steps_match_jax_and_checkpoints_interchange(
        batches, tmp_path, case):
    optim = CASES[case]
    model_def, mcfg, jocfg, jstate = _jax_setup(**optim)
    model, ocfg, state = _port_state(jstate, **optim)
    assert ("ema_mstate" in state.opt) == ("ema_mstate" in jstate.opt)
    jtrain = jax_step.make_train_step(model_def, mcfg, jocfg)
    train = step_lib.make_train_step(model, ocfg)
    for b in batches:
        jstate, jm = jtrain(jstate, b.images, b.labels)
        state, m = train(state, *pipeline.to_device(b, CPU))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    assert int(state.step) == int(jstate.step) == 5
    _close(state.params, jstate.params, "params")
    _close(state.model_state, jstate.model_state, "model_state")
    for key in ("momentum", "ema", "ema_mstate"):
        if key in jstate.opt:
            _close(state.opt[key], jstate.opt[key], key)
    # Eval reads the running stats (ema_mstate beside the EMA).
    jeval = jax_step.make_eval_step(model_def, mcfg)
    got = step_lib.make_eval_step(model)(state, *pipeline.to_device(
        batches[0], CPU))
    ref = jeval(jstate, batches[0].images, batches[0].labels)
    assert abs(int(got["correct"]) - int(ref["correct"])) <= 1

    # JAX's checkpoint -> the port -> the same bytes.
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpath = jax_ckpt.save_checkpoint(jdir, jstate, step=5)
    _, _, fresh = _port_state(_jax_setup(**optim)[3], **optim)
    ckpt.restore_checkpoint(jdir, fresh)
    assert int(fresh.step) == 5
    for name, t in fresh.model_state.items():
        assert torch.equal(t, convert.params_from_jax(
            _np(jstate.model_state))[name]), name
    ppath = ckpt.save_checkpoint(pdir, fresh, step=5)
    with open(ppath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    # The port's stepped state -> JAX.
    ckpt.save_checkpoint(str(tmp_path / "port2"), state, step=5)
    restored = jax_ckpt.restore_checkpoint(str(tmp_path / "port2"),
                                           _jax_setup(**optim)[3])
    got = convert.params_from_jax(_np(restored.model_state))
    for name, t in state.model_state.items():
        assert torch.equal(got[name], t), name


def _configs(data_dir, tmp, **kw):
    """The port's and JAX's TrainConfig of one ResNet-18 run."""
    out = []
    for name, cfg in (("port", TrainConfig(data=DataConfig(**DATA))),
                      ("jax", JaxTrainConfig(data=JaxDataConfig(
                          use_native_loader=False, **DATA)))):
        cfg.data.data_dir = data_dir
        cfg.batch_size, cfg.total_steps = 8, 8
        cfg.output_every, cfg.eval_every, cfg.checkpoint_every = 2, 8, 4
        cfg.log_dir = os.path.join(tmp, name)
        cfg.model.name = "resnet18"
        cfg.model.logit_relu = False
        cfg.optim.learning_rate = 0.02
        cfg.optim.momentum = 0.9
        if name == "port":
            cfg.device = "cpu"
        for key, value in kw.items():
            setattr(cfg, key, value)
        out.append(cfg)
    return out


def _same_start(cfgs):
    """Every run's log dir holds the same step-0 checkpoint (the port's
    init), so the port's and JAX's Trainers start from the same state."""
    cfg = cfgs[0]
    model = ResNet(cfg.model, cfg.data)
    state = step_lib.init_train_state(model, cfg.optim, CPU,
                                      torch.Generator().manual_seed(5))
    for c in cfgs:
        ckpt.save_checkpoint(c.log_dir, state, 0)


def _fit(cfg, total_steps=None):
    trainer = Trainer(cfg)
    try:
        return trainer.fit(total_steps)
    finally:
        trainer.close()


def test_skip_guard_restores_running_stats_like_jax(data_dir, tmp_path):
    cfg, jcfg = _configs(data_dir, str(tmp_path), check_numerics=True,
                         on_nonfinite="skip", fault_spec="nan@3")
    _same_start([cfg, jcfg])
    jres = JaxTrainer(jcfg).fit()
    res = _fit(cfg)
    assert res.final_step == jres.final_step == 8
    for name, t in res.state.model_state.items():
        assert torch.isfinite(t).all(), name
    _close(res.state.params, jres.state.params, "params")
    _close(res.state.model_state, jres.state.model_state, "model_state")


@pytest.mark.parametrize("fmt", ["msgpack", "sharded"])
def test_exact_resume_with_running_stats(data_dir, tmp_path, fmt):
    whole = _configs(data_dir, str(tmp_path / "whole"), ckpt_format=fmt,
                     total_steps=4, checkpoint_every=2, eval_every=4)[0]
    split = dataclasses.replace(whole, log_dir=str(tmp_path / "split"))
    want = _fit(whole).state
    assert int(_fit(split, 2).state.step) == 2
    got = _fit(split).state
    assert int(got.step) == 4
    for a, b in zip(step_lib._state_tensors(got),
                    step_lib._state_tensors(want)):
        assert torch.equal(a, b)
    assert set(got.model_state) == set(want.model_state) and got.model_state
