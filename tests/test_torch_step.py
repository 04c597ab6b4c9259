"""PyTorch port, the slice as a whole: parallel/step.py + train/optim.py +
ckpt/checkpoint.py against the JAX package on the CPU.

From the same params (carried over with ``convert.py``) on the same five
batches of the synthetic set (``normalize=scale``, batch 16, lr 0.01), the
two frameworks' train steps must give the same per-step loss (rtol 1e-5)
and the same final params (atol 1e-5: f32 convolutions and products sum
in different orders, and five SGD steps carry the difference along).
Checkpoints interchange both ways, and a restored JAX checkpoint re-saved
by the port is the same file, byte for byte.
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
from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    cfg = DataConfig(dataset="synthetic", normalize="scale",
                     data_dir=str(tmp_path_factory.mktemp("synth")),
                     synthetic_train_records=200, synthetic_test_records=40)
    it = pipeline.input_pipeline(cfg, 16, train=True, seed=0)
    return [next(it) for _ in range(5)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_setup(logit_relu, **optim):
    mcfg = JaxModelConfig(logit_relu=logit_relu)
    ocfg = JaxOptimConfig(**optim)
    model_def = jax_get_model("cnn")
    state = jax_step.init_train_state(jax.random.key(0), model_def, mcfg,
                                      JaxDataConfig(), ocfg)
    return model_def, mcfg, ocfg, state


def _port_state(params_np, logit_relu, **optim):
    """The port's state holding ``params_np`` (a JAX-layout tree)."""
    model = CNN(ModelConfig(logit_relu=logit_relu), DataConfig())
    ocfg = OptimConfig(**optim)
    state = step_lib.init_train_state(model, ocfg, CPU,
                                      torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, value in convert.params_from_jax(params_np).items():
            state.params[name].copy_(value)
        if "ema" in state.opt:
            for name, value in state.params.items():
                state.opt["ema"][name].copy_(value)
    return model, ocfg, state


CASES = [
    dict(logit_relu=False, learning_rate=0.01, dead_lr_decay=False,
         decay_every=2),
    dict(logit_relu=True, learning_rate=0.01),
    dict(logit_relu=False, learning_rate=0.01, momentum=0.9,
         weight_decay=5e-4, ema_decay=0.9),
    dict(logit_relu=False, learning_rate=0.01, momentum=0.9,
         fused_optimizer=False),
]


@pytest.mark.parametrize("case", CASES, ids=["fixed", "faithful",
                                             "momentum_wd_ema", "unfused"])
def test_five_train_steps_match_jax(batches, case):
    case = dict(case)
    logit_relu = case.pop("logit_relu")
    model_def, mcfg, jocfg, jstate = _jax_setup(logit_relu, **case)
    params0 = _np_tree(jstate.params)
    model, ocfg, state = _port_state(params0, logit_relu, **case)
    jtrain = jax_step.make_train_step(model_def, mcfg, jocfg)
    train = step_lib.make_train_step(model, ocfg)
    for b in batches:
        jstate, jm = jtrain(jstate, b.images, b.labels)
        images, labels = pipeline.to_device(b, CPU)
        state, m = train(state, images, labels)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert float(m["accuracy"]) == float(jm["accuracy"])
    assert int(state.step) == int(jstate.step) == 5
    want = convert.params_from_jax(_np_tree(jstate.params))
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    for key in ("momentum", "ema"):
        if key in jstate.opt:
            want = convert.params_from_jax(_np_tree(jstate.opt[key]))
            for name, t in state.opt[key].items():
                np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                           rtol=0, atol=1e-5)
    if not logit_relu:
        jeval = jax_step.make_eval_step(model_def, mcfg)
        ev = step_lib.make_eval_step(model)
        b = batches[0]
        got = ev(state, *pipeline.to_device(b, CPU))
        ref = jeval(jstate, b.images, b.labels)
        assert int(got["correct"]) == int(ref["correct"])
        assert float(got["accuracy"]) == float(ref["accuracy"])


def _stepped_jax_state(batches, **optim):
    model_def, mcfg, ocfg, state = _jax_setup(False, learning_rate=0.01,
                                              **optim)
    train = jax_step.make_train_step(model_def, mcfg, ocfg)
    state, _ = train(state, batches[0].images, batches[0].labels)
    return state


OPT_STATES = [dict(), dict(momentum=0.9), dict(momentum=0.9, ema_decay=0.99)]


@pytest.mark.parametrize("optim", OPT_STATES, ids=["sgd", "momentum", "ema"])
def test_jax_checkpoint_restores_into_port_and_resaves_same_bytes(
        tmp_path, batches, optim):
    jstate = _stepped_jax_state(batches, **optim)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpath = jax_ckpt.save_checkpoint(jdir, jstate, step=1)
    model = CNN(ModelConfig(logit_relu=False), DataConfig())
    state = step_lib.init_train_state(model, OptimConfig(**optim), CPU,
                                      torch.Generator().manual_seed(1))
    restored = ckpt.restore_checkpoint(jdir, state)
    assert restored is state and int(state.step) == 1
    for key, tree in (("params", jstate.params),
                      *((k, jstate.opt[k]) for k in ("momentum", "ema")
                        if k in jstate.opt)):
        have = state.params if key == "params" else state.opt[key]
        for name, value in convert.params_from_jax(_np_tree(tree)).items():
            assert torch.equal(have[name], value), (key, name)
    ppath = ckpt.save_checkpoint(pdir, state, step=1)
    assert os.path.basename(ppath) == os.path.basename(jpath)
    with open(ppath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    with open(ppath + ".sha256") as a, open(jpath + ".sha256") as b:
        assert a.read() == b.read()
    with open(os.path.join(pdir, "checkpoint")) as f:
        assert f.read() == "ckpt_1.msgpack\n"


@pytest.mark.parametrize("optim", OPT_STATES, ids=["sgd", "momentum", "ema"])
def test_port_checkpoint_restores_into_jax(tmp_path, batches, optim):
    model = CNN(ModelConfig(logit_relu=False), DataConfig())
    ocfg = OptimConfig(learning_rate=0.01, **optim)
    state = step_lib.init_train_state(model, ocfg, CPU,
                                      torch.Generator().manual_seed(2))
    train = step_lib.make_train_step(model, ocfg)
    for b in batches[:2]:
        state, _ = train(state, *pipeline.to_device(b, CPU))
    ckpt.save_checkpoint(str(tmp_path), state, step=2)
    _, _, _, target = _jax_setup(False, learning_rate=0.01, **optim)
    restored = jax_ckpt.restore_checkpoint(str(tmp_path), target)
    assert int(restored.step) == 2
    got = convert.params_from_jax(_np_tree(restored.params))
    for name, p in state.params.items():
        assert torch.equal(got[name], p.detach()), name
    for key in ("momentum", "ema"):
        assert (key in restored.opt) == (key in state.opt)
        if key in state.opt:
            got = convert.params_from_jax(_np_tree(restored.opt[key]))
            for name, t in state.opt[key].items():
                assert torch.equal(got[name], t), (key, name)


def test_manager_cadence_retention_and_fallback(tmp_path):
    model = CNN(ModelConfig(), DataConfig())
    state = step_lib.init_train_state(model, OptimConfig(), CPU,
                                      torch.Generator().manual_seed(3))
    d = str(tmp_path)
    mgr = ckpt.CheckpointManager(d, every_steps=2, keep=2)
    saved = [s for s in range(1, 7) if mgr.maybe_save(state, s)]
    assert saved == [2, 4, 6]
    assert not mgr.maybe_save(state, 6, force=True)   # never twice a step
    assert sorted(f for f in os.listdir(d) if f.endswith(".msgpack")) == \
        ["ckpt_4.msgpack", "ckpt_6.msgpack"]
    assert ckpt.latest_checkpoint(d) == os.path.join(d, "ckpt_6.msgpack")
    # A corrupted newest checkpoint fails its sidecar: restore falls back.
    state.opt["step"].fill_(4)
    ckpt.save_checkpoint(d, state, step=4, keep=2)
    with open(os.path.join(d, "ckpt_6.msgpack"), "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02")
    fresh = step_lib.init_train_state(CNN(ModelConfig(), DataConfig()),
                                      OptimConfig(), CPU,
                                      torch.Generator().manual_seed(4))
    ckpt.restore_checkpoint(d, fresh)
    assert int(fresh.step) == 4
    for name, p in state.params.items():
        assert torch.equal(fresh.params[name], p), name
