"""PyTorch port, the numerics guard of ``train/loop.py`` (``check_numerics``
with ``on_nonfinite`` halt | skip | rollback) and the step-seam faults of
``utils/faults.py``, against the JAX package's ``Trainer`` on the CPU.

Both trainers start from the same weights (a step-0 checkpoint written by
the port, which either package restores) and read the same host batches,
with ``--fault_spec nan@N``:

- ``skip``: the same ``fault`` and ``recovery`` records, the run reaches
  its last step, and the final parameters agree within atol 1e-5 (the
  pin of ``tests/test_torch_step.py``); every checkpoint on disk restores
  to finite parameters.
- ``halt`` and ``rollback`` raise ``FloatingPointError`` at the same step
  with the same records and the same checkpoints on disk (a due save that
  would have written the poisoned state is refused).
- An exhausted skip budget halts.
- On the chunked path the skip restores INTO the state's tensors: every
  tensor keeps its ``data_ptr`` (a chunk's CUDA graph is bound to them).
- The spec grammar: the JAX parser's order and errors for every kind of
  the JAX package's ``FAULT_KINDS`` (the cluster, replica and network
  kinds and the phase triggers among them).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu.ckpt import checkpoint as jax_ckpt
from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.config import TrainConfig as JaxTrainConfig
from dml_cnn_cifar10_tpu.train.loop import Trainer as JaxTrainer
from dml_cnn_cifar10_tpu.utils import faults as jax_faults
from dml_cnn_cifar10_tpu_torch import convert
from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              OptimConfig, TrainConfig)
from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
from dml_cnn_cifar10_tpu_torch.train.loop import Trainer
from dml_cnn_cifar10_tpu_torch.utils import faults

torch.set_num_threads(2)

DATA = dict(dataset="synthetic", synthetic_train_records=96,
            synthetic_test_records=20, normalize="scale")
GUARD_KINDS = ("fault", "recovery", "numerics_halt")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("synth"))


def _configs(data_dir, tmp, **kw):
    """The port's and JAX's TrainConfig of one run; each log dir holds
    the same step-0 checkpoint."""
    out = []
    for name, cfg in (("port", TrainConfig(data=DataConfig(**DATA))),
                      ("jax", JaxTrainConfig(data=JaxDataConfig(
                          use_native_loader=False, **DATA)))):
        cfg.data.data_dir = data_dir
        cfg.batch_size, cfg.total_steps = 16, 12
        cfg.output_every, cfg.eval_every, cfg.checkpoint_every = 4, 12, 4
        cfg.keep_checkpoints = 10
        cfg.log_dir = os.path.join(tmp, name)
        cfg.metrics_jsonl = os.path.join(tmp, name, "m.jsonl")
        cfg.optim.learning_rate = 0.02
        cfg.model.logit_relu = False
        cfg.check_numerics = True
        if name == "port":
            cfg.device = "cpu"
        for key, value in kw.items():
            setattr(cfg, key, value)
        out.append(cfg)
    model = CNN(ModelConfig(logit_relu=False), DataConfig())
    state = step_lib.init_train_state(model, OptimConfig(),
                                      torch.device("cpu"),
                                      torch.Generator().manual_seed(5))
    for cfg in out:
        ckpt_lib.save_checkpoint(cfg.log_dir, state, 0)
    return out


def _guard_records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k != "t"} for r in recs
            if r["kind"] in GUARD_KINDS]


def _ckpt_steps(log_dir):
    return sorted(int(n[5:-8]) for n in os.listdir(log_dir)
                  if n.startswith("ckpt_") and n.endswith(".msgpack"))


def test_skip_matches_jax(data_dir, tmp_path):
    cfg, jcfg = _configs(data_dir, str(tmp_path), on_nonfinite="skip",
                         fault_spec="nan@6")
    jres = JaxTrainer(jcfg).fit()
    trainer = Trainer(cfg)
    try:
        res = trainer.fit()
    finally:
        trainer.close()
    assert res.final_step == jres.final_step == 12
    recs = _guard_records(cfg.metrics_jsonl)
    assert recs == _guard_records(jcfg.metrics_jsonl)
    assert [(r["kind"], r["step"]) for r in recs] == [
        ("fault", 6), ("fault", 8), ("recovery", 8)]
    want = convert.params_from_jax(jax.tree.map(np.asarray,
                                                jres.state.params))
    for name, p in res.state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    assert _ckpt_steps(cfg.log_dir) == _ckpt_steps(jcfg.log_dir) \
        == [0, 4, 8, 12]
    for step in _ckpt_steps(cfg.log_dir):
        with open(os.path.join(cfg.log_dir, f"ckpt_{step}.msgpack"),
                  "rb") as f:
            tree = ckpt_lib.from_bytes(f.read())
        assert all(np.isfinite(v.numpy()).all() for v in
                   convert.params_from_jax(tree["params"]).values()), step


@pytest.mark.parametrize("policy", ["halt", "rollback"])
def test_halt_and_rollback_match_jax(data_dir, tmp_path, policy):
    # The step-6 save is due between metrics boundaries while the state
    # is poisoned: the guard reads the loss and refuses it.
    cfg, jcfg = _configs(data_dir, str(tmp_path), on_nonfinite=policy,
                         fault_spec="nan@5", checkpoint_every=2)
    with pytest.raises(FloatingPointError, match="step 6") as jerr:
        JaxTrainer(jcfg).fit()
    trainer = Trainer(cfg)
    try:
        with pytest.raises(FloatingPointError, match="step 6") as err:
            trainer.fit()
    finally:
        trainer.close()
    assert str(err.value) == str(jerr.value)
    recs = _guard_records(cfg.metrics_jsonl)
    assert recs == _guard_records(jcfg.metrics_jsonl)
    assert recs[-1]["kind"] == ("numerics_halt" if policy == "halt"
                                else "fault")
    assert _ckpt_steps(cfg.log_dir) == _ckpt_steps(jcfg.log_dir) \
        == [0, 2, 4]
    for step in (2, 4):
        ok, _ = jax_ckpt.verify_checkpoint(
            os.path.join(cfg.log_dir, f"ckpt_{step}.msgpack"))
        assert ok


def test_exhausted_skip_budget_halts(data_dir, tmp_path):
    cfg, _ = _configs(data_dir, str(tmp_path), on_nonfinite="skip",
                      recovery_retries=1, fault_spec="nan@2,nan@6")
    trainer = Trainer(cfg)
    try:
        with pytest.raises(FloatingPointError, match="step 8"):
            trainer.fit()
    finally:
        trainer.close()
    kinds = [r["kind"] for r in _guard_records(cfg.metrics_jsonl)]
    assert kinds == ["fault", "fault", "recovery", "fault",
                     "numerics_halt"]


def test_chunked_skip_restores_in_place(data_dir, tmp_path):
    cfg, _ = _configs(data_dir, str(tmp_path), on_nonfinite="skip",
                      fault_spec="nan@5", steps_per_dispatch=2,
                      optim=OptimConfig(learning_rate=0.02, momentum=0.9))
    cfg.model.logit_relu = False
    for name in os.listdir(cfg.log_dir):      # other optimizer state
        os.remove(os.path.join(cfg.log_dir, name))
    trainer = Trainer(cfg)
    try:
        state = trainer.init_or_restore()
        ptrs = [t.data_ptr() for t in step_lib._state_tensors(state)]
        res = trainer.fit(state=state)
    finally:
        trainer.close()
    assert res.final_step == 12 and res.state is state
    assert [t.data_ptr() for t in step_lib._state_tensors(state)] == ptrs
    assert all(bool(torch.isfinite(t).all())
               for t in step_lib._state_tensors(state))
    assert [(r["kind"], r["step"]) for r in
            _guard_records(cfg.metrics_jsonl)] == [
        ("fault", 6), ("fault", 8), ("recovery", 8)]


def test_fault_spec_grammar_matches_jax():
    spec = "sigterm@30, nan@12,data_stall@12,ckpt_corrupt@20"
    got = faults.parse_fault_spec(spec)
    want = jax_faults.parse_fault_spec(spec)
    assert [(e.kind, e.step) for e in got] == [(e.kind, e.step)
                                               for e in want]
    assert faults.format_fault_spec(got) == jax_faults.format_fault_spec(
        want)
    for bad in ("bogus@10", "nan@x", "nan120", "nan@-3"):
        with pytest.raises(ValueError):
            jax_faults.parse_fault_spec(bad)
        with pytest.raises(ValueError):
            faults.parse_fault_spec(bad)
    assert faults.FAULT_KINDS == jax_faults.FAULT_KINDS
    for ported in ("host_lost@5", "ckpt_corrupt@restore", "net_drop@3",
                   "replica_corrupt@5") + tuple(
                       f"{kind}@7" for kind in jax_faults.FAULT_KINDS):
        got = faults.parse_fault_spec(ported)
        want = jax_faults.parse_fault_spec(ported)
        assert [(e.kind, e.step, e.phase) for e in got] == [
            (e.kind, e.step, e.phase) for e in want]
        assert faults.format_fault_spec(got) == \
            jax_faults.format_fault_spec(want)
    inj = faults.FaultInjector.from_spec("nan@3,data_stall@4")
    model = CNN(ModelConfig(), DataConfig())
    state = step_lib.init_train_state(model, OptimConfig(),
                                      torch.device("cpu"),
                                      torch.Generator().manual_seed(0))
    first = next(iter(state.params.values()))
    ptr = first.data_ptr()
    assert inj.step_hook(2, state, "/nonexistent") is state
    assert bool(torch.isfinite(first).all())
    inj.step_hook(3, state, "/nonexistent")
    assert first.data_ptr() == ptr and bool(torch.isnan(first).all())
    with pytest.raises(faults.DataStallError):
        inj.step_hook(4, state, "/nonexistent")
    assert inj.pending() == []
