"""PyTorch port, preemption, wall-clock and asynchronous checkpoints on
the CPU: ``utils/preemption.py`` polled by ``train/loop.py``, the
``CheckpointManager`` of ``ckpt/checkpoint.py`` (``async_save``,
``every_secs``/``time_due``, ``flush``, ``close``) and the CLI's flags,
against the JAX package where it has the same piece.

- ``--fault_spec sigterm@N`` stops the run after the dispatch at the first
  seam at or past step N, with a checkpoint there, a ``preempt`` record
  and ``preempted`` set; resuming to the end gives the final parameters
  of an uninterrupted run, bit for bit (eager, and chunked on the device
  index stream).
- Two gloo ranks, only rank 1 signalled, stop together at the next
  exchange with one checkpoint; a wall-clock cadence saves at the same
  steps on both; ``skip`` recovers on both.
- Asynchronous checkpoints are byte-identical to synchronous ones, are
  written in order, copy the state at the call, and a writer error
  surfaces at the next save or flush.
- ``time_due`` follows a patched clock; a run saves on it.
- A trainer off the main thread, where no signal handler can be set,
  says so on stderr and refuses a ``sigterm`` drill.
- The 13 flags of this slice parse to the JAX CLI's values.
"""

import json
import os
import threading

import pytest
import torch

import _torch_dist

from dml_cnn_cifar10_tpu.cli.main import build_parser as jax_parser
from dml_cnn_cifar10_tpu.cli.main import config_from_args as jax_config
from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                config_from_args)
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              OptimConfig)
from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
from dml_cnn_cifar10_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("synth"))


def _args(data_dir, log_dir, *extra):
    return ["--device", "cpu", "--dataset", "synthetic",
            "--data_dir", data_dir, "--log_dir", str(log_dir),
            "--synthetic_train_records", "96", "--fidelity", "fixed",
            "--learning_rate", "0.02", "--batch_size", "16",
            "--output_every", "4", "--eval_every", "100",
            "--checkpoint_every", "100", *extra]


def _fit(argv):
    trainer = Trainer(config_from_args(build_parser().parse_args(argv)))
    try:
        return trainer.fit()
    finally:
        trainer.close()


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("k, stop", [(1, 8), (2, 10)],
                         ids=["eager", "chunked"])
def test_sigterm_stops_checkpoints_and_resumes_exactly(data_dir, tmp_path,
                                                       k, stop):
    common = ["--steps_per_dispatch", str(k), "--random_brightness", "20",
              "--random_contrast", "0.3"]
    full = _fit(_args(data_dir, tmp_path / "full", *common,
                      "--total_steps", "16"))
    assert not full.preempted
    jsonl = str(tmp_path / "cut" / "m.jsonl")
    cut = _args(data_dir, tmp_path / "cut", *common, "--metrics_jsonl",
                jsonl)
    res = _fit(cut + ["--total_steps", "16", "--fault_spec", "sigterm@7"])
    assert res.preempted and res.final_step == stop
    recs = _records(jsonl)
    assert [r["step"] for r in recs if r["kind"] == "preempt"] == [stop]
    assert [(r["fault"], r["step"]) for r in recs
            if r["kind"] == "fault"] == [("sigterm", stop - k)]
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "cut")).endswith(
        f"ckpt_{stop}.msgpack")
    resumed = _fit(cut + ["--total_steps", "16"])
    assert resumed.final_step == 16 and not resumed.preempted
    for name, p in full.state.params.items():
        assert torch.equal(p, resumed.state.params[name]), name


def test_two_gloo_ranks_stop_save_and_skip_together(data_dir, tmp_path):
    def run(name, *extra, signalled=()):
        hosts = ",".join(f"localhost:{p}"
                         for p in _torch_dist.free_ports(2))
        base = _args(data_dir, tmp_path / name, "--total_steps", "16",
                     "--worker_hosts", hosts, "--dist_backend", "gloo",
                     "--preempt_sync_every", "2", *extra)
        return [base + (list(signalled) if r == 1 else []) for r in (0, 1)]

    runs = [run("sig", signalled=("--fault_spec", "sigterm@5")),
            run("clock", "--checkpoint_every_secs", "1e-9"),
            run("skip", "--check_numerics", "true", "--on_nonfinite",
                "skip", "--fault_spec", "nan@5")]
    ranks = _torch_dist.run_ranks("fit_ranks", 2, tmp_path / "ranks", runs)
    sig, clock, skip = zip(*ranks)
    # Rank 1 is signalled at step 5; the next exchange (after dispatch 6)
    # stops both there, with the one checkpoint rank 0 writes.
    assert [r["final_step"] for r in sig] == [6, 6]
    assert all(r["preempted"] for r in sig)
    assert sig[0]["saved"] == sig[1]["saved"] == [6]
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "sig")).endswith(
        "ckpt_6.msgpack")
    # The clock is due at every exchange on both ranks: the same steps.
    assert clock[0]["saved"] == clock[1]["saved"] \
        == [2, 4, 6, 8, 10, 12, 14, 16]
    assert [r["final_step"] for r in skip] == [16, 16]
    assert all(r["finite"] for r in skip)


def _state(seed=0):
    model = CNN(ModelConfig(), DataConfig())
    return step_lib.init_train_state(model, OptimConfig(momentum=0.9),
                                     torch.device("cpu"),
                                     torch.Generator().manual_seed(seed))


def _bump(state):
    with torch.no_grad():
        for t in step_lib._state_tensors(state):
            t.add_(1)


def _files(log_dir):
    return {n: open(os.path.join(log_dir, n), "rb").read()
            for n in sorted(os.listdir(log_dir))}


def test_async_saves_equal_sync_in_order_and_copied_at_the_call(tmp_path):
    dirs = {}
    for mode in (False, True):
        state = _state()
        mgr = ckpt_lib.CheckpointManager(str(tmp_path / str(mode)), 2,
                                         keep=10, async_save=mode)
        for step in range(1, 7):
            mgr.maybe_save(state, step, data_state={"train": step})
            _bump(state)   # the next dispatch, in place
        mgr.close()
        dirs[mode] = _files(str(tmp_path / str(mode)))
    assert dirs[True] == dirs[False]
    assert sorted(n for n in dirs[True] if n.endswith(".msgpack")) == [
        "ckpt_2.msgpack", "ckpt_4.msgpack", "ckpt_6.msgpack"]
    assert dirs[True]["checkpoint"] == b"ckpt_6.msgpack\n"


def test_async_writer_order_and_error(tmp_path, monkeypatch):
    order, gate = [], threading.Event()
    write = ckpt_lib.write_tree

    def slow(ckpt_dir, tree, step, keep=3):
        if step == 1:
            gate.wait(5)
        order.append((step, threading.current_thread().name))
        if step == 3:
            raise OSError("disk full")
        return write(ckpt_dir, tree, step, keep)

    monkeypatch.setattr(ckpt_lib, "write_tree", slow)
    mgr = ckpt_lib.CheckpointManager(str(tmp_path), 1, async_save=True)
    state = _state()
    assert mgr.maybe_save(state, 1)
    threading.Timer(0.2, gate.set).start()
    assert mgr.maybe_save(state, 2)     # waits for step 1 first
    assert mgr.maybe_save(state, 3)     # handed to the writer
    with pytest.raises(OSError, match="disk full"):
        mgr.maybe_save(state, 4)
    mgr.close()
    assert [s for s, _ in order] == [1, 2, 3]
    assert all(name.startswith("ckpt-writer") for _, name in order)
    assert ckpt_lib.latest_checkpoint(str(tmp_path)).endswith(
        "ckpt_2.msgpack")
    # flush raises a failed write too, once.
    mgr = ckpt_lib.CheckpointManager(str(tmp_path / "b"), 1,
                                     async_save=True)
    mgr.maybe_save(state, 3)
    with pytest.raises(OSError):
        mgr.flush()
    mgr.close()


def test_time_due_follows_the_clock_and_a_run_saves_on_it(data_dir,
                                                          tmp_path,
                                                          monkeypatch):
    now = [100.0]
    monkeypatch.setattr(ckpt_lib.time, "monotonic", lambda: now[0])
    mgr = ckpt_lib.CheckpointManager(str(tmp_path / "c"), 1000,
                                     every_secs=30.0)
    assert not mgr.time_due()
    now[0] = 129.9
    assert not mgr.time_due()
    now[0] = 130.0
    assert mgr.time_due()
    assert mgr.maybe_save(_state(), 7, force=True)
    assert not mgr.time_due()            # the save restarts the clock
    assert not ckpt_lib.CheckpointManager(str(tmp_path / "d"), 10
                                          ).time_due()
    monkeypatch.undo()
    # A run whose step cadence never fires saves on the clock: due after
    # every dispatch at this cadence, so at every step.
    res = _fit(_args(data_dir, tmp_path / "run", "--total_steps", "6",
                     "--checkpoint_every_secs", "1e-9", "--async_checkpoint",
                     "true"))
    assert res.final_step == 6
    assert sorted(int(n[5:-8]) for n in os.listdir(tmp_path / "run")
                  if n.endswith(".msgpack")) == [4, 5, 6]   # keep 3


FLAGS = ["--checkpoint_every_secs", "2.5", "--random_brightness", "63",
         "--random_contrast", "0.8", "--async_checkpoint", "true",
         "--check_numerics", "true", "--on_nonfinite", "skip",
         "--recovery_retries", "2", "--fault_spec", "nan@5,sigterm@9",
         "--preempt_sync_every", "4", "--telemetry", "true",
         "--trace_events_path", "/tmp/trace.json", "--health_metrics",
         "true", "--tensorboard_dir", "/tmp/tb"]
FIELDS = ["checkpoint_every_secs", "data.random_brightness",
          "data.random_contrast", "async_checkpoint", "check_numerics",
          "on_nonfinite", "recovery_retries", "fault_spec",
          "preempt_sync_every", "telemetry", "trace_events_path",
          "health_metrics", "tensorboard_dir"]


@pytest.mark.parametrize("argv", [[], FLAGS], ids=["defaults", "set"])
def test_cli_flags_parse_as_jax(argv):
    port = config_from_args(build_parser().parse_args(argv))
    jax_cfg = jax_config(jax_parser().parse_args(argv))

    def get(cfg, field):
        for part in field.split("."):
            cfg = getattr(cfg, part)
        return cfg

    for field in FIELDS:
        assert get(port, field) == get(jax_cfg, field), field
    assert len(FIELDS) == 13


def test_trainer_off_the_main_thread_says_so(data_dir, tmp_path, capfd):
    """Python installs signal handlers on the main thread only: a trainer
    on another thread says SIGTERM is not caught, and refuses a sigterm
    drill that would kill the process."""
    out = {}

    def run(name, *extra):
        try:
            out[name] = _fit(_args(data_dir, tmp_path / name,
                                   "--total_steps", "4", *extra))
        except Exception as e:
            out[name] = e

    for name, extra in (("plain", ()), ("drill", ("--fault_spec",
                                                  "sigterm@2"))):
        t = threading.Thread(target=run, args=(name, *extra))
        t.start()
        t.join(120)
        assert not t.is_alive()
    assert out["plain"].final_step == 4
    assert isinstance(out["drill"], RuntimeError)
    assert "main thread" in str(out["drill"])
    assert "off the main thread" in capfd.readouterr().err
