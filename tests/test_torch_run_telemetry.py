"""PyTorch port, the run telemetry of this slice against the JAX package on
the CPU: ``utils/telemetry.py`` (``SpanTracer``, ``hbm_stats``,
``flush_boundary``), ``utils/logging.py``'s TensorBoard scalars, and the
trainer's use of them (the cases of the JAX ``tests/test_telemetry.py``
and ``tests/test_tensorboard.py`` that apply).

- The tracer gives the JAX tracer's spans on the same clock readings, is a
  shared no-op when disabled, counts ring overflow, reports goodput
  fractions that sum to 1 (within 1e-12 here, after rounding; the JAX
  tracer rounds the remainder alone, so its ``train_frac`` may differ by a
  few 1e-6), and exports a Chrome trace that loads as JSON.
- ``hbm`` on the CPU: ``available`` false, zeros, the JAX record's keys.
- A chunked run with ``--telemetry --trace_events_path --health_metrics``
  writes ``span``, ``goodput`` and ``hbm`` records, health keys on every
  ``train`` record, a stream that passes ``tools/check_jsonl_schema.py
  --strict``, and its Chrome trace, also when the run fails.
- Telemetry and health add no device read: a run with them reads the
  device as often as a run without (one ``tolist`` a metrics boundary).
- ``--tensorboard_dir`` writes event files with the tags the JAX logger
  writes for the same records; without ``tensorboardX`` the trainer
  raises ``ImportError`` before any step.
"""

import json
import os
import struct
import subprocess
import sys

import pytest
import torch
from torch.overrides import TorchFunctionMode

from dml_cnn_cifar10_tpu.utils import logging as jax_logging
from dml_cnn_cifar10_tpu.utils import telemetry as jax_telemetry
from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                config_from_args, main)
from dml_cnn_cifar10_tpu_torch.train.loop import Trainer
from dml_cnn_cifar10_tpu_torch.utils import faults
from dml_cnn_cifar10_tpu_torch.utils import logging as port_logging
from dml_cnn_cifar10_tpu_torch.utils import telemetry

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPANS = {"data_wait", "compile_first_dispatch", "dispatch",
         "boundary_drain", "eval", "checkpoint"}
HEALTH = ("health_grad_norm", "health_param_norm", "health_update_ratio")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("synth"))


def _args(data_dir, log_dir, *extra):
    return ["--device", "cpu", "--dataset", "synthetic",
            "--data_dir", data_dir, "--log_dir", str(log_dir),
            "--synthetic_train_records", "96", "--fidelity", "fixed",
            "--learning_rate", "0.02", "--batch_size", "16",
            "--output_every", "4", "--eval_every", "8",
            "--checkpoint_every", "8", "--total_steps", "8", *extra]


class _Clock:
    def __init__(self):
        self.now = 10.0

    def perf_counter(self):
        self.now += 0.25
        return self.now

    def time(self):
        return 1e9


def test_tracer_matches_jax_on_one_clock(monkeypatch, tmp_path):
    out = []
    for mod in (telemetry, jax_telemetry):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        tr = mod.SpanTracer(max_spans=4)
        with tr.span("compile_first_dispatch", cat="compile"):
            with tr.span("inner"):
                pass
        for name, cat in (("data_wait", "data"), ("eval", "eval"),
                          ("checkpoint", "checkpoint"),
                          ("preempt_allgather", "sync")):
            with tr.span(name, cat=cat):
                pass
        # 6 spans into a ring of 4: two dropped, counted.
        out.append((tr.drain(), tr.goodput(now=clock.now), tr.dropped, tr))
    (spans, gp, dropped, tr), (jspans, jgp, jdropped, _) = out
    assert spans == jspans and dropped == jdropped == 2
    assert [s[0] for s in spans] == ["inner", "compile_first_dispatch",
                                     "data_wait", "eval", "checkpoint",
                                     "preempt_allgather"][-4:]
    assert {k: v for k, v in gp.items() if k != "train_frac"} == \
        {k: v for k, v in jgp.items() if k != "train_frac"}
    assert abs(gp["train_frac"] - jgp["train_frac"]) < 5e-6
    assert abs(sum(v for k, v in gp.items() if k.endswith("_frac")) - 1) \
        < 1e-12
    assert tr.drain() == []
    path = str(tmp_path / "t" / "trace.json")
    tr.export_chrome_trace(path, pid=3)
    with open(path) as f:
        doc = json.load(f)
    assert len(doc["traceEvents"]) == 4
    assert doc["otherData"]["dropped_spans"] == 2
    assert {e["pid"] for e in doc["traceEvents"]} == {3}
    # Disabled: the shared no-op, nothing recorded, no clock read.
    off = telemetry.SpanTracer(enabled=False)
    assert off.span("x", cat="data") is off.span("y")
    with off.span("x", cat="data"):
        pass
    assert off.drain() == [] and off.goodput()["train_frac"] == 1.0


def test_hbm_on_the_cpu():
    stats = telemetry.hbm_stats(torch.device("cpu"))
    assert stats == {"available": False, "devices": 0, "bytes_in_use": 0,
                     "peak_bytes": 0, "bytes_limit": 0}
    assert set(stats) == set(jax_telemetry.hbm_stats())
    assert telemetry.hbm_stats() == stats


def _kinds(recs, kind):
    return [r for r in recs if r["kind"] == kind]


def test_chunked_run_stream_and_trace(data_dir, tmp_path):
    jsonl, trace = str(tmp_path / "m.jsonl"), str(tmp_path / "trace.json")
    assert main(_args(data_dir, tmp_path / "l", "--steps_per_dispatch", "2",
                      "--telemetry", "true", "--trace_events_path", trace,
                      "--health_metrics", "true", "--metrics_jsonl",
                      jsonl)) == 0
    with open(jsonl) as f:
        recs = [json.loads(line) for line in f]
    assert {r["name"] for r in _kinds(recs, "span")} == SPANS
    gps = _kinds(recs, "goodput")
    assert len(gps) == 3 and gps[-1]["final"] == 1
    for gp in gps:
        assert abs(sum(v for k, v in gp.items() if k.endswith("_frac"))
                   - 1.0) < 1e-6
    assert gps[-1]["compile_frac"] > 0 and gps[-1]["eval_frac"] > 0
    assert all(not h["available"] for h in _kinds(recs, "hbm"))
    for r in _kinds(recs, "train"):
        assert all(r[key] is not None and r[key] > 0 for key in HEALTH)
        assert r["health_update_ratio"] < 1
    lint = subprocess.run([sys.executable, os.path.join(
        ROOT, "tools", "check_jsonl_schema.py"), "--strict", jsonl],
        capture_output=True, text=True)
    assert lint.returncode == 0, lint.stdout + lint.stderr
    with open(trace) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert names == SPANS
    # A failed run leaves its trace too.
    failed = str(tmp_path / "failed.json")
    with pytest.raises(faults.DataStallError):
        main(_args(data_dir, tmp_path / "l2", "--telemetry", "true",
                   "--trace_events_path", failed, "--fault_spec",
                   "data_stall@5"))
    with open(failed) as f:
        assert "data_wait" in {e["name"] for e in
                               json.load(f)["traceEvents"]}
    with pytest.raises(ValueError, match="telemetry"):
        main(_args(data_dir, tmp_path / "l3", "--trace_events_path",
                   failed))


class _Reads(TorchFunctionMode):
    """Counts the calls that copy a tensor's value to the host."""

    NAMES = ("tolist", "item", "__float__", "__int__", "__bool__")

    def __init__(self):
        super().__init__()
        self.n = dict.fromkeys(self.NAMES, 0)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.n:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


def test_telemetry_and_health_add_no_device_read(data_dir, tmp_path):
    counts = []
    for extra in ([], ["--telemetry", "true", "--health_metrics", "true"]):
        trainer = Trainer(config_from_args(build_parser().parse_args(
            _args(data_dir, tmp_path / f"r{len(counts)}", *extra))))
        try:
            with _Reads() as reads:
                trainer.fit()
        finally:
            trainer.close()
        counts.append(reads.n)
    assert counts[0] == counts[1]
    assert counts[0]["tolist"] == 2        # one a metrics boundary


def _event_tags(log_dir):
    """Scalar tags of the TensorBoard event files under ``log_dir`` (the
    TFRecord framing: length, its crc, the event, its crc)."""
    from tensorboardX.proto import event_pb2
    tags = set()
    for name in os.listdir(log_dir):
        with open(os.path.join(log_dir, name), "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack("<Q", data[pos:pos + 8])
            event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
            tags.update(v.tag for v in event.summary.value)
            pos += 12 + n + 4
    return tags


def test_tensorboard_tags_match_jax_and_missing_package_raises(
        data_dir, tmp_path, monkeypatch):
    jsonl, tb = str(tmp_path / "m.jsonl"), str(tmp_path / "tb")
    assert main(_args(data_dir, tmp_path / "l", "--telemetry", "true",
                      "--health_metrics", "true", "--metrics_jsonl", jsonl,
                      "--tensorboard_dir", tb)) == 0
    with open(jsonl) as f:
        recs = [json.loads(line) for line in f]
    # The JAX logger, given the same records, writes the same tags.
    jax_tb = str(tmp_path / "jax_tb")
    logger = jax_logging.MetricsLogger(tensorboard_dir=jax_tb)
    for r in recs:
        logger.log(r["kind"], **{k: v for k, v in r.items()
                                 if k not in ("kind", "t", "task")})
    logger.close()
    tags = _event_tags(tb)
    assert tags == _event_tags(jax_tb)
    assert {"train/loss", "train/health_update_ratio", "eval/test_accuracy",
            "goodput/train_frac", "hbm/bytes_in_use"} <= tags
    assert "hbm/available" not in tags
    # Without tensorboardX: a clear ImportError at start-up.
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with pytest.raises(ImportError, match="tensorboardX"):
        port_logging.MetricsLogger(tensorboard_dir=str(tmp_path / "x"))
    with pytest.raises(ImportError, match="--tensorboard_dir"):
        main(_args(data_dir, tmp_path / "l4", "--tensorboard_dir",
                   str(tmp_path / "y"), "--metrics_jsonl",
                   str(tmp_path / "l5" / "m.jsonl")))
    assert not os.path.exists(tmp_path / "l4")
    assert not os.path.exists(tmp_path / "l5")
