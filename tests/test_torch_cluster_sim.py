"""PyTorch port, the cluster layer end to end: two-process lockstep
simulations of port processes (``--cluster_lockstep``: each process a
world of its own, the dispatch seam a barrier over the beat store), beside
the JAX package's simulation of the same spec.

One module-scoped fixture starts every process at once (the JAX sims
overlapping the port's), on 256/64 synthetic records, batch 32, lr 0.05,
checkpoints every 10 steps, as JAX ``tests/test_cluster.py:256-272``:

- ``host_lost@15`` on process 1 (``os._exit(77)``): the survivor declares
  it lost on stale beats, shrinks to world 1 from ``ckpt_10`` and ends
  bit-identical to a fault-free one-process run restored from that
  checkpoint; its ``elastic_restart`` record equals the JAX survivor's.
- ``heartbeat_stall@15`` on process 1: the survivor restarts without it
  (bit-identical, as above); the stalled process finds the decision that
  excluded it and fences (exit 0, no result).
- ``host_lost@15`` on process 1 and ``host_return@18`` on process 0 with
  ``--elastic_expand``: the world goes 2 → 1 → 2 (process 1 respawned
  once the shrink is committed), both seats end bit-identical to an
  uninterrupted two-process run, and the ``elastic_restart`` /
  ``elastic_expand`` records equal the JAX sim's (epoch, world size,
  restore step, attempt, source, lost / joined).

Every port stream passes ``tools/check_jsonl_schema.py --strict``.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from dml_cnn_cifar10_tpu_torch.config import DataConfig, TrainConfig
from dml_cnn_cifar10_tpu_torch.data import ensure_dataset
from dml_cnn_cifar10_tpu_torch.parallel import cluster as cluster_lib
from dml_cnn_cifar10_tpu_torch.train.loop import Trainer
from dml_cnn_cifar10_tpu_torch.utils import faults

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOTAL = 40
RESTORE = 10
RECORD_FIELDS = ("step", "restore_step", "world_size", "epoch", "attempt",
                 "source", "lost", "joined")

# The run both packages' workers make: JAX tests/test_cluster.py:256-280.
PORT_WORKER = """
import hashlib, json, sys
import torch
torch.set_num_threads(1)
task, n, data_dir, log_dir, cluster_dir, fault_spec, total, expand = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    sys.argv[5], sys.argv[6], int(sys.argv[7]), sys.argv[8] == "1")
from dml_cnn_cifar10_tpu_torch.config import DataConfig, TrainConfig
from dml_cnn_cifar10_tpu_torch.train.supervisor import fit_supervised

cfg = TrainConfig(
    batch_size=32, total_steps=total, output_every=10, eval_every=20,
    checkpoint_every=10, log_dir=log_dir,
    metrics_jsonl=f"{log_dir}/metrics.jsonl", device="cpu",
    data=DataConfig(dataset="synthetic", data_dir=data_dir,
                    synthetic_train_records=256, synthetic_test_records=64,
                    normalize="scale"))
cfg.model.logit_relu = False
cfg.optim.learning_rate = 0.05
cfg.keep_checkpoints = 20
cfg.recovery_backoff_s = 0.05
cfg.recovery_backoff_max_s = 0.2
cfg.fault_spec = fault_spec or None
cfg.parallel.process_id = task
cfg.parallel.num_processes = n
if cluster_dir:
    cfg.parallel.cluster_dir = cluster_dir
    cfg.parallel.cluster_lockstep = True
    cfg.parallel.elastic_expand = expand
    cfg.parallel.heartbeat_interval_s = 0.1
    cfg.parallel.straggler_after_s = 0.4
    cfg.parallel.peer_dead_after_s = 2.5
    cfg.parallel.collective_timeout_s = 300.0
res = fit_supervised(cfg, task_index=task)
if res is None:
    print("RESULT " + json.dumps({"task": task, "fenced": True}))
    sys.exit(0)
h = hashlib.sha256()
for name in sorted(res.state.params):
    h.update(res.state.params[name].detach().contiguous().numpy().tobytes())
print("RESULT " + json.dumps({"task": task, "fenced": False,
                              "final_step": res.final_step,
                              "digest": h.hexdigest()}))
"""

JAX_WORKER = """
import json, sys
from dml_cnn_cifar10_tpu.utils.platform import force_cpu
force_cpu()
task, n, data_dir, log_dir, cluster_dir, fault_spec, total, expand = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    sys.argv[5], sys.argv[6], int(sys.argv[7]), sys.argv[8] == "1")
from dml_cnn_cifar10_tpu.config import DataConfig, TrainConfig
from dml_cnn_cifar10_tpu.train.supervisor import fit_supervised

cfg = TrainConfig(
    batch_size=32, total_steps=total, output_every=10, eval_every=20,
    checkpoint_every=10, log_dir=log_dir,
    metrics_jsonl=f"{log_dir}/metrics.jsonl",
    data=DataConfig(dataset="synthetic", data_dir=data_dir,
                    synthetic_train_records=256, synthetic_test_records=64,
                    normalize="scale", use_native_loader=False))
cfg.model.logit_relu = False
cfg.optim.learning_rate = 0.05
cfg.keep_checkpoints = 20
cfg.recovery_backoff_s = 0.05
cfg.recovery_backoff_max_s = 0.2
cfg.fault_spec = fault_spec or None
cfg.parallel.process_id = task
cfg.parallel.num_processes = n
cfg.parallel.cluster_dir = cluster_dir
cfg.parallel.cluster_lockstep = True
cfg.parallel.elastic_expand = expand
cfg.parallel.heartbeat_interval_s = 0.1
cfg.parallel.straggler_after_s = 0.4
cfg.parallel.peer_dead_after_s = 2.5
cfg.parallel.collective_timeout_s = 300.0
res = fit_supervised(cfg, task_index=task)
print("RESULT " + json.dumps({"task": task, "fenced": res is None}))
"""


def _spawn(script, args, out_path):
    """Start a worker, its output to ``out_path`` (a pipe nobody reads
    while the loop polls would fill and block it)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="",
               OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    with open(out_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, str(script)] + [str(a) for a in args],
            stdout=out, stderr=subprocess.STDOUT, env=env, cwd=REPO)
    proc.out_path = out_path
    return proc


def _output(proc):
    with open(proc.out_path) as f:
        return f.read()


def _result(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert lines, f"no RESULT line in:\n{out}"
    return json.loads(lines[-1][len("RESULT "):])


def _records(log_dir, kind=None):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [r for r in recs if kind is None or r["kind"] == kind]


def _fields(recs):
    return [{k: r[k] for k in RECORD_FIELDS if k in r} for r in recs]


class _Sim:
    """One two-process scenario: its processes, and for the expand drill
    the respawn of process 1 once the shrink is committed."""

    def __init__(self, root, script, data_dir, name, specs, expand=False):
        self.script, self.data_dir, self.expand = script, data_dir, expand
        self.dir = os.path.join(root, name)
        self.cluster = os.path.join(self.dir, "cluster")
        self.logs = [os.path.join(self.dir, f"logs_{t}") for t in (0, 1)]
        os.makedirs(self.dir)
        self.procs = [self._start(t, spec, "") for t, spec in enumerate(specs)]
        self.respawned = None
        self.first_exit = None

    def _start(self, task, spec, life):
        return _spawn(self.script, [task, 2, self.data_dir, self.logs[task],
                                    self.cluster, spec, TOTAL,
                                    int(self.expand)],
                      os.path.join(self.dir, f"out_{task}{life}.txt"))

    def poll_respawn(self):
        """Respawn process 1 after its abrupt death AND the survivor's
        committed shrink (JAX tests/test_elastic_expand.py:233-246)."""
        if not self.expand or self.respawned is not None \
                or self.procs[1].poll() is None:
            return
        d = cluster_lib.RestartCoordinator(self.cluster).read()
        if d is not None and d.epoch >= 1:
            self.first_exit = self.procs[1].returncode
            self.respawned = self._start(1, "", "_respawned")

    def live(self) -> bool:
        procs = self.procs + ([self.respawned] if self.respawned else [])
        waiting = self.expand and self.respawned is None \
            and self.procs[0].poll() is None
        return waiting or any(p.poll() is None for p in procs)

    def finish(self):
        """``[(exit code, output)]`` of process 0 and of process 1 (its
        respawned life in the expand drill)."""
        last = [self.procs[0], self.respawned or self.procs[1]]
        return [(p.returncode, _output(p)) for p in last]

    def kill(self):
        for p in self.procs + ([self.respawned] if self.respawned else []):
            if p.poll() is None:
                p.kill()
                p.wait()


def _restored_digest(root, data_dir, survivor_logs):
    """The digest of a fault-free one-process run restored from the
    survivor's restart checkpoint (copied into a fresh directory)."""
    name = os.path.basename(os.path.dirname(survivor_logs))
    ref = os.path.join(root, f"ref_{name}")
    os.makedirs(ref)
    for name in (f"ckpt_{RESTORE}.msgpack", f"ckpt_{RESTORE}.msgpack.sha256",
                 f"data_state_{RESTORE}.json"):
        shutil.copy(os.path.join(survivor_logs, name), ref)
    cfg = TrainConfig(
        batch_size=32, total_steps=TOTAL, output_every=10, eval_every=20,
        checkpoint_every=10, log_dir=ref, device="cpu",
        data=DataConfig(dataset="synthetic", data_dir=data_dir,
                        synthetic_train_records=256,
                        synthetic_test_records=64, normalize="scale"))
    cfg.model.logit_relu = False
    cfg.optim.learning_rate = 0.05
    cfg.keep_checkpoints = 20
    # The workers' thread count: another one sums the convolutions'
    # gradients in another order.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trainer = Trainer(cfg)
    try:
        res = trainer.fit()
    finally:
        trainer.close()
        torch.set_num_threads(threads)
    assert res.final_step == TOTAL
    h = hashlib.sha256()
    for name in sorted(res.state.params):
        h.update(res.state.params[name].detach().contiguous().numpy()
                 .tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cluster_sim"))
    data_dir = os.path.join(root, "data")
    ensure_dataset(DataConfig(dataset="synthetic", data_dir=data_dir,
                              synthetic_train_records=256,
                              synthetic_test_records=64))
    port, jax_script = (os.path.join(root, n)
                        for n in ("port_worker.py", "jax_worker.py"))
    with open(port, "w") as f:
        f.write(PORT_WORKER)
    with open(jax_script, "w") as f:
        f.write(JAX_WORKER)
    runs = {
        "host_lost": _Sim(root, port, data_dir, "host_lost",
                          ["", "host_lost@15"]),
        "heartbeat_stall": _Sim(root, port, data_dir, "heartbeat_stall",
                                ["", "heartbeat_stall@15"]),
        "expand": _Sim(root, port, data_dir, "expand",
                       ["host_return@18", "host_lost@15"], expand=True),
        "uninterrupted": _Sim(root, port, data_dir, "uninterrupted",
                              ["", ""]),
        "jax_host_lost": _Sim(root, jax_script, data_dir, "jax_host_lost",
                              ["", "host_lost@15"]),
        "jax_expand": _Sim(root, jax_script, data_dir, "jax_expand",
                           ["host_return@18", "host_lost@15"], expand=True),
    }
    try:
        deadline = time.time() + 300
        while any(sim.live() for sim in runs.values()):
            assert time.time() < deadline, "a simulation did not finish"
            for sim in runs.values():
                sim.poll_respawn()
            time.sleep(0.1)
        done = {name: sim.finish() for name, sim in runs.items()}
    finally:
        for sim in runs.values():
            sim.kill()
    refs = {name: _restored_digest(root, data_dir, runs[name].logs[0])
            for name in ("host_lost", "heartbeat_stall")}
    return {"runs": runs, "done": done, "refs": refs}


@pytest.mark.parametrize("name, victim_rc", [
    ("host_lost", faults.EXIT_HOST_LOST), ("heartbeat_stall", 0)])
def test_survivor_bit_identical_to_restored_run(sims, name, victim_rc):
    (rc0, out0), (rc1, out1) = sims["done"][name]
    assert rc0 == 0, out0
    assert rc1 == victim_rc, out1
    survivor = _result(out0)
    assert not survivor["fenced"] and survivor["final_step"] == TOTAL
    assert survivor["digest"] == sims["refs"][name]


@pytest.mark.parametrize("name", ["host_lost", "heartbeat_stall"])
def test_survivor_records(sims, name):
    from tools import check_jsonl_schema
    logs = sims["runs"][name].logs[0]
    assert check_jsonl_schema.check_file(
        os.path.join(logs, "metrics.jsonl"), strict=True) == []
    lost = [r for r in _records(logs, "peer_lost")
            if r["reason"] == "stale_heartbeat"]
    assert lost and lost[0]["process_id"] == 1
    assert _fields(_records(logs, "elastic_restart")) == [dict(
        step=RESTORE, restore_step=RESTORE, world_size=1, epoch=1,
        attempt=1, source="disk", lost=[1])]
    assert {r["kind"] for r in _records(logs)} >= {"heartbeat", "fault",
                                                   "recovery"}


def test_stalled_host_fences(sims):
    (_, _), (rc1, out1) = sims["done"]["heartbeat_stall"]
    assert rc1 == 0 and _result(out1) == {"task": 1, "fenced": True}
    logs = sims["runs"]["heartbeat_stall"].logs[1]
    assert [r["reason"] for r in _records(logs, "peer_lost")
            if r["process_id"] == 1] == ["evicted"]


def test_elastic_restart_matches_jax(sims):
    (rc0, out0), (rc1, _) = sims["done"]["jax_host_lost"]
    assert rc0 == 0 and rc1 == faults.EXIT_HOST_LOST, out0
    want = _fields(_records(sims["runs"]["jax_host_lost"].logs[0],
                            "elastic_restart"))
    got = _fields(_records(sims["runs"]["host_lost"].logs[0],
                           "elastic_restart"))
    assert got == want


@pytest.mark.parametrize("seat", [0, 1])
def test_expand_bit_identical_to_uninterrupted(sims, seat):
    sim = sims["runs"]["expand"]
    assert sim.first_exit == faults.EXIT_HOST_LOST, _output(sim.procs[1])
    rc, out = sims["done"]["expand"][seat]
    assert rc == 0, out
    got = _result(out)
    ref_rc, ref_out = sims["done"]["uninterrupted"][seat]
    assert ref_rc == 0, ref_out
    ref = _result(ref_out)
    assert not got["fenced"] and got["final_step"] == TOTAL
    assert got["digest"] == ref["digest"]


@pytest.mark.parametrize("seat", [0, 1])
def test_expand_records_match_jax(sims, seat):
    from tools import check_jsonl_schema
    for rc, out in sims["done"]["jax_expand"]:
        assert rc == 0, out
    logs = sims["runs"]["expand"].logs[seat]
    assert check_jsonl_schema.check_file(
        os.path.join(logs, "metrics.jsonl"), strict=True) == []
    jax_logs = sims["runs"]["jax_expand"].logs[seat]
    for kind in ("elastic_restart", "elastic_expand"):
        got = _fields(_records(logs, kind))
        assert got == _fields(_records(jax_logs, kind)), kind
    expand = _fields(_records(logs, "elastic_expand"))
    assert expand and expand[0]["world_size"] == 2 \
        and expand[0]["epoch"] == 2 and expand[0]["joined"] == [1] \
        and expand[0]["restore_step"] == RESTORE
    assert any(r["process_id"] == 1 for r in _records(logs, "host_rejoin"))


def test_uninterrupted_seats_agree(sims):
    """Two lockstep worlds of their own compute the same run."""
    results = [_result(out) for _, out in sims["done"]["uninterrupted"]]
    assert results[0]["digest"] == results[1]["digest"]
    assert {r["final_step"] for r in results} == {TOTAL}
