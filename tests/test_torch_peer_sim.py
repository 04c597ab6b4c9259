"""PyTorch port, the rest of resilience end to end: two-process lockstep
simulations of port processes with peer redundancy and over the net
transport, beside the JAX package's simulations of the same specs.

One module-scoped fixture starts every process at once (the JAX sims
overlapping the port's), on 256/64 synthetic records, batch 32, lr 0.05,
checkpoints every 10 steps, 40 steps (JAX ``tests/test_peerstore.py:
414-456`` and ``tools/chaos.py:164-224``):

- **Diskless recovery** (``--peer_redundancy``, ``--ckpt_format
  sharded``, ``host_lost@15`` on process 1): the chief decides
  ``source="peer"`` at step 10, the survivor rebuilds its state from
  process 1's replica (placed before its own payload in memory), with
  ZERO checkpoint reads (every restore-side ``shard_io`` record says
  ``peer``), and ends
  bit-identical to a fault-free one-process run restored from its
  ``ckpt_10``.
- **``replica_corrupt@14``** on the survivor as well: the decision still
  says peer, the restore's sidecar check classifies the miss, a
  ``peer_replica`` ``fallback`` record lands, the disk walk restores
  (``shard_io`` ``source="disk"``), and the run ends bit-identical.
- **``net_partition@15``** on process 1 over ``--cluster_transport net``
  with ``host_return@18`` on process 0 and ``--elastic_expand``: process
  1 is cut off, classifies the silence and fences, process 0 shrinks,
  the partition heals, process 1 rejoins and the world expands; both
  seats end bit-identical to the uninterrupted run.
- The ``elastic_restart`` / ``elastic_expand`` records and the
  ``peer_replica`` records equal the JAX sims' field for field, apart
  from times and the expand's restore step (see ``EXPAND_RESTORES``);
  every port stream passes ``tools/check_jsonl_schema.py --strict``.

The port's peer simulations take phase 38's beat thresholds
(``chip_smoke.py:SIM_FLAGS``: a peer is dead after 5 s of stale beats);
the partition simulations take the JAX chaos oracle's (2.5 s), since the
partition heals after ``netfaults.PARTITION_HEAL_S`` = 6 s and the
majority must have shrunk by then.
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
from dml_cnn_cifar10_tpu_torch.train.loop import Trainer
from dml_cnn_cifar10_tpu_torch.utils import faults

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOTAL = 40
RESTORE = 10
ELASTIC_FIELDS = ("step", "restore_step", "world_size", "epoch", "attempt",
                  "source", "lost", "joined")
PEER_FIELDS = ("op", "step", "owner", "bytes", "ok", "staleness")
# An expand restores from the newest checkpoint when the chief sees the
# rejoin: ckpt_10 when the scan after the host_return@18 hold sees it,
# ckpt_20 when a loaded host's 0.5 s loopback scan times out and the next
# one, past the step-20 save, sees it (in either package). The records
# are held to JAX's apart from that step; the parameters, bit for bit,
# either way.
EXPAND_RESTORES = (RESTORE, 2 * RESTORE)
EXPAND_FIELDS = ("world_size", "epoch", "attempt", "source", "joined")

# The options every sim's processes share; `opts` adds a scenario's.
COMMON = """
cfg = TrainConfig(
    batch_size=32, total_steps=total, output_every=10, eval_every=20,
    checkpoint_every=10, log_dir=log_dir,
    metrics_jsonl=f"{log_dir}/metrics.jsonl", DEVICE
    data=DataConfig(dataset="synthetic", data_dir=data_dir,
                    synthetic_train_records=256, synthetic_test_records=64,
                    normalize="scale" NATIVE))
cfg.model.logit_relu = False
cfg.optim.learning_rate = 0.05
cfg.keep_checkpoints = 20
cfg.recovery_backoff_s = 0.05
cfg.recovery_backoff_max_s = 0.2
cfg.fault_spec = fault_spec or None
cfg.ckpt_format = opts.get("ckpt_format", "msgpack")
cfg.parallel.process_id = task
cfg.parallel.num_processes = 2
cfg.parallel.cluster_dir = cluster_dir
cfg.parallel.cluster_lockstep = True
cfg.parallel.elastic_expand = opts.get("expand", False)
cfg.parallel.peer_redundancy = opts.get("peer", False)
cfg.parallel.heartbeat_interval_s = 0.1
cfg.parallel.straggler_after_s = 0.4
cfg.parallel.peer_dead_after_s = opts["peer_dead_after_s"]
cfg.parallel.collective_timeout_s = 300.0
if opts.get("net"):
    cfg.parallel.cluster_transport = "net"
    cfg.parallel.net_timeout_s = 0.5
    cfg.parallel.net_retries = 2
res = fit_supervised(cfg, task_index=task)
"""

ARGS = """
import hashlib, json, sys
task, data_dir, log_dir, cluster_dir, fault_spec, total = (
    int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5],
    int(sys.argv[6]))
opts = json.loads(sys.argv[7])
"""

PORT_WORKER = ARGS + """
import torch
torch.set_num_threads(1)
from dml_cnn_cifar10_tpu_torch.config import DataConfig, TrainConfig
from dml_cnn_cifar10_tpu_torch.train.supervisor import fit_supervised
""" + COMMON.replace("DEVICE", 'device="cpu",').replace("NATIVE", "") + """
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

JAX_WORKER = ARGS + """
from dml_cnn_cifar10_tpu.utils.platform import force_cpu
force_cpu()
from dml_cnn_cifar10_tpu.config import DataConfig, TrainConfig
from dml_cnn_cifar10_tpu.train.supervisor import fit_supervised
""" + COMMON.replace("DEVICE", "").replace(
    "NATIVE", ", use_native_loader=False") + """
print("RESULT " + json.dumps({"task": task, "fenced": res is None}))
"""

PEER = dict(peer=True, ckpt_format="sharded", peer_dead_after_s=5.0)
NET = dict(net=True, expand=True, peer_dead_after_s=2.5)
SIMS = {
    "diskless": ("port", PEER, ["", "host_lost@15"]),
    "replica_corrupt": ("port", PEER, ["replica_corrupt@14",
                                       "host_lost@15"]),
    "net_partition": ("port", NET, ["host_return@18", "net_partition@15"]),
    "jax_diskless": ("jax", PEER, ["", "host_lost@15"]),
    "jax_net_partition": ("jax", NET, ["host_return@18",
                                       "net_partition@15"]),
}
VICTIM_RC = {"diskless": faults.EXIT_HOST_LOST,
             "replica_corrupt": faults.EXIT_HOST_LOST,
             "net_partition": 0}


def _spawn(script, args, out_path):
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


def _fields(recs, fields):
    return [{k: r[k] for k in fields if k in r} for r in recs]


def _digest(params):
    h = hashlib.sha256()
    for name in sorted(params):
        h.update(params[name].detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _one_process(root, data_dir, name, copy_from=None, fmt="msgpack"):
    """The digest of a fault-free one-process run, from scratch or
    restored from ``copy_from``'s ``ckpt_10`` (copied into a fresh
    directory), on the workers' one torch thread."""
    log_dir = os.path.join(root, name)
    os.makedirs(log_dir)
    if copy_from is not None:
        ckpt = f"ckpt_{RESTORE}.{fmt}"
        if fmt == "sharded":
            shutil.copytree(os.path.join(copy_from, ckpt),
                            os.path.join(log_dir, ckpt))
        else:
            shutil.copy(os.path.join(copy_from, ckpt), log_dir)
        for n in (f"{ckpt}.sha256", f"data_state_{RESTORE}.json"):
            shutil.copy(os.path.join(copy_from, n), log_dir)
    cfg = TrainConfig(
        batch_size=32, total_steps=TOTAL, output_every=10, eval_every=20,
        checkpoint_every=10, log_dir=log_dir, device="cpu",
        data=DataConfig(dataset="synthetic", data_dir=data_dir,
                        synthetic_train_records=256,
                        synthetic_test_records=64, normalize="scale"))
    cfg.model.logit_relu = False
    cfg.optim.learning_rate = 0.05
    cfg.keep_checkpoints = 20
    cfg.ckpt_format = fmt
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trainer = Trainer(cfg)
    try:
        res = trainer.fit()
    finally:
        trainer.close()
        torch.set_num_threads(threads)
    assert res.final_step == TOTAL
    return _digest(res.state.params)


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("peer_sim"))
    data_dir = os.path.join(root, "data")
    ensure_dataset(DataConfig(dataset="synthetic", data_dir=data_dir,
                              synthetic_train_records=256,
                              synthetic_test_records=64))
    scripts = {}
    for side, text in (("port", PORT_WORKER), ("jax", JAX_WORKER)):
        scripts[side] = os.path.join(root, f"{side}_worker.py")
        with open(scripts[side], "w") as f:
            f.write(text)
    procs, logs = {}, {}
    for name, (side, opts, specs) in SIMS.items():
        d = os.path.join(root, name)
        os.makedirs(d)
        logs[name] = [os.path.join(d, f"logs_{t}") for t in (0, 1)]
        procs[name] = [_spawn(scripts[side], [
            t, data_dir, logs[name][t], os.path.join(d, "cluster"), spec,
            TOTAL, json.dumps(opts)], os.path.join(d, f"out_{t}.txt"))
            for t, spec in enumerate(specs)]
    try:
        deadline = time.time() + 300
        while any(p.poll() is None for ps in procs.values() for p in ps):
            assert time.time() < deadline, "a simulation did not finish"
            time.sleep(0.1)
        done = {name: [(p.returncode, _output(p)) for p in ps]
                for name, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    # The references after the sims: beside them they would slow the
    # sims' beats.
    refs = {name: _one_process(root, data_dir, f"ref_{name}",
                               copy_from=logs[name][0], fmt="sharded")
            for name in ("diskless", "replica_corrupt")}
    refs["uninterrupted"] = _one_process(root, data_dir, "ref_uninterrupted")
    return {"logs": logs, "done": done, "refs": refs}


@pytest.mark.parametrize("name", ["diskless", "replica_corrupt"])
def test_survivor_bit_identical_to_restored_run(sims, name):
    (rc0, out0), (rc1, out1) = sims["done"][name]
    assert rc0 == 0, out0
    assert rc1 == VICTIM_RC[name], out1
    survivor = _result(out0)
    assert not survivor["fenced"] and survivor["final_step"] == TOTAL
    assert survivor["digest"] == sims["refs"][name]


def test_diskless_recovery_reads_no_checkpoint(sims):
    recs = _records(sims["logs"]["diskless"][0])
    restart = _fields([r for r in recs if r["kind"] == "elastic_restart"],
                      ELASTIC_FIELDS)
    assert restart == [dict(step=RESTORE, restore_step=RESTORE,
                            world_size=1, epoch=1, attempt=1,
                            source="peer", lost=[1])]
    restores = [r for r in recs if r["kind"] == "shard_io"
                and r["op"] != "save"]
    assert restores and all(r["source"] == "peer" for r in restores)
    assert any(r["kind"] == "shard_io" and r["op"] == "save"
               and r["source"] == "disk" for r in recs)
    ops = [(r["op"], r["owner"], r["ok"]) for r in recs
           if r["kind"] == "peer_replica" and r["op"] != "push"]
    assert ops == [("decide", None, True), ("verify", 1, True),
                   ("reconstruct", 1, True)]
    assert not [r for r in recs if r["kind"] == "ckpt_fallback"]


def test_replica_corrupt_falls_back_to_the_disk_walk(sims):
    recs = _records(sims["logs"]["replica_corrupt"][0])
    assert [r["fault"] for r in recs if r["kind"] == "fault"
            and r["injected"]] == ["replica_corrupt"]
    restart = [r for r in recs if r["kind"] == "elastic_restart"]
    assert restart and restart[0]["source"] == "peer"
    fallbacks = [r for r in recs if r["kind"] == "peer_replica"
                 and r["op"] == "fallback"]
    assert len(fallbacks) == 1 and fallbacks[0]["ok"] is False
    assert "verification" in fallbacks[0]["error"]
    after = recs[recs.index(fallbacks[0]):]
    assert [r for r in after if r["kind"] == "shard_io"
            and r["op"] == "restore" and r["source"] == "disk"]


@pytest.mark.parametrize("seat", [0, 1])
def test_partition_heals_expands_and_ends_bit_identical(sims, seat):
    rc, out = sims["done"]["net_partition"][seat]
    assert rc == 0, out
    got = _result(out)
    assert not got["fenced"] and got["final_step"] == TOTAL
    assert got["digest"] == sims["refs"]["uninterrupted"]
    recs = _records(sims["logs"]["net_partition"][seat])
    expand = [r for r in recs if r["kind"] == "elastic_expand"]
    assert [(r["world_size"], r["epoch"], r["source"], r["joined"])
            for r in expand] == [(2, 2, "disk", [1])]
    assert expand[0]["restore_step"] in EXPAND_RESTORES
    if seat == 1:
        assert [r["fault"] for r in recs if r["kind"] == "fault"
                and r["injected"]] == ["net_partition"]
        nets = [r for r in recs if r["kind"] == "net" and not r["ok"]]
        assert nets and {r["error"] for r in nets} <= {"timeout",
                                                        "unreachable"}


@pytest.mark.parametrize("name", ["diskless", "net_partition"])
def test_records_match_jax(sims, name):
    from tools import check_jsonl_schema
    for rc, out in sims["done"][f"jax_{name}"]:
        assert rc in (0, faults.EXIT_HOST_LOST), out
    for seat in (0, 1):
        logs = sims["logs"][name][seat]
        if not os.path.isfile(os.path.join(logs, "metrics.jsonl")):
            continue
        assert check_jsonl_schema.check_file(
            os.path.join(logs, "metrics.jsonl"), strict=True) == []
        jax_logs = sims["logs"][f"jax_{name}"][seat]
        for kind, fields in (("elastic_restart", ELASTIC_FIELDS),
                             ("elastic_expand", EXPAND_FIELDS)):
            assert _fields(_records(logs, kind), fields) == \
                _fields(_records(jax_logs, kind), fields), (seat, kind)
        assert _fields(_records(logs, "peer_replica"), PEER_FIELDS) == \
            _fields(_records(jax_logs, "peer_replica"), PEER_FIELDS), seat


def test_replica_corrupt_stream_is_schema_clean(sims):
    from tools import check_jsonl_schema
    for seat in (0, 1):
        path = os.path.join(sims["logs"]["replica_corrupt"][seat],
                            "metrics.jsonl")
        assert check_jsonl_schema.check_file(path, strict=True) == []
