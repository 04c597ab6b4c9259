"""PyTorch port, the peer-replica store (``ckpt/peerstore.py``) on the CPU,
held to the JAX package's.

- JAX ``tests/test_peerstore.py``'s units (``:39-373``) on the port: the
  ring, the one-host no-op, push / retain / prune / idempotence / restart
  continuity, classified misses, replicas without sidecars, assembly of a
  lost host's shards under the coverage mask (partial overlaps and holes
  refused), the decision's ``source`` and its default, the replica fault
  kinds (deferred until a replica is committed), the vocabularies, the
  restore walk's ``walk_ms`` and ``--restore_deadline_s``, and one push a
  committed checkpoint boundary (not a step) in a trainer's fit.
- Across the packages: a replica of a CNN ``TrainState`` (momentum, EMA)
  written by the port's store is byte for byte the JAX store's replica of
  the same state, the JAX store restores the port's onto a JAX
  ``TrainState`` and the port's store restores the JAX one's onto a port
  ``TrainState``, each equal to the state carried across by
  ``convert.py``.
- Two spawned gloo ranks (``tests/_torch_dist.py:peer_payloads``) push
  their zero1 and fsdp shard payloads; a restore with rank 1 lost
  assembles the whole state from them, equal to the gathered state, and
  rank 1's replica alone leaves a hole (a ``ReplicaMiss``).
"""

import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

import _torch_dist
from dml_cnn_cifar10_tpu.ckpt import peerstore as jax_peerstore
from dml_cnn_cifar10_tpu.utils import faults as jax_faults
from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
from dml_cnn_cifar10_tpu_torch.ckpt import peerstore, sharded
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              OptimConfig, TrainConfig)
from dml_cnn_cifar10_tpu_torch.data import ensure_dataset
from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
from dml_cnn_cifar10_tpu_torch.parallel import cluster as cluster_lib
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
from dml_cnn_cifar10_tpu_torch.train.loop import Trainer
from dml_cnn_cifar10_tpu_torch.train.supervisor import classify_failure
from dml_cnn_cifar10_tpu_torch.utils import faults as faults_lib
from test_torch_sharded_ckpt import (CNN_KW, OPTIM, _jax_state, _port_state,
                                     _tree)
from test_torch_zero1 import _batches, _close


class FakeLogger:
    def __init__(self):
        self.records = []

    def log(self, kind, **fields):
        self.records.append({"kind": kind, **fields})

    def flush(self):
        pass


def _payload(values, start=0):
    arr = np.asarray(values, dtype=np.float32)
    return {"params/w": [{"index": [[start, start + arr.shape[0]]],
                          "data": arr}]}


W4 = {"params/w": {"shape": [4], "dtype": "float32"}}
STEP = 10


def _monitor(tmp_path, pid, n=2, **kw):
    kw.setdefault("heartbeat_interval_s", 0.05)
    kw.setdefault("straggler_after_s", 0.1)
    kw.setdefault("peer_dead_after_s", 0.5)
    kw.setdefault("collective_timeout_s", 60.0)
    return cluster_lib.ClusterMonitor(str(tmp_path), pid, n,
                                      logger=FakeLogger(), **kw)


# ---------------------------------------------------------------------------
# ring, push, read, assembly (JAX tests/test_peerstore.py:39-240)
# ---------------------------------------------------------------------------

def test_ring_assignment_world_sizes_1_to_4():
    assert peerstore.ring_successor(0, [0]) == 0
    assert peerstore.ring_predecessor(0, [0]) == 0
    for world in ([0, 1], [0, 1, 2], [3, 0, 2, 1]):
        ring = sorted(world)
        for pid in world:
            succ = peerstore.ring_successor(pid, world)
            assert succ in world and succ != pid
            assert peerstore.ring_predecessor(succ, world) == pid
            assert succ == jax_peerstore.ring_successor(pid, world)
        assert sorted(peerstore.ring_successor(p, world)
                      for p in world) == ring
    assert peerstore.ring_successor(3, [0, 3]) == 0
    assert peerstore.ring_predecessor(0, [0, 3]) == 3


def test_single_host_store_is_a_legal_noop(tmp_path):
    store = peerstore.PeerReplicaStore(str(tmp_path), 0, [0])
    try:
        assert not store.enabled
        assert store.push_async(10, _payload([1.0])) is False
        assert store.push_state_async(10, object()) is False
        store.flush()
        assert store.pushes == 0 and store.replica_step == -1
        assert store.committed_steps(0) == []
    finally:
        store.close()


def test_push_retain_prune_roundtrip(tmp_path):
    log = FakeLogger()
    store = peerstore.PeerReplicaStore(str(tmp_path), 0, [0, 1], keep=2,
                                       log_fn=log.log)
    try:
        for step in (10, 20, 30):
            assert store.push_async(step, _payload([step, step + 1.0]))
            store.flush()
        assert store.pushes == 3
        assert store.committed_steps(0) == [20, 30]
        assert store.replica_step == 30
        got = store.read_replica(0, 30)
        np.testing.assert_array_equal(got["params/w"][0]["data"],
                                      [30.0, 31.0])
        pushes = [r for r in log.records if r["kind"] == "peer_replica"
                  and r["op"] == "push"]
        assert len(pushes) == 3 and all(r["ok"] for r in pushes)
        assert all(r["bytes"] > 0 for r in pushes)
        with open(os.path.join(store._step_dir(0, 30),
                               peerstore.INDEX)) as f:
            assert json.load(f) == {"owner": 0, "dest": 1, "step": 30,
                                    "files": ["part_0.msgpack"]}
        # A replayed boundary is idempotent: no second commit or count.
        store.push_async(30, _payload([30.0, 31.0]))
        store.flush()
        assert store.pushes == 3
        assert store.committed_steps(0) == [20, 30]
    finally:
        store.close()
    again = peerstore.PeerReplicaStore(str(tmp_path), 0, [0, 1])
    try:
        assert again.replica_step == 30
    finally:
        again.close()


def test_push_failures_retry_then_log_and_never_raise(tmp_path):
    log = FakeLogger()
    store = peerstore.PeerReplicaStore(str(tmp_path), 0, [0, 1],
                                       log_fn=log.log)
    calls = []

    def broken(step, payload):
        calls.append(step)
        raise OSError("disk full")

    store._push = broken
    try:
        store.push_async(10, _payload([1.0]))
        store.flush()
    finally:
        store.close()
    assert calls == [10] * peerstore.PUSH_ATTEMPTS
    assert [(r["op"], r["ok"], r["error"]) for r in log.records] == [
        ("push", False, "disk full")]
    assert store.replica_step == -1


def test_read_misses_are_classified(tmp_path):
    store = peerstore.PeerReplicaStore(str(tmp_path), 0, [0, 1], keep=4)
    try:
        store.push_async(10, _payload([1.0, 2.0]))
        store.push_async(20, _payload([3.0, 4.0]))
        store.flush()
        with pytest.raises(peerstore.ReplicaMiss, match="missing or stale"):
            store.read_replica(0, 99)
        with pytest.raises(peerstore.ReplicaMiss):
            store.read_replica(7, 10)
        victim = os.path.join(store._step_dir(0, 10), "part_0.msgpack")
        with open(victim, "r+b") as f:
            f.truncate(os.path.getsize(victim) // 2)
        with pytest.raises(peerstore.ReplicaMiss, match="verification"):
            store.read_replica(0, 10)
        with open(os.path.join(store._step_dir(0, 20), peerstore.INDEX),
                  "w") as f:
            f.write("{not json")
        with pytest.raises(peerstore.ReplicaMiss, match="undecodable"):
            store.read_replica(0, 20)
    finally:
        store.close()


def test_legacy_sidecarless_replica_still_reads(tmp_path):
    store = peerstore.PeerReplicaStore(str(tmp_path), 0, [0, 1])
    try:
        store.push_async(10, _payload([5.0, 6.0]))
        store.flush()
        d = store._step_dir(0, 10)
        for name in os.listdir(d):
            if name.endswith(".sha256"):
                os.remove(os.path.join(d, name))
        events = []
        got = store.read_replica(
            0, 10, on_event=lambda k, **f: events.append({"kind": k, **f}))
        np.testing.assert_array_equal(got["params/w"][0]["data"],
                                      [5.0, 6.0])
        ios = [e for e in events if e["kind"] == "shard_io"]
        assert ios and all(e["verify"] is None and e["source"] == "peer"
                           for e in ios)
    finally:
        store.close()


def test_restore_assembles_lost_hosts_shards(tmp_path):
    log = FakeLogger()
    s0 = peerstore.PeerReplicaStore(str(tmp_path), 0, [0, 1],
                                    log_fn=log.log)
    s1 = peerstore.PeerReplicaStore(str(tmp_path), 1, [0, 1])
    try:
        s0.push_async(10, _payload([1.0, 2.0], start=0))
        s1.push_async(10, _payload([3.0, 4.0], start=2))
        s0.flush()
        s1.flush()
        events = []
        payloads = s0.gather(10, [0, 1], lost=[1], on_event=lambda k, **f:
                             events.append({"kind": k, **f}))
        out = peerstore.assemble(payloads, W4, 10)
        np.testing.assert_array_equal(out["params/w"], [1.0, 2.0, 3.0, 4.0])
        ios = [e for e in events if e["kind"] == "shard_io"]
        assert ios and all(e["source"] == "peer" for e in ios)
        assert any("memory" in e["shard"] for e in ios)
        recon = [r for r in log.records if r["kind"] == "peer_replica"
                 and r["op"] == "reconstruct"]
        assert recon and recon[0]["owner"] == 1 and recon[0]["ok"]
        shutil.rmtree(s1._step_dir(1, 10))
        with pytest.raises(peerstore.ReplicaMiss):
            s0.gather(10, [0, 1], lost=[1])
    finally:
        s0.close()
        s1.close()


def test_restore_places_the_lost_hosts_replica_over_its_own(tmp_path):
    """Where payloads cover the same ranges (every lockstep payload is
    whole), the restored state is the lost host's replica decoded from
    its files; the survivor's own payload in memory wins only among the
    survivors. A corrupt lost replica is a miss, whatever the memory
    holds."""
    mine, theirs = _port_state(), _port_state()
    with torch.no_grad():
        for t in theirs.params.values():
            t.add_(1.0)
    s0 = peerstore.PeerReplicaStore(str(tmp_path), 0, [0, 1])
    s1 = peerstore.PeerReplicaStore(str(tmp_path), 1, [0, 1])
    try:
        assert s0.push_state_async(STEP, mine)
        assert s1.push_state_async(STEP, theirs)
        s0.flush()
        s1.flush()
        for lost, want in (([1], theirs), ([], mine)):
            back = s0.restore(_port_state(), STEP, [0, 1], lost=lost)
            for name, t in want.params.items():
                assert torch.equal(back.params[name], t), (lost, name)
        victim = os.path.join(s1._step_dir(1, STEP), "part_0.msgpack")
        with open(victim, "r+b") as f:
            f.truncate(os.path.getsize(victim) // 2)
        with pytest.raises(peerstore.ReplicaMiss, match="verification"):
            s0.restore(_port_state(), STEP, [0, 1], lost=[1])
    finally:
        s0.close()
        s1.close()


def test_restore_rejects_partial_overlap_and_holes(tmp_path):
    s0 = peerstore.PeerReplicaStore(str(tmp_path), 0, [0, 1])
    s1 = peerstore.PeerReplicaStore(str(tmp_path), 1, [0, 1])
    try:
        s0.push_async(10, _payload([1.0, 2.0], start=0))
        s1.push_async(10, _payload([1.5, 2.5], start=1))
        s0.flush()
        s1.flush()
        with pytest.raises(peerstore.ReplicaMiss,
                           match="partially-overlapping"):
            peerstore.assemble(s0.gather(10, [0, 1], lost=[1]), W4, 10)
        s1.push_async(20, _payload([9.9], start=3))
        s0.push_async(20, _payload([1.0, 2.0], start=0))
        s0.flush()
        s1.flush()
        with pytest.raises(peerstore.ReplicaMiss, match="covered"):
            peerstore.assemble(s0.gather(20, [0, 1], lost=[1]), W4, 20)
        # Fully duplicate ranges (every payload whole) are no overlap.
        dup = [(0, _payload([1.0, 2.0, 3.0, 4.0])),
               (1, _payload([9.0, 9.0, 9.0, 9.0]))]
        np.testing.assert_array_equal(
            peerstore.assemble(dup, W4, 1)["params/w"], [1.0, 2.0, 3.0, 4.0])
    finally:
        s0.close()
        s1.close()


def test_decision_source_roundtrip_and_default(tmp_path):
    c = cluster_lib.RestartCoordinator(str(tmp_path / "new"))
    c.record(cluster_lib.RestartDecision(epoch=1, world_size=1,
                                         restore_step=10, survivors=[0],
                                         source="peer"))
    assert c.read().source == "peer"
    legacy = cluster_lib.RestartCoordinator(str(tmp_path / "old"))
    with open(legacy.path, "w") as f:
        json.dump({"epoch": 3, "world_size": 2, "restore_step": 20,
                   "survivors": [0, 1]}, f)
    d = legacy.read()
    assert d is not None and d.epoch == 3 and d.source == "disk"


def test_chief_decides_peer_from_advertised_replicas(tmp_path):
    """The decide seam reads every host's ``replica_step`` off the beats:
    peer at the MINIMUM advertised step when all pushed, disk otherwise;
    the ``peer_replica`` ``decide`` record carries the staleness; adopting
    a peer decision stages the restore once and re-forms the ring."""
    # No background beat between end_step(15) and the decision: the
    # staleness reads the beat of begin_step(14).
    mons = [_monitor(tmp_path, p, peer_redundancy=True,
                     peer_dead_after_s=60.0, heartbeat_interval_s=60.0)
            for p in (0, 1)]
    try:
        assert mons[0]._choose_restore_source(10) == ("disk", 10)
        mons[0].peer_store.push_async(20, _payload([1.0]))
        mons[1].peer_store.push_async(10, _payload([1.0]))
        for m in mons:
            m.peer_store.flush()
        mons[1].begin_step(14)
        mons[1].end_step(15)
        d = mons[0].decide_restart([1], 20)
        assert (d.source, d.restore_step, d.survivors) == ("peer", 10, [0])
        decides = [r for r in mons[0]._logger.records
                   if r["kind"] == "peer_replica" and r["op"] == "decide"]
        assert [(r["ok"], r["step"], r["staleness"]) for r in decides] == [
            (False, 10, None), (True, 10, 4)]
        mons[0].adopt(d)
        assert mons[0].peer_store.world == [0]
        assert not mons[0].peer_store.enabled
        assert mons[0].take_peer_restore() == (d, [0, 1], [1])
        assert mons[0].take_peer_restore() is None
    finally:
        for m in mons:
            m.close()


# ---------------------------------------------------------------------------
# replica faults, vocabularies, the restore walk's budget (JAX :263-370)
# ---------------------------------------------------------------------------

def test_replica_faults_defer_until_a_replica_is_committed(tmp_path):
    log = FakeLogger()
    for spec in ("replica_corrupt@1", "replica_stale@1"):
        with pytest.raises(faults_lib.InjectedFault, match="cluster"):
            faults_lib.FaultInjector.from_spec(spec).step_hook(
                2, None, "/tmp")
    mon = _monitor(tmp_path, 0, peer_redundancy=True, replica_keep=4)
    store = mon.peer_store
    try:
        inj = faults_lib.FaultInjector.from_spec("replica_corrupt@5")
        inj.step_hook(5, None, str(tmp_path), logger=log, cluster=mon)
        assert [e.kind for e in inj.pending()] == ["replica_corrupt"]
        store.push_async(10, _payload([1.0, 2.0]))
        store.flush()
        inj.step_hook(11, None, str(tmp_path), logger=log, cluster=mon)
        assert inj.pending() == []
        assert [(r["fault"], r["path"]) for r in log.records
                if r["kind"] == "fault"] == [
            ("replica_corrupt",
             os.path.join(store._step_dir(0, 10), "part_0.msgpack"))]
        with pytest.raises(peerstore.ReplicaMiss, match="verification"):
            store.read_replica(0, 10)
    finally:
        mon.close()


def test_replica_fault_waits_for_a_peers_pending_push(tmp_path):
    """A peer whose beat is past this process's newest boundary has
    queued its push of it: ``replica_corrupt`` holds until that commits,
    then truncates every owner's newest replica, so the drill lands on
    the set a restore reads whatever the push threads' timing."""
    log = FakeLogger()
    mons = [_monitor(tmp_path, p, peer_redundancy=True,
                     peer_dead_after_s=60.0) for p in (0, 1)]
    late = threading.Timer(0.3, mons[1].peer_store.push_async,
                           (10, _payload([3.0, 4.0])))
    try:
        mons[0].peer_store.push_async(10, _payload([1.0, 2.0]))
        mons[1].begin_step(12)
        late.start()
        inj = faults_lib.FaultInjector.from_spec("replica_corrupt@12")
        inj.step_hook(12, None, str(tmp_path), logger=log, cluster=mons[0])
        assert inj.pending() == []
        for owner in (0, 1):
            with pytest.raises(peerstore.ReplicaMiss, match="verification"):
                mons[0].peer_store.read_replica(owner, 10)
    finally:
        late.join()
        for m in mons:
            m.close()


def test_host_lost_commits_pending_replica_pushes_first(tmp_path,
                                                        monkeypatch):
    """``host_lost`` under peer redundancy: the pending push commits and
    a beat advertises it before the exit, so the chief's decision reads
    the replica step whatever the push thread's timing."""
    exits = []

    def fake_exit(code):
        exits.append(code)
        raise SystemExit(code)

    monkeypatch.setattr(faults_lib.os, "_exit", fake_exit)
    mon = _monitor(tmp_path, 1, peer_redundancy=True,
                   heartbeat_interval_s=60.0)
    try:
        mon.peer_store.push_async(10, _payload([1.0, 2.0]))
        mon.begin_step(15)
        inj = faults_lib.FaultInjector.from_spec("host_lost@15")
        with pytest.raises(SystemExit):
            inj.step_hook(15, None, str(tmp_path), logger=FakeLogger(),
                          cluster=mon)
        assert exits == [faults_lib.EXIT_HOST_LOST]
        assert mon.peer_store.committed_steps(1) == [10]
        beat = cluster_lib.HeartbeatStore(str(tmp_path), 0).read(1)
        assert (beat.step, beat.extra) == (15, {"replica_step": 10})
    finally:
        mon.close()


def test_replica_stale_deletes_newest_but_counters_still_advertise(
        tmp_path):
    log = FakeLogger()
    mon = _monitor(tmp_path, 0, peer_redundancy=True, replica_keep=4)
    store = mon.peer_store
    try:
        store.push_async(10, _payload([1.0]))
        store.push_async(20, _payload([2.0]))
        store.flush()
        inj = faults_lib.FaultInjector.from_spec("replica_stale@21")
        inj.step_hook(21, None, str(tmp_path), logger=log, cluster=mon)
        assert inj.pending() == []
        assert store.committed_steps(0) == [10]
        assert store.replica_step == 20
        with pytest.raises(peerstore.ReplicaMiss):
            store.read_replica(0, 20)
    finally:
        mon.close()


def test_replica_kinds_live_only_in_the_peer_vocabulary():
    peer_kinds = {t.partition("@")[0]
                  for t in faults_lib.CHAOS_PEER_VOCABULARY}
    assert {"replica_corrupt", "replica_stale"} <= peer_kinds
    assert set(faults_lib.CHAOS_CLUSTER_VOCABULARY) <= set(
        faults_lib.CHAOS_PEER_VOCABULARY)
    for vocab in (faults_lib.CHAOS_VOCABULARY,
                  faults_lib.CHAOS_CLUSTER_VOCABULARY,
                  faults_lib.CHAOS_EXPAND_VOCABULARY):
        assert not any(t.startswith("replica_") for t in vocab)
    assert faults_lib.FAULT_KINDS == jax_faults.FAULT_KINDS


def test_restore_walk_reports_walk_ms_and_enforces_deadline(tmp_path):
    s1 = _port_state()
    s1.opt["step"].fill_(1)
    ckpt_lib.save_checkpoint(str(tmp_path), s1, step=1)
    s2 = _port_state()
    with torch.no_grad():
        for t in s2.params.values():
            t.add_(1.0)
    p2 = ckpt_lib.save_checkpoint(str(tmp_path), s2, step=2)
    with open(p2, "r+b") as f:
        f.truncate(os.path.getsize(p2) // 2)
    walks = []
    restored = ckpt_lib.restore_checkpoint(
        str(tmp_path), _port_state(),
        on_fallback=lambda step, path, why, walk_ms: walks.append(walk_ms))
    assert int(restored.step) == 1
    for name, t in s1.params.items():
        assert torch.equal(restored.params[name], t)
    assert walks and walks[0] >= 0.0
    with pytest.raises(ValueError, match="deadline") as ei:
        ckpt_lib.restore_checkpoint(str(tmp_path), _port_state(),
                                    deadline_s=1e-9)
    assert classify_failure(ei.value) == "ckpt_restore"


def test_pushes_ride_checkpoint_boundaries_not_steps(tmp_path):
    from tools import check_jsonl_schema
    data_dir = str(tmp_path / "data")
    data = DataConfig(dataset="synthetic", data_dir=data_dir,
                      synthetic_train_records=128, synthetic_test_records=32,
                      normalize="scale")
    ensure_dataset(data)
    cfg = TrainConfig(batch_size=16, total_steps=40, output_every=10,
                      eval_every=40, checkpoint_every=10,
                      log_dir=str(tmp_path / "logs"), device="cpu",
                      metrics_jsonl=str(tmp_path / "m.jsonl"), data=data)
    cfg.keep_checkpoints = 20
    cfg.parallel.cluster_dir = str(tmp_path / "cluster")
    cfg.parallel.num_processes = 2
    cfg.parallel.cluster_lockstep = True
    cfg.parallel.peer_redundancy = True
    # The peer is one beat far ahead (the lockstep barrier never waits
    # for it) that is never declared dead.
    cfg.parallel.straggler_after_s = 60.0
    cfg.parallel.peer_dead_after_s = 600.0
    cluster_lib.HeartbeatStore(cfg.parallel.cluster_dir, 1).publish(
        10 ** 6, "train")
    trainer = Trainer(cfg)
    try:
        result = trainer.fit()
        store = trainer.cluster.peer_store
        assert result.final_step == 40
        assert store is not None and store.enabled
        store.flush()
        saved = ckpt_lib.all_checkpoint_steps(cfg.log_dir)
        assert saved == [10, 20, 30, 40] and store.pushes == len(saved)
        assert store.committed_steps(0) == [30, 40]
    finally:
        trainer.close()
    with open(cfg.metrics_jsonl) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    pushed = [r for r in recs if r["kind"] == "peer_replica"
              and r["op"] == "push" and r["ok"]]
    assert [r["step"] for r in pushed] == saved
    assert check_jsonl_schema.check_file(cfg.metrics_jsonl,
                                         strict=True) == []


def test_replicas_over_the_net_transport(tmp_path):
    """With a ``CoordClient`` the push stages its files, uploads them and
    commits by one server-side rename (the served directory's layout is
    the file store's); reads download into a scratch directory, and a
    partitioned reader's miss is classified."""
    from dml_cnn_cifar10_tpu_torch.parallel import net as net_lib
    from dml_cnn_cifar10_tpu_torch.utils import netfaults

    root = str(tmp_path)
    server = net_lib.CoordServer(root)
    stores = [peerstore.PeerReplicaStore(
        root, p, [0, 1], client=net_lib.CoordClient(root, p, timeout_s=2.0,
                                                    retries=0))
        for p in (0, 1)]
    state = _port_state()
    state.opt["step"].fill_(STEP)
    try:
        for s in stores:
            assert s.push_state_async(STEP, state)
            s.flush()
        assert [s.committed_steps(s.process_id) for s in stores] == [
            [STEP], [STEP]]
        assert sorted(os.listdir(os.path.join(
            root, peerstore.REPLICAS_DIRNAME, "host_1",
            f"step_{STEP:08d}"))) == ["INDEX.json", "part_0.msgpack",
                                      "part_0.msgpack.sha256"]
        fresh = peerstore.PeerReplicaStore(
            root, 0, [0, 1], client=net_lib.CoordClient(root, 0,
                                                        timeout_s=2.0))
        try:
            assert fresh.replica_step == STEP
            back = fresh.restore(_port_state(), STEP, [0, 1], lost=[1])
            for a, b in zip(step_lib._state_tensors(back),
                            step_lib._state_tensors(state)):
                assert torch.equal(a, b)
            netfaults.arm("net_partition", [0], duration_s=30.0)
            fresh._client.timeout_s = 0.2
            with pytest.raises(peerstore.ReplicaMiss, match="unreachable"):
                fresh.read_replica(1, STEP)
        finally:
            netfaults.clear()
            fresh.close()
    finally:
        for s in stores:
            s.close()
        server.stop()


# ---------------------------------------------------------------------------
# replicas across the packages
# ---------------------------------------------------------------------------

def _push_both(store_cls, root, state):
    stores = [store_cls(root, p, [0, 1]) for p in (0, 1)]
    try:
        for s in stores:
            assert s.push_state_async(STEP, state)
            s.flush()
    finally:
        for s in stores:
            s.close()


def test_replica_files_are_the_jax_stores_byte_for_byte(tmp_path):
    jstate, _, _ = _jax_state(steps=2)
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    _push_both(jax_peerstore.PeerReplicaStore, jax_root, jstate)
    port = ckpt_lib.load_tree_into(_port_state(), {**_tree(jstate),
                                                   "model_state": {}})
    _push_both(peerstore.PeerReplicaStore, port_root, port)
    for owner in (0, 1):
        rel = os.path.join(peerstore.REPLICAS_DIRNAME, f"host_{owner}",
                           f"step_{STEP:08d}")
        names = sorted(os.listdir(os.path.join(jax_root, rel)))
        assert sorted(os.listdir(os.path.join(port_root, rel))) == names \
            == ["INDEX.json", "part_0.msgpack", "part_0.msgpack.sha256"]
        for name in names:
            with open(os.path.join(jax_root, rel, name), "rb") as a, \
                    open(os.path.join(port_root, rel, name), "rb") as b:
                assert a.read() == b.read(), (owner, name)


def test_jax_store_restores_a_port_replica(tmp_path):
    jstate, _, _ = _jax_state(steps=2)
    port = ckpt_lib.load_tree_into(_port_state(), {**_tree(jstate),
                                                   "model_state": {}})
    port.opt["step"].fill_(STEP)
    _push_both(peerstore.PeerReplicaStore, str(tmp_path), port)
    target, _, _ = _jax_state(steps=0)
    store = jax_peerstore.PeerReplicaStore(str(tmp_path), 0, [0, 1])
    try:
        back = store.restore(target, STEP, [0, 1], lost=[1])
    finally:
        store.close()
    want = ckpt_lib.state_to_tree(port)
    _close(_tree(back), {k: want[k] for k in ("params", "opt")}, 0,
           "JAX <- port replica")
    assert int(np.asarray(back.opt["step"])) == STEP


def test_port_store_restores_a_jax_replica(tmp_path):
    jstate, _, _ = _jax_state(steps=2)
    _push_both(jax_peerstore.PeerReplicaStore, str(tmp_path), jstate)
    log = FakeLogger()
    store = peerstore.PeerReplicaStore(str(tmp_path), 0, [0, 1],
                                       log_fn=log.log)
    events = []
    try:
        target = _port_state()
        ptrs = [t.data_ptr() for t in step_lib._state_tensors(target)]
        back = store.restore(target, STEP, [0, 1], lost=[1],
                             on_event=lambda k, **f: events.append(f))
    finally:
        store.close()
    assert back is target
    # In place: a chunk's graph bound to these tensors stays valid.
    assert [t.data_ptr() for t in step_lib._state_tensors(back)] == ptrs
    assert all(t.is_contiguous() for t in step_lib._state_tensors(back))
    _close(ckpt_lib.state_to_tree(back), {**_tree(jstate),
                                          "model_state": {}}, 0,
           "port <- JAX replica")
    assert [(e["op"], e["source"]) for e in events] == [
        ("restore", "peer")] * 2
    assert [(r["op"], r["owner"]) for r in log.records] == [
        ("verify", 0), ("verify", 1), ("reconstruct", 1)]


# ---------------------------------------------------------------------------
# a lost rank's shards: zero1 and fsdp payloads of two gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rank_payloads(tmp_path_factory):
    work = tmp_path_factory.mktemp("peer_payloads")
    jstate, _, _ = _jax_state()
    base = dict(model=CNN_KW, optim=OPTIM, params=_tree(jstate)["params"],
                batches=_batches(6, n=2))
    runs = {mode: dict(base, mode=mode) for mode in ("zero1", "fsdp")}
    trees = _torch_dist.run_ranks("peer_payloads", 2, work / "ranks", runs,
                                  str(work / "cluster"))
    return work / "cluster", trees


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_restore_assembles_a_lost_ranks_shards(rank_payloads, mode):
    root, trees = rank_payloads
    _close(trees[0][mode], trees[1][mode], 0, "rank 0 vs rank 1")
    store = peerstore.PeerReplicaStore(os.path.join(root, mode), 0, [0, 1])
    try:
        # Each rank's payload holds only its shards: neither covers alone.
        for owner in (0, 1):
            with pytest.raises(peerstore.ReplicaMiss, match="covered"):
                peerstore.assemble([(owner, store.read_replica(owner, 1))],
                                   sharded.leaves_meta(_port_state()), 1)
        fresh = _port_state()
        store.restore(fresh, 1, [0, 1], lost=[1])
    finally:
        store.close()
    _close(ckpt_lib.state_to_tree(fresh), trees[0][mode], 0,
           f"{mode} replicas -> whole state")


def test_cnn_momentum_state_has_the_keys_the_restore_writes():
    """The assembly covers every leaf of a port state with momentum and
    EMA, the step counter included."""
    state = step_lib.init_train_state(
        CNN(ModelConfig(**CNN_KW), DataConfig()), OptimConfig(**OPTIM),
        torch.device("cpu"), torch.Generator().manual_seed(0))
    paths = set(sharded.leaves_meta(state))
    assert ".opt/step" in paths
    assert {p.split("/")[1] for p in paths if p.startswith(".opt/")} == {
        "ema", "momentum", "step"}
