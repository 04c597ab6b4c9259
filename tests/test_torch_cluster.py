"""PyTorch port, the cluster layer's units (``parallel/cluster.py``), the
backoff helper (``utils/backoff.py``), the supervisor's classification
(``train/supervisor.py:classify_failure``) and the cluster fault kinds
(``utils/faults.py``), against the JAX package on the CPU.

- The units of JAX ``tests/test_cluster.py:65-225`` and
  ``tests/test_elastic_expand.py:29-163``, on the port's classes: the beat
  store, the coordinator's monotone epochs and coordinator-loss timeout,
  the watchdog's straggler/dead classification and its abort, the stalled
  publisher, eviction, shrink under ``min_hosts``, chief succession, the
  rejoin scan and the expand decision, the stale-epoch exit.
- Interop both ways: beats and decisions written by the JAX
  ``HeartbeatStore``/``RestartCoordinator`` read back field for field in
  the port's and the other way round; the same decision's payload and
  sidecar are byte-identical; a corrupt decision file reads as absent,
  with a ``decision_corrupt`` record, in both.
- ``backoff.delay_s``/``schedule`` equal JAX's on a grid, and
  ``classify_failure`` names every class as JAX's does.
- The cluster kinds and the ``@phase`` triggers parse as JAX's, need a
  monitor, and fire at their seams.
"""

import json
import os
import threading
import time

import pytest

from dml_cnn_cifar10_tpu.parallel import cluster as jax_cluster
from dml_cnn_cifar10_tpu.train import supervisor as jax_supervisor
from dml_cnn_cifar10_tpu.utils import backoff as jax_backoff
from dml_cnn_cifar10_tpu.utils import faults as jax_faults
from dml_cnn_cifar10_tpu_torch.config import ParallelConfig, TrainConfig
from dml_cnn_cifar10_tpu_torch.data.pipeline import DataPipelineError
from dml_cnn_cifar10_tpu_torch.parallel import cluster
from dml_cnn_cifar10_tpu_torch.train import supervisor
from dml_cnn_cifar10_tpu_torch.utils import backoff, faults


class FakeLogger:
    def __init__(self):
        self.records = []

    def log(self, kind, **fields):
        self.records.append({"kind": kind, **fields})

    def flush(self):
        pass


def _monitor(tmp_path, pid, n=2, logger=None, **kw):
    kw.setdefault("heartbeat_interval_s", 0.05)
    kw.setdefault("straggler_after_s", 0.1)
    kw.setdefault("peer_dead_after_s", 0.5)
    kw.setdefault("collective_timeout_s", 60.0)
    return cluster.ClusterMonitor(str(tmp_path), pid, n,
                                  logger=logger or FakeLogger(), **kw)


# ---------------------------------------------------------------------------
# backoff and classification, against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base, cap", [(0.5, 30.0), (0.05, 0.2),
                                       (1.0, 30.0), (0.02, 0.2),
                                       (0.01, 30.0)])
def test_backoff_matches_jax(base, cap):
    for attempt in range(1, 12):
        assert backoff.delay_s(base, cap, attempt) \
            == jax_backoff.delay_s(base, cap, attempt)
    assert backoff.schedule(base, cap, 10) \
        == jax_backoff.schedule(base, cap, 10)
    with pytest.raises(ValueError):
        backoff.delay_s(base, cap, 0)
    cfg = TrainConfig()
    assert backoff.schedule(cfg.recovery_backoff_s,
                            cfg.recovery_backoff_max_s, 3) == [0.5, 1.0, 2.0]


def _failures(lib, cluster_lib, pipeline_error):
    """One exception of every class, for either package."""
    return [
        cluster_lib.PeerRejoinError([2], "x"),
        cluster_lib.PeerLostError([1], "stale"),
        lib.DataStallError("x"),
        pipeline_error("x"),
        FloatingPointError("nan"),
        ValueError("failed to restore checkpoint /x: bad"),
        ValueError("no restorable checkpoint in /x: every candidate failed"),
        ValueError("something else"),
        RuntimeError("boom"),
        cluster_lib.EvictedError("fenced"),
    ]


def test_classify_failure_matches_jax():
    from dml_cnn_cifar10_tpu.data.pipeline import \
        DataPipelineError as JaxPipelineError
    got = [supervisor.classify_failure(e) for e in
           _failures(faults, cluster, DataPipelineError)]
    want = [jax_supervisor.classify_failure(e) for e in
            _failures(jax_faults, jax_cluster, JaxPipelineError)]
    assert got == want == ["peer_rejoin", "peer_lost", "data", "data",
                           "nonfinite", "ckpt_restore", "ckpt_restore",
                           None, None, None]
    assert supervisor.RECOVERABLE_FAULTS == jax_supervisor.RECOVERABLE_FAULTS


# ---------------------------------------------------------------------------
# the beat store and the coordinator
# ---------------------------------------------------------------------------

def test_heartbeat_store_roundtrip(tmp_path):
    a = cluster.HeartbeatStore(str(tmp_path), 0)
    b = cluster.HeartbeatStore(str(tmp_path), 1)
    a.publish(7, "train")
    beat = b.read(0)
    assert beat.process_id == 0 and beat.step == 7
    assert beat.phase == "train" and beat.age_s() < 5.0
    assert b.read(3) is None                      # never published
    b.publish(0, "init")
    peers = a.read_peers([0, 1])                  # self excluded
    assert list(peers) == [1] and peers[1].step == 0
    assert sorted(a.read_all()) == [0, 1]


def test_restart_coordinator_record_await_and_monotone_epoch(tmp_path):
    c = cluster.RestartCoordinator(str(tmp_path))
    assert c.read() is None
    d = c.record(cluster.RestartDecision(
        epoch=1, world_size=1, restore_step=10, survivors=[0]))
    assert c.await_decision(min_epoch=1, timeout_s=1.0) == d
    with pytest.raises(ValueError, match="monotone"):
        c.record(cluster.RestartDecision(
            epoch=1, world_size=1, restore_step=10, survivors=[0]))
    with pytest.raises(cluster.PeerLostError) as ei:
        c.await_decision(min_epoch=2, timeout_s=0.15, poll_s=0.02)
    assert ei.value.process_ids == [0]


# ---------------------------------------------------------------------------
# interop with the JAX module, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_beats_cross_between_packages(tmp_path, writer):
    libs = {"jax": jax_cluster, "port": cluster}
    reader = "port" if writer == "jax" else "jax"
    src = libs[writer].HeartbeatStore(str(tmp_path), 3)
    beat = src.publish(42, "checkpoint")
    got = libs[reader].HeartbeatStore(str(tmp_path), 0).read(3)
    assert (got.process_id, got.step, got.wallclock, got.phase,
            got.extra) == (3, 42, beat.wallclock, "checkpoint", None)
    with open(os.path.join(str(tmp_path), "heartbeats",
                           "proc_3.json")) as f:
        assert list(json.load(f)) == ["process_id", "step", "wallclock",
                                      "phase", "extra"]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["shrink", "expand"])
def test_decisions_cross_between_packages(tmp_path, writer, kind):
    libs = {"jax": jax_cluster, "port": cluster}
    reader = "port" if writer == "jax" else "jax"
    fields = dict(epoch=3, world_size=2, restore_step=30, survivors=[0, 2],
                  kind=kind)
    libs[writer].RestartCoordinator(str(tmp_path / "a")).record(
        libs[writer].RestartDecision(**fields))
    got = libs[reader].RestartCoordinator(str(tmp_path / "a")).read()
    assert (got.epoch, got.world_size, got.restore_step, got.survivors,
            got.kind, got.source) == (3, 2, 30, [0, 2], kind, "disk")
    # The other package's coordinator writes the same bytes.
    libs[reader].RestartCoordinator(str(tmp_path / "b")).record(
        libs[reader].RestartDecision(**fields))
    for name in ("restart_decision.json", "restart_decision.json.sha256"):
        with open(tmp_path / "a" / name, "rb") as fa, \
                open(tmp_path / "b" / name, "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.mark.parametrize("corrupter", ["jax", "port"])
def test_corrupt_decision_reads_as_absent_in_both(tmp_path, corrupter):
    port_log, jax_log = FakeLogger(), FakeLogger()
    mon = _monitor(tmp_path, 0, n=2, logger=port_log)
    try:
        mon.coordinator.record(cluster.RestartDecision(
            epoch=1, world_size=2, restore_step=10, survivors=[0, 1]))
        if corrupter == "port":
            path = faults.corrupt_decision_file(mon)
        else:
            path = jax_faults.corrupt_decision_file(mon)
        assert path == mon.coordinator.path
        assert mon.coordinator.read() is None
        jax_coord = jax_cluster.RestartCoordinator(str(tmp_path),
                                                   log_fn=jax_log.log)
        assert jax_coord.read() is None
        for log in (port_log, jax_log):
            bad = [r for r in log.records if r["kind"] == "decision_corrupt"]
            assert len(bad) == 1 and "mismatch" in bad[0]["error"]
        # A bogus decision that would fence everyone is never adopted.
        mon.check_evicted(12)
    finally:
        mon.close()


# ---------------------------------------------------------------------------
# the watchdog: straggler vs. host loss, and its abort
# ---------------------------------------------------------------------------

def test_watchdog_classifies_straggler_then_dead(tmp_path):
    log = FakeLogger()
    mon = _monitor(tmp_path, 0, logger=log)
    peer = cluster.HeartbeatStore(str(tmp_path), 1)
    try:
        peer.publish(3, "train")
        mon.watchdog.arm(8)
        mon.watchdog.check_peers()
        assert [r for r in log.records if r["kind"] == "straggler"
                and r["process_id"] == 1 and r["behind_steps"] == 5]
        assert not mon.watchdog.dead_peers
        mon.watchdog.check_peers(now=time.time() + 1.0)
        assert mon.watchdog.dead_peers == {1}
        lost = [r for r in log.records if r["kind"] == "peer_lost"]
        assert lost and lost[0]["process_id"] == 1
        assert lost[0]["reason"] == "stale_heartbeat"
        with pytest.raises(cluster.PeerLostError) as ei:
            mon.begin_step(9)
        assert ei.value.process_ids == [1]
    finally:
        mon.close()


@pytest.mark.parametrize("peer_alive, verdict", [(True, "self_hang"),
                                                 (False, "peer_dead")])
def test_watchdog_aborts_wedged_seam(tmp_path, peer_alive, verdict):
    """Main thread presumed stuck in a collective past
    collective_timeout_s: the watchdog ends the process (stubbed here)
    after classifying it."""
    aborted = []
    log = FakeLogger()
    mon = cluster.ClusterMonitor(
        str(tmp_path), 0, 2, heartbeat_interval_s=0.05,
        straggler_after_s=0.05, peer_dead_after_s=0.3 if not peer_alive
        else 30.0, collective_timeout_s=0.5, logger=log,
        abort_fn=lambda v: aborted.append(v))
    peer = cluster.HeartbeatStore(str(tmp_path), 1)
    try:
        mon.watchdog.arm(4)
        deadline = time.time() + 5.0
        while not aborted and time.time() < deadline:
            if peer_alive:
                peer.publish(9, "train")
            time.sleep(0.05)
        assert aborted and aborted[0] == verdict
        assert any(r["kind"] == "peer_lost"
                   and r["reason"] == f"watchdog_abort_{verdict}"
                   for r in log.records)
    finally:
        mon.close()


def test_heartbeat_stall_freezes_beats(tmp_path):
    mon = _monitor(tmp_path, 0, n=1)
    try:
        mon.begin_step(5)
        mon.end_step(6)
        mon.stall_heartbeats()
        time.sleep(0.1)
        before = mon.store.read(0)
        time.sleep(0.2)
        assert mon.store.read(0).wallclock == before.wallclock
    finally:
        mon.close()


# ---------------------------------------------------------------------------
# eviction, shrink, chief succession
# ---------------------------------------------------------------------------

def test_eviction_fences_excluded_process(tmp_path):
    log = FakeLogger()
    mon = _monitor(tmp_path, 1, logger=log)
    try:
        mon.coordinator.record(cluster.RestartDecision(
            epoch=1, world_size=1, restore_step=20, survivors=[0]))
        with pytest.raises(cluster.EvictedError):
            mon.check_evicted(25)
        assert any(r["kind"] == "peer_lost" and r["reason"] == "evicted"
                   for r in log.records)
        mon.epoch = 0
        with pytest.raises(cluster.EvictedError):
            mon.await_restart(timeout_s=1.0)
    finally:
        mon.close()


def test_decide_restart_shrinks_world_and_enforces_min_hosts(tmp_path):
    mon = _monitor(tmp_path, 0, n=3, min_hosts=2)
    try:
        d = mon.decide_restart([2], restore_step=30)
        assert d.world_size == 2 and d.survivors == [0, 1]
        assert d.epoch == 1 and d.restore_step == 30 and d.source == "disk"
        mon.adopt(d)
        assert mon.world_size() == 2 and mon.epoch == 1
        with pytest.raises(cluster.PeerLostError, match="min_hosts"):
            mon.decide_restart([1], restore_step=30)
    finally:
        mon.close()


def test_chief_role_falls_to_lowest_live_process(tmp_path):
    mon = _monitor(tmp_path, 1, n=3)
    try:
        assert not mon.is_chief
        mon.watchdog.dead_peers.add(0)
        assert mon.is_chief
    finally:
        mon.close()


def test_from_config_is_off_without_cluster_dir(tmp_path):
    assert cluster.ClusterMonitor.from_config(ParallelConfig()) is None
    par = ParallelConfig(cluster_dir=str(tmp_path), num_processes=3,
                         process_id=2, min_hosts=2, cluster_lockstep=True,
                         elastic_expand=True)
    mon = cluster.ClusterMonitor.from_config(par)
    try:
        assert (mon.process_id, mon.live_set(), mon.min_hosts,
                mon.lockstep, mon.elastic_expand) == (2, [0, 1, 2], 2,
                                                      True, True)
    finally:
        mon.close()


def test_cluster_fields_default_as_jax():
    from dml_cnn_cifar10_tpu.config import ParallelConfig as JaxParallel
    from dml_cnn_cifar10_tpu.config import TrainConfig as JaxTrain
    for name in ("cluster_dir", "heartbeat_interval_s", "straggler_after_s",
                 "peer_dead_after_s", "collective_timeout_s", "min_hosts",
                 "elastic_expand", "cluster_lockstep",
                 "coordinator_timeout_s", "coordinator_retries"):
        assert getattr(ParallelConfig(), name) \
            == getattr(JaxParallel(), name), name
    for name in ("recovery_backoff_s", "recovery_backoff_max_s",
                 "retry_budget_window", "rollback_lr_scale", "supervise",
                 "recovery_retries"):
        assert getattr(TrainConfig(), name) == getattr(JaxTrain(), name), \
            name


# ---------------------------------------------------------------------------
# elastic scale-up
# ---------------------------------------------------------------------------

def test_rejoin_candidates_sees_fresh_rejoin_beats_only(tmp_path):
    mon = _monitor(tmp_path, 0, n=1)
    try:
        outsider = cluster.HeartbeatStore(str(tmp_path), 7)
        outsider.publish(0, "train")
        assert mon.rejoin_candidates() == []
        outsider.publish(0, "rejoin")
        assert mon.rejoin_candidates() == [7]
        cluster.HeartbeatStore(str(tmp_path), 0).publish(3, "rejoin")
        assert mon.rejoin_candidates() == [7]
    finally:
        mon.close()


def test_decide_expand_grows_world_with_monotone_epoch(tmp_path):
    mon = _monitor(tmp_path, 0, n=2)
    try:
        shrink = mon.decide_restart([1], restore_step=10)
        mon.adopt(shrink)
        assert mon.world_size() == 1 and shrink.kind == "shrink"
        d = mon.decide_expand([1], restore_step=10)
        assert d.kind == "expand" and d.epoch == 2
        assert d.survivors == [0, 1] and d.world_size == 2
        mon.adopt(d)
        assert mon.world_size() == 2 and mon.epoch == 2
        with pytest.raises(ValueError, match="monotone"):
            mon.coordinator.record(cluster.RestartDecision(
                epoch=2, world_size=2, restore_step=10, survivors=[0, 1]))
    finally:
        mon.close()


@pytest.mark.parametrize("expand", [True, False])
def test_rejoin_scan_raises_only_with_expand(tmp_path, expand):
    log = FakeLogger()
    mon = _monitor(tmp_path, 0, n=1, logger=log, elastic_expand=expand)
    try:
        cluster.HeartbeatStore(str(tmp_path), 1).publish(10, "rejoin")
        mon._last_rejoin_scan = 0.0
        if not expand:
            mon.begin_step(11)            # the shrink-only contract
            mon.end_step(12)
            return
        with pytest.raises(cluster.PeerRejoinError) as ei:
            mon.begin_step(11)
        assert ei.value.process_ids == [1]
        assert any(r["kind"] == "host_rejoin" and r["process_id"] == 1
                   for r in log.records)
    finally:
        mon.close()


def test_request_rejoin_and_await_inclusion(tmp_path):
    mon = _monitor(tmp_path, 1, n=2)
    try:
        mon.coordinator.record(cluster.RestartDecision(
            epoch=1, world_size=1, restore_step=10, survivors=[0]))
        mon.stall_heartbeats()
        mon.request_rejoin()
        assert mon.epoch == 1 and not mon._stalled
        assert mon.store.read(1).phase == "rejoin"
        with pytest.raises(cluster.PeerLostError, match="rejoin"):
            mon.await_inclusion(timeout_s=0.2, poll_s=0.02)
        mon.coordinator.record(cluster.RestartDecision(
            epoch=2, world_size=2, restore_step=10, survivors=[0, 1],
            kind="expand"))
        d = mon.await_inclusion(timeout_s=1.0)
        assert d.epoch == 2 and d.kind == "expand"
        mon.adopt(d)
        assert mon.world_size() == 2
    finally:
        mon.close()


def test_stale_epoch_mid_step_exits_via_clean_peer_lost(tmp_path):
    """A non-chief that sees a newer epoch that still includes it exits
    through peer_lost (empty process ids), and the supervisor adopts the
    pending decision instead of deciding its own."""
    log = FakeLogger()
    mon = _monitor(tmp_path, 1, n=2, logger=log)
    try:
        mon.coordinator.record(cluster.RestartDecision(
            epoch=1, world_size=2, restore_step=20, survivors=[0, 1],
            kind="expand"))
        with pytest.raises(cluster.PeerLostError) as ei:
            mon.check_evicted(25)
        assert ei.value.process_ids == []
        assert any(r["kind"] == "peer_lost" and r["reason"] == "stale_epoch"
                   for r in log.records)
        cfg = TrainConfig()
        cfg.parallel.num_processes = 2
        sup_log = FakeLogger()
        d = supervisor._coordinate_restart(cfg, mon, ei.value, sup_log, 1)
        assert d.epoch == 1 and mon.epoch == 1
        assert cfg.parallel.num_processes == 2
        assert [r["kind"] for r in sup_log.records] == ["elastic_expand"]
    finally:
        mon.close()


# ---------------------------------------------------------------------------
# the cluster fault kinds and the recovery-phase triggers
# ---------------------------------------------------------------------------

SPECS = ["heartbeat_stall@5,host_lost@9,collective_hang@12",
         "host_lost@15,host_return@18", "decision_corrupt@4,nan@4",
         "ckpt_corrupt@restore,data_stall@decide,host_lost@adopt",
         "heartbeat_stall@adopt,decision_corrupt@decide,sigterm@restore"]


@pytest.mark.parametrize("spec", SPECS)
def test_cluster_and_phase_specs_parse_as_jax(spec):
    got = faults.parse_fault_spec(spec)
    want = jax_faults.parse_fault_spec(spec)
    assert [(e.kind, e.step, e.phase) for e in got] \
        == [(e.kind, e.step, e.phase) for e in want]
    assert faults.format_fault_spec(got) \
        == jax_faults.format_fault_spec(want)


@pytest.mark.parametrize("bad", ["nan@restore", "collective_hang@adopt",
                                 "host_return@decide", "host_lost@later"])
def test_bad_phase_triggers_raise_as_jax(bad):
    with pytest.raises(ValueError):
        jax_faults.parse_fault_spec(bad)
    with pytest.raises(ValueError):
        faults.parse_fault_spec(bad)


@pytest.mark.parametrize("spec", ["heartbeat_stall@1", "collective_hang@1",
                                  "decision_corrupt@1", "host_return@0"])
def test_cluster_kinds_need_a_monitor(spec):
    with pytest.raises(faults.InjectedFault, match="cluster_dir"):
        faults.FaultInjector.from_spec(spec).step_hook(
            2, None, log_dir="/nonexistent")


def test_host_return_unblocks_on_rejoin_beat(tmp_path):
    mon = _monitor(tmp_path, 0, n=1)
    try:
        inj = faults.FaultInjector(faults.parse_fault_spec("host_return@5"))
        done = threading.Event()

        def run():
            inj.step_hook(5, "state", str(tmp_path), cluster=mon)
            done.set()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        time.sleep(0.15)
        assert not done.is_set()
        cluster.HeartbeatStore(str(tmp_path), 1).publish(0, "rejoin")
        assert done.wait(5.0)
        assert inj.pending() == []
    finally:
        mon.close()


def test_phase_hook_fires_at_its_seam_only(tmp_path):
    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    log_dir = str(tmp_path / "logs")
    os.makedirs(log_dir)
    for step in (10, 20):
        ckpt_lib.write_tree(log_dir, {"step": step}, step, keep=5)
    log = FakeLogger()
    inj = faults.FaultInjector.from_spec(
        "ckpt_corrupt@restore,data_stall@decide,nan@3")
    # @restore is gated on a recovery: a fresh run's restore never fires.
    inj.phase_hook("restore", log_dir, logger=log)
    assert [e.kind for e in inj.pending()] == ["nan", "data_stall",
                                               "ckpt_corrupt"]
    inj.recovering = True
    inj.phase_hook("restore", log_dir, logger=log)
    ok, reason = ckpt_lib.verify_checkpoint(
        os.path.join(log_dir, "ckpt_20.msgpack"))
    assert not ok and "mismatch" in reason
    with pytest.raises(faults.DataStallError):
        inj.phase_hook("decide", log_dir, logger=log)
    with pytest.raises(ValueError, match="unknown fault phase"):
        inj.phase_hook("train", log_dir)
    assert [(r["fault"], r["phase"]) for r in log.records] == [
        ("ckpt_corrupt", "restore"), ("data_stall", "decide")]
    assert [e.kind for e in inj.pending()] == ["nan"]


def test_ckpt_corrupt_at_restore_waits_for_a_fallback(tmp_path):
    """With one checkpoint there is nothing to fall back to: the drill
    stays pending, as in JAX."""
    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    ckpt_lib.write_tree(str(tmp_path), {"step": 10}, 10)
    inj = faults.FaultInjector.from_spec("ckpt_corrupt@restore")
    inj.recovering = True
    inj.phase_hook("restore", str(tmp_path))
    assert len(inj.pending()) == 1
    assert ckpt_lib.verify_checkpoint(
        os.path.join(str(tmp_path), "ckpt_10.msgpack"))[0]
