"""PyTorch port, the coordination transport (``parallel/net.py``) and its
network faults (``utils/netfaults.py``), on the CPU: JAX
``tests/test_net.py``'s transport tests (``:60-363``; not the router,
cell or loadgen ones, which belong to the fleet) run on the port's
modules, and the wire crosses between the packages both ways: a port
client against a JAX ``CoordServer`` and a JAX client against the
port's, with beats and restart decisions equal field for field, the
files on the server's disk the same, and a network fault armed over
``POST /fault`` holding the other package's client the same way.

The transport must degrade CLASSIFIED (``timeout`` / ``unreachable`` /
``http_<code>`` / ``proto``, never a hang) and every store contract over
it must read as *absence*, not error, so the liveness machinery (stale
beats, missing decisions) handles a partition without new failure
modes."""

import dataclasses
import json
import os
import time

import pytest

from dml_cnn_cifar10_tpu.parallel import cluster as jax_cluster
from dml_cnn_cifar10_tpu.parallel import net as jax_net
from dml_cnn_cifar10_tpu.utils import netfaults as jax_netfaults
from dml_cnn_cifar10_tpu_torch.parallel import cluster as cluster_lib
from dml_cnn_cifar10_tpu_torch.parallel import net as net_lib
from dml_cnn_cifar10_tpu_torch.utils import backoff
from dml_cnn_cifar10_tpu_torch.utils import faults as faults_lib
from dml_cnn_cifar10_tpu_torch.utils import netfaults


class FakeLogger:
    def __init__(self):
        self.records = []

    def log(self, kind, **fields):
        self.records.append({"kind": kind, **fields})

    def flush(self):
        pass

    def kinds(self):
        return [r["kind"] for r in self.records]


@pytest.fixture(autouse=True)
def _clean_netfaults():
    netfaults.clear()
    jax_netfaults.clear()
    yield
    netfaults.clear()
    jax_netfaults.clear()


@pytest.fixture
def served(tmp_path):
    """A CoordServer over a tmp dir + a loopback client for pid 0."""
    server = net_lib.CoordServer(str(tmp_path))
    client = net_lib.CoordClient(str(tmp_path), 0, timeout_s=2.0,
                                 retries=1)
    yield str(tmp_path), server, client
    server.stop()


# ---------------------------------------------------------------------------
# transport KV contract
# ---------------------------------------------------------------------------

def test_transport_kv_roundtrip_lands_on_serving_disk(served):
    root, server, client = served
    assert client.healthz()
    assert client.get("a/b.json") is None          # 404 → absent
    client.put("a/b.json", b'{"x": 1}')
    assert client.get("a/b.json") == b'{"x": 1}'
    # Same artifacts: the bytes land in the server's directory layout,
    # so tools/-side consumers stay transport-blind.
    with open(os.path.join(root, "a", "b.json"), "rb") as f:
        assert f.read() == b'{"x": 1}'
    client.put("a/c.json", b"2")
    assert sorted(client.list_dir("a")) == ["b.json", "c.json"]
    assert client.scan("a") == {"b.json": '{"x": 1}', "c.json": "2"}
    client.rename("a/c.json", "a/d.json")
    assert client.get("a/c.json") is None
    assert client.get("a/d.json") == b"2"
    client.delete("a/d.json")
    assert client.get("a/d.json") is None
    client.delete_tree("a")
    assert client.list_dir("a") == []


def test_transport_rejects_path_escape(served):
    _, _, client = served
    with pytest.raises(net_lib.TransportError) as e:
        client.get("../outside.txt")
    assert e.value.reason.startswith("http_")


def test_unreachable_classifies_and_stores_read_absent(tmp_path):
    """No server at the advertised address: every request classifies
    `unreachable` after its bounded budget; the store contracts map
    that to silence (None / {}), never an exception."""
    with open(os.path.join(str(tmp_path), net_lib.ADDR_FILENAME),
              "w") as f:
        json.dump({"host": "127.0.0.1", "port": 1}, f)
    client = net_lib.CoordClient(str(tmp_path), 0, timeout_s=0.3,
                                 retries=0, resolve_grace_s=0.0)
    with pytest.raises(net_lib.TransportError) as e:
        client.put("x", b"1")
    assert e.value.reason == "unreachable"
    store = net_lib.NetHeartbeatStore(str(tmp_path), 0, client)
    assert store.publish(1, "train") is not None   # swallowed, silent
    assert store.read(1) is None
    assert store.read_all() == {}
    assert not client.healthz()


def test_partition_classifies_timeout_within_bound(served):
    """An armed partition HOLDS the isolated pid's connections; the
    client-side socket timeout is the only thing that unsticks it —
    classified `timeout`, inside the budget, not a hang."""
    root, _, _ = served
    iso = net_lib.CoordClient(root, 7, timeout_s=0.3, retries=1)
    netfaults.arm("net_partition", [7], duration_s=30.0)
    t0 = time.time()
    with pytest.raises(net_lib.TransportError) as e:
        iso.get("anything")
    elapsed = time.time() - t0
    assert e.value.reason == "timeout"
    # 2 attempts x 0.3s + one bounded backoff sleep, with slack.
    assert elapsed < 3.0
    # Other pids sail through the same server.
    ok = net_lib.CoordClient(root, 3, timeout_s=2.0, retries=0)
    ok.put("fine", b"1")
    assert ok.get("fine") == b"1"


def test_partition_auto_heals(served):
    root, _, client = served
    netfaults.arm("net_partition", [0], duration_s=0.3)
    fast = net_lib.CoordClient(root, 0, timeout_s=0.2, retries=0)
    with pytest.raises(net_lib.TransportError):
        fast.get("x")
    time.sleep(0.4)
    assert netfaults.active() == []                # expired + pruned
    client.put("x", b"1")                          # healed: works again
    assert client.get("x") == b"1"


def test_net_telemetry_records_are_classified_and_rate_limited(served):
    root, _, _ = served
    log = FakeLogger()
    client = net_lib.CoordClient(root, 0, timeout_s=2.0, retries=0,
                                 log_fn=log.log)
    client.put("k", b"v")
    client.get("k")
    with open(os.path.join(root, net_lib.ADDR_FILENAME), "w") as f:
        json.dump({"host": "127.0.0.1", "port": 1}, f)
    bad = net_lib.CoordClient(root, 0, timeout_s=0.2, retries=0,
                              log_fn=log.log, resolve_grace_s=0.0)
    for _ in range(5):                             # rate-limited to 1
        with pytest.raises(net_lib.TransportError):
            bad.get("k")
    nets = [r for r in log.records if r["kind"] == "net"]
    assert all(set(("op", "ok", "ms", "attempts")) <= set(r)
               for r in nets)
    oks = [r for r in nets if r["ok"]]
    fails = [r for r in nets if not r["ok"]]
    assert oks and oks[0]["status"] == 200 and oks[0]["error"] is None
    assert len(fails) == 1                         # 5 failures, 1 record
    assert fails[0]["error"] == "unreachable"


# ---------------------------------------------------------------------------
# degraded-network drills: delay / drop / dup
# ---------------------------------------------------------------------------

def test_net_delay_adds_latency_inside_the_budget(served):
    root, _, client = served
    client.put("k", b"v")
    t0 = time.time()
    assert client.get("k") == b"v"
    base = time.time() - t0
    netfaults.arm("net_delay", [0], duration_s=5.0)
    t0 = time.time()
    assert client.get("k") == b"v"                 # slower, still fine
    assert time.time() - t0 >= base + 0.2


def test_net_drop_is_absorbed_by_the_retry_budget(served):
    """Drop 503s every 2nd request inside its window — the bounded
    retry budget absorbs it, so coordination completes unchanged."""
    assert netfaults.server_action(2) == ("ok",)
    netfaults.arm("net_drop", [2], duration_s=60.0)
    acts = [netfaults.server_action(2) for _ in range(6)]
    assert acts.count(("drop",)) == 3              # deterministic: 2nd
    root, _, _ = served
    client = net_lib.CoordClient(root, 2, timeout_s=2.0, retries=2)
    for i in range(6):
        client.put(f"k{i}", b"v")
        assert client.get(f"k{i}") == b"v"


def test_net_dup_is_harmless_under_atomic_commit(served):
    root, _, _ = served
    netfaults.arm("net_dup", [4], duration_s=60.0)
    client = net_lib.CoordClient(root, 4, timeout_s=2.0, retries=0)
    client.put("dup.json", b"payload")
    assert client.get("dup.json") == b"payload"
    with open(os.path.join(root, "dup.json"), "rb") as f:
        assert f.read() == b"payload"


def test_netfaults_unknown_kind_fails_loudly():
    with pytest.raises(ValueError):
        netfaults.arm("net_typo", [0])


# ---------------------------------------------------------------------------
# store contracts over the transport
# ---------------------------------------------------------------------------

def test_net_heartbeat_store_matches_file_store(served):
    root, _, client = served
    net_store = net_lib.NetHeartbeatStore(root, 0, client)
    net_store.publish(5, "train", extra={"port": 9, "cell": "cella"})
    # The file store over the SAME dir sees the beat — same artifacts.
    file_store = cluster_lib.HeartbeatStore(root, 1)
    file_store.publish(3, "serve")
    beats = net_store.read_all()
    assert set(beats) == {0, 1}
    assert beats[0].step == 5 and beats[0].phase == "train"
    assert beats[0].extra == {"port": 9, "cell": "cella"}
    assert net_store.read(1).step == 3
    file_beats = file_store.read_all()
    assert set(file_beats) == {0, 1} and file_beats[0].step == 5
    assert net_store.read_peers([0, 1]).keys() == {1}


def test_beat_decode_error_classified_on_both_transports(served):
    """A torn/corrupt beat file reads as ABSENT for that poll with a
    classified beat_decode_error record — on the file store and on the
    net store — so a flaky writer degrades to a stale heartbeat, never
    a monitor crash."""
    root, _, client = served
    log = FakeLogger()
    client.put("heartbeats/proc_2.json", b'{"torn')
    good = net_lib.NetHeartbeatStore(root, 0, client, log_fn=log.log)
    good.publish(1, "train")
    beats = good.read_all()
    assert set(beats) == {0}                       # torn one skipped
    nerrs = [r for r in log.records
             if r["kind"] == "beat_decode_error"]
    assert nerrs and "proc_2" in nerrs[0]["path"] and nerrs[0]["error"]

    flog = FakeLogger()
    fstore = cluster_lib.HeartbeatStore(root, 1, log_fn=flog.log)
    assert set(fstore.read_all()) == {0}
    ferrs = [r for r in flog.records
             if r["kind"] == "beat_decode_error"]
    assert ferrs and "proc_2" in ferrs[0]["path"]


def _decision(epoch, survivors=(0,)):
    return cluster_lib.RestartDecision(
        epoch=epoch, world_size=len(survivors), restore_step=10,
        survivors=list(survivors), kind="shrink", source="disk")


def test_net_coordinator_sidecar_monotone_and_corruption(served):
    root, _, client = served
    log = FakeLogger()
    coord = net_lib.NetRestartCoordinator(root, client, log_fn=log.log)
    assert coord.read() is None
    coord.record(_decision(1, (0, 1)))
    d = coord.read()
    assert d.epoch == 1 and d.survivors == [0, 1]
    # The decision + sidecar land in the file coordinator's layout.
    assert os.path.exists(os.path.join(root, "restart_decision.json"))
    # Decision race, included seat: a re-record at a stale epoch ADOPTS
    # the committed decision instead of racing (or crashing on) it.
    adopted = coord.record(_decision(1, (0,)))
    assert adopted.epoch == 1 and adopted.survivors == [0, 1]
    # Decision race, excluded seat (the healed partition minority):
    # the committed file wins — classified eviction, fence/rejoin.
    loser = net_lib.NetRestartCoordinator(
        root, net_lib.CoordClient(root, 9, timeout_s=2.0, retries=0))
    with pytest.raises(cluster_lib.EvictedError) as race:
        loser.record(_decision(1, (9,)))
    assert "decision race lost" in str(race.value)
    # Corrupt the payload under a stale sidecar: the digest check
    # classifies it and the decision reads as ABSENT, never adopted.
    client.put("restart_decision.json", b'{"epoch": 99}')
    assert coord.read() is None
    assert "decision_corrupt" in log.kinds()
    # await_decision's bounded poll degrades to the classified
    # coordinator-lost failure on absence — same contract as the file
    # coordinator, never a hang.
    with pytest.raises(cluster_lib.PeerLostError):
        coord.await_decision(2, timeout_s=0.2)


def test_record_under_partition_raises_evicted(served):
    """A host that cannot reach coordination must not believe its own
    restart decision: record() maps the classified transport failure to
    EvictedError — the fence (or, under --elastic_expand, the rejoin
    request) the supervisor already knows how to run."""
    root, _, _ = served
    client = net_lib.CoordClient(root, 3, timeout_s=0.2, retries=0)
    coord = net_lib.NetRestartCoordinator(root, client)
    netfaults.arm("net_partition", [3], duration_s=30.0)
    with pytest.raises(cluster_lib.EvictedError) as e:
        coord.record(_decision(1, (3,)))
    assert "fencing" in str(e.value)
    assert coord.read() is None                    # reads: silence


# ---------------------------------------------------------------------------
# decision adoption under a slow store (satellite: bounded re-read)
# ---------------------------------------------------------------------------

class _SlowChasingCoordinator:
    """read() is slow AND returns an ever-newer epoch each call — the
    worst case for the seam check: a chief writing again while we read."""

    def __init__(self, start_epoch, survivors, sleep_s=0.05,
                 chase=True):
        self.epoch = start_epoch
        self.survivors = survivors
        self.sleep_s = sleep_s
        self.chase = chase
        self.reads = 0

    def read(self):
        self.reads += 1
        time.sleep(self.sleep_s)
        d = _decision(self.epoch, self.survivors)
        if self.chase:
            self.epoch += 1
        return d


class _Disarmable:
    def disarm(self):
        pass


def test_check_evicted_bounded_rereads_under_slow_chasing_store():
    """The included-at-a-newer-epoch seam path re-reads the decision
    with BOUNDED backoff (3 re-reads, utils/backoff.py) and then acts —
    a store that is slow and perpetually newer must not turn the seam
    check into a hang."""
    log = FakeLogger()
    stub = type("Stub", (), {})()
    stub.coordinator = _SlowChasingCoordinator(5, [0, 1])
    stub.epoch = 1
    stub.process_id = 0
    stub.log = log.log
    stub.watchdog = _Disarmable()
    t0 = time.time()
    with pytest.raises(cluster_lib.PeerLostError):
        cluster_lib.ClusterMonitor.check_evicted(stub, step=20)
    elapsed = time.time() - t0
    # Initial read + exactly 3 bounded re-reads, never more.
    assert stub.coordinator.reads == 1 + 3
    # Sleeps are the pinned plan: delay_s(0.02, 0.2, 1..3) + 4 slow
    # reads — comfortably under a second, nowhere near a poll loop.
    budget = sum(backoff.delay_s(0.02, 0.2, a) for a in (1, 2, 3))
    assert elapsed < budget + 4 * 0.05 + 1.0
    assert log.records[-1]["reason"] == "stale_epoch"


def test_check_evicted_settles_early_when_epoch_stabilizes():
    log = FakeLogger()
    stub = type("Stub", (), {})()
    stub.coordinator = _SlowChasingCoordinator(5, [1], chase=False)
    stub.epoch = 1
    stub.process_id = 0                            # excluded → fence
    stub.log = log.log
    stub.watchdog = _Disarmable()
    with pytest.raises(cluster_lib.EvictedError):
        cluster_lib.ClusterMonitor.check_evicted(stub, step=20)
    assert stub.coordinator.reads == 1             # no re-read churn
    assert log.records[-1]["reason"] == "evicted"


# ---------------------------------------------------------------------------
# the port's own surface: the module copy, the fault kinds over the wire
# ---------------------------------------------------------------------------

def test_netfaults_constants_are_the_jax_modules():
    for name in ("NET_FAULT_KINDS", "PARTITION_HEAL_S",
                 "DELAY_PER_REQUEST_S", "DELAY_WINDOW_S", "DROP_WINDOW_S",
                 "DUP_WINDOW_S"):
        assert getattr(netfaults, name) == getattr(jax_netfaults, name)
    assert faults_lib.NET_FAULT_KINDS == netfaults.NET_FAULT_KINDS
    for name in ("ADDR_FILENAME", "PROC_HEADER", "RESOLVE_GRACE_S"):
        assert getattr(net_lib, name) == getattr(jax_net, name)


@pytest.mark.parametrize("kind", ["net_partition", "net_delay", "net_drop",
                                  "net_dup"])
def test_net_fault_injection_arms_the_server_for_this_process(served,
                                                              kind):
    """``kind@N`` POSTs the fault to the coordination service, isolating
    the injecting process, and logs the armed window (JAX
    ``utils/faults.py:624-641``)."""
    root, _, _ = served
    log = FakeLogger()
    fake = type("Seat", (), {})()
    fake.process_id = 5
    fake.net_client = net_lib.CoordClient(root, 5, timeout_s=2.0,
                                          retries=0)
    inj = faults_lib.FaultInjector.from_spec(f"{kind}@3")
    inj.step_hook(2, None, root, logger=log, cluster=fake)
    assert netfaults.active() == []
    inj.step_hook(3, None, root, logger=log, cluster=fake)
    assert inj.pending() == []
    armed = netfaults.active()
    assert [(f["kind"], f["isolate"]) for f in armed] == [(kind, [5])]
    assert armed[0]["duration_s"] == netfaults._DURATIONS[kind]
    rec = [r for r in log.records if r["kind"] == "fault"]
    assert rec == [{"kind": "fault", "step": 3, "fault": kind,
                    "injected": True, "isolate": [5],
                    "duration_s": netfaults._DURATIONS[kind]}]


def test_net_fault_needs_the_net_transport(tmp_path):
    mon = cluster_lib.ClusterMonitor(str(tmp_path), 0, 1)
    try:
        for spec in ("net_partition@1", "net_dup@1"):
            with pytest.raises(faults_lib.InjectedFault,
                               match="cluster_transport net"):
                faults_lib.FaultInjector.from_spec(spec).step_hook(
                    1, None, str(tmp_path), cluster=mon)
        with pytest.raises(faults_lib.InjectedFault):
            faults_lib.FaultInjector.from_spec("net_drop@1").step_hook(
                1, None, str(tmp_path))
    finally:
        mon.close()


def test_monitor_over_net_hosts_on_process_0_and_closes(tmp_path):
    """``transport="net"``: process 0 serves the directory and talks to
    itself over loopback; process 1 is a client only; their beats and
    the decision land on the served disk in the file layout."""
    root = str(tmp_path)
    # No background beat between end_step(5) and the read: the read
    # sees the beat of begin_step(4).
    m0 = cluster_lib.ClusterMonitor(root, 0, 2, heartbeat_interval_s=60.0,
                                    transport="net", net_timeout_s=2.0)
    m1 = cluster_lib.ClusterMonitor(root, 1, 2, heartbeat_interval_s=60.0,
                                    transport="net", net_timeout_s=2.0)
    try:
        assert m0.net_server is not None and m1.net_server is None
        assert isinstance(m1.store, net_lib.NetHeartbeatStore)
        m1.begin_step(4)
        m1.end_step(5)
        assert m0.store.read(1).step == 4
        assert os.path.isfile(os.path.join(root, "heartbeats",
                                           "proc_1.json"))
        d = m0.decide_restart([1], 0)
        assert (d.epoch, d.survivors, d.source) == (1, [0], "disk")
        assert cluster_lib.RestartCoordinator(root).read() == d
        with pytest.raises(ValueError, match="transport"):
            cluster_lib.ClusterMonitor(root, 2, 3, transport="udp")
    finally:
        m1.close()
        m0.close()
    assert not m0.net_server._thread.is_alive()


# ---------------------------------------------------------------------------
# the wire across the packages
# ---------------------------------------------------------------------------

SIDES = {"port": (net_lib, cluster_lib), "jax": (jax_net, jax_cluster)}
PAIRS = [("port", "jax"), ("jax", "port")]


@pytest.fixture
def crossed(tmp_path, request):
    """A server of one package and a client of the other over one
    directory: ``(root, client side, server side, client)``."""
    client_side, server_side = request.param
    server = SIDES[server_side][0].CoordServer(str(tmp_path))
    client = SIDES[client_side][0].CoordClient(str(tmp_path), 1,
                                               timeout_s=2.0, retries=1)
    yield str(tmp_path), client_side, server_side, client
    server.stop()


@pytest.mark.parametrize("crossed", PAIRS, indirect=True,
                         ids=["port_client-jax_server",
                              "jax_client-port_server"])
def test_kv_contract_across_packages(crossed):
    root, _, _, client = crossed
    assert client.healthz()
    assert client.get("a/b.json") is None
    client.put("a/b.json", b'{"x": 1}')
    with open(os.path.join(root, "a", "b.json"), "rb") as f:
        assert f.read() == b'{"x": 1}'
    client.put("a/c.json", b"2")
    assert client.scan("a") == {"b.json": '{"x": 1}', "c.json": "2"}
    client.rename("a/c.json", "a/d.json")
    assert sorted(client.list_dir("a")) == ["b.json", "d.json"]
    client.delete_tree("a")
    assert client.list_dir("a") == []
    with pytest.raises(OSError) as e:
        client.get("../outside.txt")
    assert e.value.reason == "http_400"


@pytest.mark.parametrize("crossed", PAIRS, indirect=True,
                         ids=["port_client-jax_server",
                              "jax_client-port_server"])
def test_beats_and_decisions_equal_field_for_field(crossed):
    """A beat and a decision written through one package's client read
    back through the other package's stores, field for field, and the
    server's files read the same through either package's file store."""
    root, cside, sside, client = crossed
    cnet, ccl = SIDES[cside]
    snet, scl = SIDES[sside]
    beat = cnet.NetHeartbeatStore(root, 1, client).publish(
        7, "train", extra={"replica_step": 10})
    other = snet.CoordClient(root, 0, timeout_s=2.0, retries=0)
    got = snet.NetHeartbeatStore(root, 0, other).read(1)
    assert dataclasses.asdict(got) == dataclasses.asdict(beat)
    for cl in (cluster_lib, jax_cluster):
        assert dataclasses.asdict(cl.HeartbeatStore(root, 0).read(1)) \
            == dataclasses.asdict(beat)
    decision = ccl.RestartDecision(epoch=1, world_size=1, restore_step=10,
                                   survivors=[1], kind="shrink",
                                   source="peer")
    cnet.NetRestartCoordinator(root, client).record(decision)
    back = snet.NetRestartCoordinator(root, other).read()
    assert dataclasses.asdict(back) == dataclasses.asdict(decision)
    for cl in (cluster_lib, jax_cluster):
        assert dataclasses.asdict(cl.RestartCoordinator(root).read()) \
            == dataclasses.asdict(decision)


@pytest.mark.parametrize("crossed", PAIRS, indirect=True,
                         ids=["port_client-jax_server",
                              "jax_client-port_server"])
def test_partition_armed_over_the_wire_holds_the_other_package(crossed):
    """``POST /fault`` from one package arms the other package's server:
    the isolated process's requests time out, classified, inside the
    bound, and the fault heals."""
    root, cside, _, client = crossed
    ack = client.post_fault("net_partition", isolate=[1], duration_s=0.8)
    assert ack["kind"] == "net_partition" and ack["isolate"] == [1]
    fast = SIDES[cside][0].CoordClient(root, 1, timeout_s=0.2, retries=0)
    t0 = time.time()
    with pytest.raises(OSError) as e:
        fast.get("x")
    assert e.value.reason == "timeout" and time.time() - t0 < 2.0
    time.sleep(1.0)
    client.put("x", b"1")
    assert client.get("x") == b"1"
