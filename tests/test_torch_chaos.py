"""PyTorch port, the chaos oracle (``dml_cnn_cifar10_tpu_torch/tools/
chaos.py``) and its sampler (``utils/faults.py:FaultSchedule``) on the CPU.

- ``FaultSchedule.generate(seed, budget)`` gives the JAX sampler's spec
  strings for seeds 0-19, budgets 1-4, in every vocabulary (the runtime
  one included: it is data), and the vocabularies are the JAX module's.
- Phase-qualified specs round-trip through the parser and the formatter
  in the JAX order; compound faults at one step fire in spec order.
- One module-scoped spawn runs, after the shared fault-free reference,
  four campaigns side by side (JAX ``tests/test_chaos.py:261-386``): the
  ``train`` smoke over fixed seeds 0-4 holds every invariant and its
  ``chaos`` / ``chaos_done`` stream lints strict; the
  ``no_decision_sidecar`` plant fails its schedule and shrinks it to its
  ``decision_corrupt`` core while the same schedule passes unplanted;
  and one ``peer_recovery`` schedule (``replica_corrupt@14`` before the
  backbone ``host_lost@15``) holds its invariants, the replica fault
  answered by a ``peer_replica`` record.
- The scenarios and plant that need the unified runtime or the autopilot
  raise ``NotImplementedError`` naming ROADMAP items 6 and 9.
"""

import concurrent.futures
import json
import os

import pytest

from dml_cnn_cifar10_tpu.utils import faults as jax_faults
from dml_cnn_cifar10_tpu_torch.tools import chaos as chaos_lib
from dml_cnn_cifar10_tpu_torch.utils import faults as faults_lib

VOCABULARIES = ("CHAOS_VOCABULARY", "CHAOS_CLUSTER_VOCABULARY",
                "CHAOS_EXPAND_VOCABULARY", "CHAOS_PEER_VOCABULARY",
                "CHAOS_RUNTIME_VOCABULARY", "CHAOS_NET_VOCABULARY")
SMOKE_SEEDS = range(5)
PLANTED_SPEC = "data_stall@12,decision_corrupt@18"


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("vocab", VOCABULARIES)
def test_fault_schedules_are_the_jax_samplers(vocab):
    assert getattr(faults_lib, vocab) == getattr(jax_faults, vocab)
    for budget in (1, 2, 3, 4):
        for seed in range(20):
            kw = dict(vocabulary=getattr(faults_lib, vocab), max_step=35)
            got = faults_lib.FaultSchedule.generate(seed, budget, **kw)
            want = jax_faults.FaultSchedule.generate(
                seed, budget, vocabulary=getattr(jax_faults, vocab),
                max_step=35)
            assert got.spec == want.spec, (vocab, budget, seed)
            assert got.seed == seed and 1 <= len(got.events) <= budget
    with pytest.raises(ValueError):
        faults_lib.FaultSchedule.generate(0, 0)


def test_phase_qualified_spec_parses_and_round_trips():
    spec = ("decision_corrupt@decide,ckpt_corrupt@restore,nan@15,"
            "ckpt_corrupt@15,replica_stale@12,net_dup@3")
    events = faults_lib.parse_fault_spec(spec)
    assert [(e.kind, e.trigger) for e in events] == [
        ("net_dup", "3"), ("replica_stale", "12"), ("ckpt_corrupt", "15"),
        ("nan", "15"), ("decision_corrupt", "decide"),
        ("ckpt_corrupt", "restore")]
    assert faults_lib.format_fault_spec(events) == \
        jax_faults.format_fault_spec(jax_faults.parse_fault_spec(spec))
    assert faults_lib.parse_fault_spec(
        faults_lib.format_fault_spec(events)) == events
    for bad in ("nan@restore", "collective_hang@adopt", "host_return@decide",
                "net_partition@restore", "replica_corrupt@adopt",
                "nan@bogusphase"):
        with pytest.raises(ValueError):
            faults_lib.parse_fault_spec(bad)
        with pytest.raises(ValueError):
            jax_faults.parse_fault_spec(bad)


def test_compound_faults_fire_at_one_step():
    records = []
    logger = type("L", (), {"log": lambda self, kind, **f: records.append(
        {"kind": kind, **f})})()
    inj = faults_lib.FaultInjector.from_spec("ckpt_corrupt@10,data_stall@10")
    with pytest.raises(faults_lib.DataStallError):
        inj.step_hook(10, None, "/nonexistent", logger=logger)
    assert [e.kind for e in inj.pending()] == ["ckpt_corrupt"]
    assert [r["fault"] for r in records] == ["data_stall"]


@pytest.mark.parametrize("what", ["runtime", "autopilot",
                                  "no_autopilot_policy"])
def test_unported_scenarios_and_plant_refuse(tmp_path, what):
    match = "Queue 1 item 9" if what == "no_autopilot_policy" \
        else "Queue 1 item 6"
    with pytest.raises(NotImplementedError, match=match):
        if what.startswith("no_"):
            chaos_lib.ChaosHarness(str(tmp_path), plant=what)
        else:
            chaos_lib.run_campaign([0], what, str(tmp_path))
    with pytest.raises(NotImplementedError):
        chaos_lib.main(["--plant" if what.startswith("no_")
                        else "--scenario", what, "--workdir",
                        str(tmp_path)])


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    """The shared reference, then four campaigns on four threads (each
    runs its simulations as subprocesses on the CPU)."""
    work = tmp_path_factory.mktemp("chaos")
    harness = chaos_lib.ChaosHarness(str(work / "refs"), device="cpu",
                                     verbose=False)
    harness.reference_digest()
    refs = harness._refs
    common = dict(refs=refs, device="cpu", verbose=False)
    jobs = {
        "smoke": dict(seeds=SMOKE_SEEDS, scenario="train",
                      workdir=str(work / "smoke"),
                      metrics_jsonl=str(work / "smoke.jsonl")),
        "planted": dict(seeds=[0], scenario="train",
                        workdir=str(work / "planted"),
                        plant="no_decision_sidecar",
                        explicit_spec=PLANTED_SPEC),
        "unplanted": dict(seeds=[0], scenario="train",
                          workdir=str(work / "unplanted"),
                          explicit_spec=PLANTED_SPEC),
        "peer": dict(seeds=[0], scenario="peer_recovery",
                     workdir=str(work / "peer"),
                     metrics_jsonl=str(work / "peer.jsonl"),
                     explicit_spec="replica_corrupt@14"),
    }
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(chaos_lib.run_campaign, **job,
                                     **common)
                   for name, job in jobs.items()}
        out = {name: f.result() for name, f in futures.items()}
    out["work"] = work
    return out


def test_smoke_campaign_fixed_seeds_holds_every_invariant(campaigns):
    from tools import check_jsonl_schema
    summary = campaigns["smoke"]
    assert summary["schedules"] == len(SMOKE_SEEDS)
    assert summary["failed"] == 0, summary
    assert [r["spec"] for r in summary["results"]] == [
        jax_faults.FaultSchedule.generate(
            seed, 3, max_step=35).spec for seed in SMOKE_SEEDS]
    assert len(summary["faults_by_kind"]) >= 2
    assert sum(summary["faults_by_kind"].values()) >= 5
    path = str(campaigns["work"] / "smoke.jsonl")
    assert check_jsonl_schema.check_file(path, strict=True) == []
    kinds = [r["kind"] for r in _read_jsonl(path)]
    assert kinds == ["chaos"] * len(SMOKE_SEEDS) + ["chaos_done"]


def test_planted_decision_sidecar_revert_is_caught_and_shrunk(campaigns):
    summary = campaigns["planted"]
    assert summary["failed"] == 1
    rec = summary["results"][0]
    assert not rec["ok"] and rec["invariant"].startswith("completed")
    repro = faults_lib.parse_fault_spec(rec["reproducer"])
    assert [e.kind for e in repro] == ["decision_corrupt"]
    # The same schedule passes with the hardening in place.
    assert campaigns["unplanted"]["failed"] == 0, campaigns["unplanted"]


def test_peer_recovery_schedule_holds_its_invariants(campaigns):
    from tools import check_jsonl_schema
    summary = campaigns["peer"]
    assert summary["failed"] == 0, summary
    assert summary["faults_by_kind"] == {"replica_corrupt": 1,
                                         "host_lost": 1}
    assert check_jsonl_schema.check_file(
        str(campaigns["work"] / "peer.jsonl"), strict=True) == []
    stream = _read_jsonl(os.path.join(
        str(campaigns["work"] / "peer"), "run_001_seed0", "logs_0",
        "metrics.jsonl"))
    answers = [r["op"] for r in stream if r["kind"] == "peer_replica"
               and r["op"] in ("reconstruct", "fallback")]
    assert answers == ["fallback"]
    restart = [r for r in stream if r["kind"] == "elastic_restart"]
    assert restart and restart[0]["source"] == "peer"
