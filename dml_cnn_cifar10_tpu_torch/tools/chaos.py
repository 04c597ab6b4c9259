#!/usr/bin/env python
"""Chaos oracle of the port: seeded compound-fault schedules through the
port's supervised simulations, with invariant checking and a greedy
shrink of a failing schedule to a minimal ``--fault_spec``.

The port's copy of ``tools/chaos.py``. ``FaultSchedule.generate(seed,
budget)`` (``utils/faults.py``) samples schedules (several faults at one
step, faults that strike inside a recovery such as
``ckpt_corrupt@restore`` or ``decision_corrupt@decide``, corruption of
the coordination state itself; a seed names the JAX sampler's schedule)
and each runs through one of the port's simulations, whose workers drive
``train.supervisor.fit_supervised`` on the card, or on the CPU with
``--device cpu``:

- ``train`` — one supervised process;
- ``cluster`` — two lockstep processes, ``host_lost@15`` on process 1;
- ``expand`` — the 2→1→2 elastic drill (process 1 dies at 15 and is
  respawned once the survivor has shrunk; process 0 holds step 18 until
  it announces its rejoin);
- ``peer_recovery`` — ``cluster`` with ``--peer_redundancy`` on and the
  replica faults in the vocabulary;
- ``net_partition`` — two processes over ``--cluster_transport net``:
  process 1 cut off at 15 (``net_partition@15``), process 0 (the
  coordination service's host, fuzzed with delay/drop/dup) holding 18
  until the healed process rejoins.

After every run the invariants are checked:

- **bit_identical** — the final parameters equal the fault-free
  reference run's, bit for bit (the exact-resume contract, compounded;
  every scenario is a replica of the one-process run, so one reference
  serves them all);
- **completed** — the run reaches its last step and exits 0, never
  fenced (a backbone corpse excepted, which must exit with the
  ``host_lost`` code);
- **schema** — every process's stream passes ``tools/check_jsonl_
  schema.py --strict`` (stdlib only);
- **deadline** — no process outlives the per-run deadline;
- **fault_pairing** — every step-triggered scheduled fault appears as an
  ``injected`` ``fault`` record, every detected failure and every
  recovery-provoking injection has a later ``recovery`` record, and a
  replica fault that an elastic restart read is answered by a
  ``peer_replica`` ``reconstruct`` or ``fallback`` record.

A failing schedule is shrunk (greedy one-fault removal) to a minimal
reproducer. The campaign writes ``chaos`` records (one a schedule) and a
``chaos_done`` summary to ``--metrics_jsonl``.

Plants (``--plant``) revert one piece of hardening inside the workers, so
a campaign can prove it catches the regression: ``no_decision_sidecar``
(the restart decision read without its sha256 sidecar: a corrupted
decision is adopted and fences the run) and ``no_net_timeout`` (the net
client's socket timeout stripped: a partition's held request hangs to the
deadline; run it with a smaller ``--deadline_s``).

Not ported: the JAX oracle's ``runtime`` and ``autopilot`` scenarios and
the ``no_autopilot_policy`` plant (they need the unified runtime and the
autopilot, ROADMAP.md Queue 1 items 6 and 9), and its fleet simulations
in a ``net_partition`` campaign (the serving fleet, item 6).

Usage::

    python -m dml_cnn_cifar10_tpu_torch.tools.chaos --seeds 5 \\
        --scenario train --device cpu
    python -m dml_cnn_cifar10_tpu_torch.tools.chaos --seeds 1 \\
        --scenario peer_recovery --spec replica_corrupt@14
    python -m dml_cnn_cifar10_tpu_torch.tools.chaos --seeds 1 \\
        --scenario train --plant no_decision_sidecar \\
        --spec data_stall@12,decision_corrupt@18 --device cpu

Exit 1 when any schedule violates an invariant.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from dml_cnn_cifar10_tpu_torch.utils import faults as faults_lib
from dml_cnn_cifar10_tpu_torch.utils.logging import MetricsLogger

#: The repository root: the workers import the port from it, and the
#: schema lint is its stdlib-only ``tools/check_jsonl_schema.py``.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: Fault kinds whose injection must provoke a recovery (they raise or
#: poison the run); the others corrupt state that may or may not be read
#: later, and surviving them unnoticed is legitimate.
RECOVERY_PROVOKING = ("nan", "data_stall")

#: Scenarios of the JAX oracle that need what the port does not have yet.
UNPORTED = {
    "runtime": "the unified runtime (--mode run; ROADMAP.md Queue 1 item 6)",
    "autopilot": "the unified runtime (ROADMAP.md Queue 1 item 6) and "
                 "the autopilot (Queue 1 item 9)",
    "no_autopilot_policy": "the autopilot (ROADMAP.md Queue 1 item 9)",
}

#: Named planted regressions: Python the worker runs to REVERT one piece
#: of hardening.
PLANTS = {
    # The RestartCoordinator's sha256-sidecar check reverted: a corrupted
    # decision (bogus epoch, no survivors) is adopted instead of
    # classified, the run fences itself, bit-identity and completion fail.
    "no_decision_sidecar": """
from dml_cnn_cifar10_tpu_torch.parallel import cluster as _cl
def _legacy_read(self):
    import json as _json
    try:
        with open(self.path) as f:
            return _cl.RestartDecision(**_json.load(f))
    except (OSError, ValueError, TypeError):
        return None
_cl.RestartCoordinator.read = _legacy_read
""",
    # The net client's per-request timeout stripped: a partition's held
    # connection is a hang instead of a classified timeout.
    "no_net_timeout": """
from dml_cnn_cifar10_tpu_torch.parallel import net as _net
_orig_request = _net.CoordClient._request
def _unbounded_request(self, method, path, body=None,
                       timeout_s=_net._DEFAULT):
    return _orig_request(self, method, path, body=body, timeout_s=None)
_net.CoordClient._request = _unbounded_request
""",
}

# One worker script serves every scenario (the JAX oracle's run: 256/64
# synthetic records, batch 32, lr 0.05, checkpoints every 10 steps).
WORKER = """
import hashlib, json, os, sys
import torch
device = os.environ.get("DML_CHAOS_DEVICE", "cuda")
if device == "cpu":
    torch.set_num_threads(1)
task, n, data_dir, log_dir, cluster_dir, fault_spec, total_steps = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    sys.argv[5], sys.argv[6], int(sys.argv[7]))
from dml_cnn_cifar10_tpu_torch.config import DataConfig, TrainConfig
from dml_cnn_cifar10_tpu_torch.train.supervisor import fit_supervised
if os.environ.get("DML_CHAOS_PLANT"):
    exec(os.environ["DML_CHAOS_PLANT_CODE"])

cfg = TrainConfig(
    batch_size=32, total_steps=total_steps, output_every=10,
    eval_every=20, checkpoint_every=10, log_dir=log_dir,
    metrics_jsonl=f"{log_dir}/metrics.jsonl", device=device,
    data=DataConfig(dataset="synthetic", data_dir=data_dir,
                    synthetic_train_records=256, synthetic_test_records=64,
                    normalize="scale"))
cfg.model.logit_relu = False
cfg.optim.learning_rate = 0.05
cfg.keep_checkpoints = 20
cfg.check_numerics = True
cfg.on_nonfinite = "rollback"
cfg.recovery_retries = 8        # a compound schedule may spend several
cfg.recovery_backoff_s = 0.05
cfg.recovery_backoff_max_s = 0.2
cfg.fault_spec = fault_spec or None
cfg.parallel.process_id = task
cfg.parallel.num_processes = n
if cluster_dir:
    cfg.parallel.cluster_dir = cluster_dir
    cfg.parallel.cluster_lockstep = n > 1
    cfg.parallel.peer_redundancy = bool(
        os.environ.get("DML_CHAOS_PEER")) and n > 1
    # The multi-seat sims may re-admit returning hosts; the one-process
    # scenario keeps the fence, so an adopted bogus decision fails fast.
    cfg.parallel.elastic_expand = n > 1
    cfg.parallel.heartbeat_interval_s = 0.1
    cfg.parallel.straggler_after_s = 0.4
    cfg.parallel.peer_dead_after_s = float(os.environ["DML_CHAOS_DEAD_S"])
    cfg.parallel.collective_timeout_s = 300.0
    if os.environ.get("DML_CHAOS_NET"):
        cfg.parallel.cluster_transport = "net"
        cfg.parallel.net_timeout_s = 0.5
        cfg.parallel.net_retries = 2
res = fit_supervised(cfg, task_index=task)
if res is None:
    print("RESULT " + json.dumps({"task": task, "fenced": True}))
    sys.exit(0)
h = hashlib.sha256()
for name in sorted(res.state.params):
    h.update(res.state.params[name].detach().cpu().contiguous().numpy()
             .tobytes())
print("RESULT " + json.dumps({
    "task": task, "fenced": False, "final_step": res.final_step,
    "digest": h.hexdigest()}))
"""

#: The cluster scenarios' backbone on process 1: an abrupt death at 15,
#: one boundary past the step-10 checkpoint.
CLUSTER_BACKBONE = "host_lost@15"

#: The expand scenario's choreography: process 1 dies at 15, process 0
#: holds 18 until the respawned process announces its rejoin.
EXPAND_BACKBONE = "host_lost@15"
EXPAND_HOLD = "host_return@18"

#: The net_partition scenario's: process 1 cut off at 15, healed after
#: ``netfaults.PARTITION_HEAL_S``; process 0 holds 18 until it rejoins
#: (without the hold it would checkpoint shrunk progress past the shared
#: restore point).
NET_BACKBONE = "net_partition@15"
NET_HOLD = "host_return@18"

#: Scenarios of two processes whose process 1 dies with the host_lost code.
TWO_SEAT_SCENARIOS = ("cluster", "peer_recovery")

#: The simulations' dead-peer threshold: generous (a process that starts
#: late, or a loaded host, must not look dead), but under the
#: ``net_partition`` scenario short enough that the majority has shrunk
#: before the partition heals (``netfaults.PARTITION_HEAL_S``: 6 s), the
#: JAX oracle's 2.5 s.
DEAD_AFTER_S, NET_DEAD_AFTER_S = 5.0, 2.5

#: The sampler's vocabulary of each scenario.
VOCABULARIES = {
    "train": faults_lib.CHAOS_VOCABULARY,
    "cluster": faults_lib.CHAOS_CLUSTER_VOCABULARY,
    "expand": faults_lib.CHAOS_EXPAND_VOCABULARY,
    "peer_recovery": faults_lib.CHAOS_PEER_VOCABULARY,
    # The service host's seat is fuzzed; the partition rides process 1.
    "net_partition": faults_lib.CHAOS_NET_VOCABULARY,
}
SCENARIOS = tuple(VOCABULARIES)


def _refuse_unported(name: str) -> None:
    if name in UNPORTED:
        raise NotImplementedError(
            f"chaos {name!r} needs {UNPORTED[name]}, which the port does "
            f"not have yet")


@dataclasses.dataclass
class RunResult:
    """One simulation of one fault spec."""

    ok: bool
    invariant: Optional[str]       # the first violated invariant, or None
    secs: float
    recovery_s: float = 0.0        # the slowest fault→recovery latency
    injected: Dict[str, int] = dataclasses.field(default_factory=dict)


def _tail(out: str) -> str:
    return out.strip().splitlines()[-1][:200] if out.strip() else ""


class ChaosHarness:
    """The campaign's work directory: the dataset, the worker script, the
    reference digest (one fault-free run, cached) and the process
    plumbing shared by campaign runs and shrink probes."""

    def __init__(self, workdir: str, total_steps: int = 40,
                 deadline_s: float = 300.0, plant: Optional[str] = None,
                 verbose: bool = True, refs: Optional[Dict[str, str]] = None,
                 device: str = "cuda"):
        _refuse_unported(plant)
        if plant is not None and plant not in PLANTS:
            raise ValueError(f"unknown plant {plant!r} "
                             f"(have {sorted(PLANTS)})")
        self.workdir = workdir
        self.total_steps = total_steps
        self.deadline_s = deadline_s
        self.plant = plant
        self.verbose = verbose
        self.device = device
        self._runs = 0
        # Reference digests by total_steps: the dataset and the worker's
        # config are deterministic, so one harness's digest serves any
        # other's on the same device.
        self._refs: Dict[str, str] = dict(refs or {})
        os.makedirs(workdir, exist_ok=True)
        self.script = os.path.join(workdir, "chaos_worker.py")
        with open(self.script, "w") as f:
            f.write(WORKER)
        self.data_dir = os.path.join(workdir, "data")
        from dml_cnn_cifar10_tpu_torch.config import DataConfig
        from dml_cnn_cifar10_tpu_torch.data import ensure_dataset
        ensure_dataset(DataConfig(
            dataset="synthetic", data_dir=self.data_dir,
            synthetic_train_records=256, synthetic_test_records=64))

    # -- process plumbing -------------------------------------------------

    def _spawn(self, args, planted: bool, peer: bool = False,
               net: bool = False):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DML_CHAOS_")}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["DML_CHAOS_DEVICE"] = self.device
        env["DML_CHAOS_DEAD_S"] = str(NET_DEAD_AFTER_S if net
                                      else DEAD_AFTER_S)
        if self.device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        if peer:
            env["DML_CHAOS_PEER"] = "1"
        if net:
            env["DML_CHAOS_NET"] = "1"
        if planted and self.plant:
            env["DML_CHAOS_PLANT"] = self.plant
            env["DML_CHAOS_PLANT_CODE"] = PLANTS[self.plant]
        return subprocess.Popen(
            [sys.executable, self.script] + [str(a) for a in args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO)

    @staticmethod
    def _read_result(out: str) -> Optional[dict]:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        return json.loads(lines[-1][len("RESULT "):]) if lines else None

    def _communicate(self, procs) -> tuple:
        """``(outputs, timed_out)``: every process waited for until the
        deadline, a late one killed."""
        outs, timed_out = [], False
        for p in procs:
            try:
                outs.append(p.communicate(timeout=self.deadline_s)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
                timed_out = True
        return outs, timed_out

    # -- the reference digest ---------------------------------------------

    def reference_digest(self) -> str:
        """The fault-free one-process run's digest, computed once. Every
        scenario's seats are replicas of it (each lockstep process is a
        world of its own), so a recovered run, whatever checkpoint or
        replica it restored from, must end bit-identical to it. The
        reference never runs planted code."""
        key = str(self.total_steps)
        if key in self._refs:
            return self._refs[key]
        logs = os.path.join(self.workdir, "ref", "logs_0")
        os.makedirs(logs, exist_ok=True)
        proc = self._spawn([0, 1, self.data_dir, logs,
                            os.path.join(self.workdir, "ref", "cluster"),
                            "", self.total_steps], planted=False)
        out = proc.communicate(timeout=self.deadline_s)[0]
        res = self._read_result(out)
        if proc.returncode != 0 or res is None or res.get("fenced") \
                or res["final_step"] != self.total_steps:
            raise RuntimeError(f"fault-free reference run failed:\n{out}")
        self._refs[key] = res["digest"]
        return res["digest"]

    # -- invariants -------------------------------------------------------

    def _check_stream(self, path: str, events):
        """Schema and fault-pairing invariants over one stream:
        ``(violation or None, injected counts, slowest recovery)``."""
        sys.path.insert(0, REPO)
        from tools import check_jsonl_schema

        injected: Dict[str, int] = {}
        slowest = 0.0
        if not os.path.exists(path):
            return "schema: metrics stream missing", injected, slowest
        errs = check_jsonl_schema.check_file(path, strict=True)
        if errs:
            return f"schema: {errs[0]}", injected, slowest
        with open(path) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        inj = [r for r in recs if r.get("kind") == "fault"
               and r.get("injected")]
        for r in inj:
            injected[r["fault"]] = injected.get(r["fault"], 0) + 1
        detected = [r for r in recs if r.get("kind") == "fault"
                    and not r.get("injected")]
        recoveries = [r for r in recs if r.get("kind") == "recovery"]
        # Every step-triggered scheduled fault must have fired (a phase
        # event stays pending when no recovery reaches its seam).
        want: Dict[str, int] = {}
        for ev in events:
            if ev.phase is None:
                want[ev.kind] = want.get(ev.kind, 0) + 1
        for kind, n in want.items():
            if injected.get(kind, 0) < n:
                return (f"fault_pairing: scheduled {kind} x{n} but only "
                        f"{injected.get(kind, 0)} injected fault "
                        f"record(s)"), injected, slowest
        for r in detected + [r for r in inj
                             if r["fault"] in RECOVERY_PROVOKING]:
            after = [v for v in recoveries if v["t"] >= r["t"]]
            if not after:
                what = ("detected" if not r.get("injected")
                        else "injected")
                return (f"fault_pairing: {what} {r.get('fault')} at "
                        f"t={r.get('t')} has no recovery record"), \
                    injected, slowest
            slowest = max(slowest, after[0]["t"] - r["t"])
        # A damaged replica that an elastic restart read must be answered
        # by a reconstruct (a re-pushed replica) or an explicit fallback.
        answers = [v for v in recs if v.get("kind") == "peer_replica"
                   and v.get("op") in ("reconstruct", "fallback")]
        restarts = [v for v in recs if v.get("kind") in (
            "elastic_restart", "elastic_expand")]
        for r in inj:
            if r["fault"] not in ("replica_corrupt", "replica_stale"):
                continue
            if [v for v in restarts if v["t"] >= r["t"]] and not [
                    v for v in answers if v["t"] >= r["t"]]:
                return (f"fault_pairing: injected {r['fault']} followed "
                        f"by an elastic restart but no peer_replica "
                        f"reconstruct or disk-fallback record"), \
                    injected, slowest
        return None, injected, slowest

    def _judge(self, seats, events_by_seat, logs, ref, secs) -> RunResult:
        """The completion, bit-identity and stream invariants of the seats
        that must finish: ``seats`` is ``[(seat, returncode, output)]``."""
        for seat, rc, out in seats:
            if rc != 0:
                return RunResult(False, f"completed: seat {seat} exit {rc} "
                                        f"({_tail(out)})", secs)
            res = self._read_result(out)
            if res is None or res.get("fenced"):
                return RunResult(False, f"completed: seat {seat} "
                                        f"{'fenced' if res else 'no RESULT'}",
                                 secs)
            if res["final_step"] != self.total_steps:
                return RunResult(False, f"completed: seat {seat} final "
                                        f"step {res['final_step']}", secs)
            if res["digest"] != ref:
                return RunResult(False, f"bit_identical: seat {seat} "
                                        f"params differ from the fault-free "
                                        f"reference", secs)
        injected: Dict[str, int] = {}
        slowest = 0.0
        for d, events in zip(logs, events_by_seat):
            inv, inj, slow = self._check_stream(
                os.path.join(d, "metrics.jsonl"), events)
            if inv is not None:
                return RunResult(False, inv, secs)
            for k, v in inj.items():
                injected[k] = injected.get(k, 0) + v
            slowest = max(slowest, slow)
        return RunResult(True, None, secs, recovery_s=slowest,
                         injected=injected)

    # -- one schedule -----------------------------------------------------

    def run_schedule(self, events: Sequence[faults_lib.FaultEvent],
                     scenario: str, tag: str,
                     backbone: str = CLUSTER_BACKBONE) -> RunResult:
        """Run one schedule (on process 0) through ``scenario``'s
        simulation and check every invariant; ``backbone`` is the cluster
        scenarios' fault on process 1."""
        _refuse_unported(scenario)
        if scenario not in SCENARIOS:
            raise ValueError(f"unknown scenario {scenario!r} "
                             f"(have {SCENARIOS})")
        self._runs += 1
        run_dir = os.path.join(self.workdir, f"run_{self._runs:03d}_{tag}")
        cluster = os.path.join(run_dir, "cluster")
        t0 = time.time()
        ref = self.reference_digest()
        if scenario == "expand":
            return self._run_expand(events, run_dir, cluster, ref, t0)
        if scenario == "net_partition":
            hold = faults_lib.parse_fault_spec(NET_HOLD)
            specs = [list(events) + hold,
                     faults_lib.parse_fault_spec(NET_BACKBONE)]
        elif scenario in TWO_SEAT_SCENARIOS:
            specs = [list(events), faults_lib.parse_fault_spec(backbone)]
        else:
            specs = [list(events)]
        n = len(specs)
        logs = [os.path.join(run_dir, f"logs_{t}") for t in range(n)]
        for d in logs:
            os.makedirs(d, exist_ok=True)
        procs = [self._spawn(
            [t, n, self.data_dir, logs[t], cluster,
             faults_lib.format_fault_spec(specs[t]), self.total_steps],
            planted=True, peer=scenario == "peer_recovery",
            net=scenario == "net_partition") for t in range(n)]
        outs, timed_out = self._communicate(procs)
        secs = time.time() - t0
        if timed_out:
            return RunResult(False, f"deadline: a process outlived "
                                    f"{self.deadline_s:.0f}s", secs)
        finish = [(t, p.returncode, out)
                  for t, (p, out) in enumerate(zip(procs, outs))]
        if scenario in TWO_SEAT_SCENARIOS:
            # The backbone corpse must die with the abrupt-death code.
            if procs[1].returncode != faults_lib.EXIT_HOST_LOST:
                return RunResult(False, f"completed: backbone host exited "
                                        f"{procs[1].returncode}, wanted "
                                        f"{faults_lib.EXIT_HOST_LOST}", secs)
            finish = finish[:1]
        return self._judge(finish, specs, logs, ref, secs)

    def _run_expand(self, events, run_dir: str, cluster: str, ref: str,
                    t0: float) -> RunResult:
        """The 2→1→2 drill under a schedule: process 1 dies at 15, the
        survivor runs the schedule and holds 18; this harness, as the
        scheduler, respawns process 1 once the survivor has adopted the
        shrink (read from its stream: a decision_corrupt schedule may
        corrupt the decision file itself)."""
        logs = [os.path.join(run_dir, f"logs_{t}") for t in (0, 1)]
        for d in logs:
            os.makedirs(d, exist_ok=True)
        spec0 = list(events) + faults_lib.parse_fault_spec(EXPAND_HOLD)
        deadline = time.time() + self.deadline_s
        procs = [self._spawn([0, 2, self.data_dir, logs[0], cluster,
                              faults_lib.format_fault_spec(spec0),
                              self.total_steps], planted=True),
                 self._spawn([1, 2, self.data_dir, logs[1], cluster,
                              EXPAND_BACKBONE, self.total_steps],
                             planted=True)]

        def fail(inv):
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            return RunResult(False, inv, time.time() - t0)

        try:
            procs[1].wait(timeout=self.deadline_s)
        except subprocess.TimeoutExpired:
            return fail(f"deadline: backbone host outlived "
                        f"{self.deadline_s:.0f}s")
        if procs[1].returncode != faults_lib.EXIT_HOST_LOST:
            return fail(f"completed: backbone host exited "
                        f"{procs[1].returncode}, wanted "
                        f"{faults_lib.EXIT_HOST_LOST}")
        stream0 = os.path.join(logs[0], "metrics.jsonl")
        while True:
            if os.path.exists(stream0):
                with open(stream0, errors="replace") as f:
                    if '"elastic_restart"' in f.read():
                        break
            if time.time() > deadline:
                return fail("deadline: survivor never adopted the shrink "
                            "decision")
            if procs[0].poll() is not None:
                return fail(f"completed: survivor died before the shrink "
                            f"(exit {procs[0].returncode}: "
                            f"{_tail(procs[0].communicate()[0])})")
            time.sleep(0.1)
        procs.append(self._spawn([1, 2, self.data_dir, logs[1], cluster, "",
                                  self.total_steps], planted=True))
        outs, timed_out = self._communicate([procs[0], procs[2]])
        if timed_out:
            return fail(f"deadline: a process outlived "
                        f"{self.deadline_s:.0f}s")
        return self._judge(
            [(0, procs[0].returncode, outs[0]),
             (1, procs[2].returncode, outs[1])],
            [spec0, faults_lib.parse_fault_spec(EXPAND_BACKBONE)], logs,
            ref, time.time() - t0)

    # -- shrinking --------------------------------------------------------

    def shrink(self, events: List[faults_lib.FaultEvent], scenario: str,
               max_runs: int = 16) -> List[faults_lib.FaultEvent]:
        """Greedy one-fault removal: drop any fault whose removal keeps
        the schedule failing, until every remaining one is needed (within
        ``max_runs`` probes)."""
        events = list(events)
        runs = 0
        changed = True
        while changed and len(events) > 1 and runs < max_runs:
            changed = False
            for i in range(len(events)):
                candidate = events[:i] + events[i + 1:]
                runs += 1
                probe = self.run_schedule(candidate, scenario,
                                          tag=f"shrink{runs}")
                if self.verbose:
                    print(f"[chaos]   shrink probe "
                          f"\"{faults_lib.format_fault_spec(candidate)}\""
                          f" -> {'passes' if probe.ok else 'still fails'}")
                if not probe.ok:
                    events = candidate
                    changed = True
                    break
                if runs >= max_runs:
                    break
        return events


def run_campaign(seeds: Sequence[int], scenario: str, workdir: str,
                 budget: int = 3, total_steps: int = 40,
                 deadline_s: float = 300.0, plant: Optional[str] = None,
                 metrics_jsonl: Optional[str] = None, shrink: bool = True,
                 explicit_spec: Optional[str] = None, verbose: bool = True,
                 refs: Optional[Dict[str, str]] = None,
                 device: str = "cuda") -> dict:
    """One campaign: a schedule a seed (``explicit_spec`` replays one
    fixed schedule instead), each run, judged and, when it fails, shrunk.
    Returns the summary (also the ``chaos_done`` record when
    ``metrics_jsonl`` is set)."""
    _refuse_unported(scenario)
    harness = ChaosHarness(workdir, total_steps=total_steps,
                           deadline_s=deadline_s, plant=plant,
                           verbose=verbose, refs=refs, device=device)
    logger = MetricsLogger(metrics_jsonl)
    results = []
    faults_by_kind: Dict[str, int] = {}
    slowest = 0.0
    try:
        for seed in seeds:
            if explicit_spec is not None:
                sched = faults_lib.FaultSchedule(
                    seed, faults_lib.parse_fault_spec(explicit_spec))
            else:
                sched = faults_lib.FaultSchedule.generate(
                    seed, budget, vocabulary=VOCABULARIES[scenario],
                    max_step=total_steps - 5)
            if verbose:
                print(f"[chaos] seed {seed} [{scenario}] \"{sched.spec}\"",
                      flush=True)
            r = harness.run_schedule(sched.events, scenario,
                                     tag=f"seed{seed}")
            reproducer = None
            if not r.ok:
                reproducer = sched.spec
                if shrink and len(sched.events) > 1:
                    reproducer = faults_lib.format_fault_spec(
                        harness.shrink(list(sched.events), scenario))
            for k, v in r.injected.items():
                faults_by_kind[k] = faults_by_kind.get(k, 0) + v
            slowest = max(slowest, r.recovery_s)
            rec = {"seed": seed, "scenario": scenario, "spec": sched.spec,
                   "ok": r.ok, "invariant": r.invariant,
                   "secs": round(r.secs, 2)}
            if reproducer is not None:
                rec["reproducer"] = reproducer
            logger.log("chaos", **rec)
            results.append(rec)
            if verbose:
                if r.ok:
                    print(f"[chaos]   OK in {r.secs:.1f}s "
                          f"(injected {r.injected})", flush=True)
                else:
                    print(f"[chaos]   FAILED: {r.invariant}\n[chaos]   "
                          f"minimal reproducer: --fault_spec "
                          f"\"{reproducer}\"", flush=True)
        summary = {
            "schedules": len(results),
            "passed": sum(1 for r in results if r["ok"]),
            "failed": sum(1 for r in results if not r["ok"]),
            "faults_by_kind": faults_by_kind,
            "slowest_recovery_s": round(slowest, 3),
            "results": results,
            "reference_digests": dict(harness._refs),
        }
        logger.log("chaos_done", **{k: v for k, v in summary.items()
                                    if k not in ("results",
                                                 "reference_digests")})
        return summary
    finally:
        logger.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="chaos oracle of the PyTorch port: seeded compound "
                    "faults through the supervised simulations")
    p.add_argument("--seeds", type=int, default=5,
                   help="number of seeded schedules to run")
    p.add_argument("--seed_base", type=int, default=0,
                   help="first seed (seeds are seed_base..+N-1)")
    p.add_argument("--scenario", default="train",
                   choices=list(SCENARIOS) + ["mixed", "runtime",
                                              "autopilot"],
                   help="the simulation to fuzz (mixed: the ported ones "
                        "in turn; runtime and autopilot are not ported)")
    p.add_argument("--budget", type=int, default=3,
                   help="faults sampled per schedule")
    p.add_argument("--total_steps", type=int, default=40,
                   help="steps per simulation run")
    p.add_argument("--deadline_s", type=float, default=300.0,
                   help="per-run wall-clock deadline; an overrun is an "
                        "invariant failure")
    p.add_argument("--workdir", default=None,
                   help="campaign working directory (default: a fresh "
                        "temporary directory)")
    p.add_argument("--metrics_jsonl", default=None,
                   help="write chaos/chaos_done records here")
    p.add_argument("--spec", default=None,
                   help="run this exact --fault_spec once instead of "
                        "sampling (reproducer replay)")
    p.add_argument("--no_shrink", action="store_true",
                   help="skip shrinking failing schedules")
    p.add_argument("--plant", default=None,
                   choices=sorted(PLANTS) + ["no_autopilot_policy"],
                   help="revert a named piece of hardening inside the "
                        "workers (the campaign must catch it)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the workers train (the card by default)")
    args = p.parse_args(argv)
    _refuse_unported(args.scenario)
    _refuse_unported(args.plant)
    workdir = args.workdir
    if workdir is None:
        import tempfile
        workdir = tempfile.mkdtemp(prefix="dml_chaos_")
    scenarios = list(SCENARIOS) if args.scenario == "mixed" \
        else [args.scenario]
    seeds = list(range(args.seed_base, args.seed_base + args.seeds))
    if args.spec is not None:
        seeds = seeds[:1]
    failed = 0
    refs: Dict[str, str] = {}
    for i, scen in enumerate(scenarios):
        scen_seeds = seeds[i::len(scenarios)]
        if not scen_seeds:
            continue
        summary = run_campaign(
            scen_seeds, scen, os.path.join(workdir, scen),
            budget=args.budget, total_steps=args.total_steps,
            deadline_s=args.deadline_s, plant=args.plant,
            metrics_jsonl=args.metrics_jsonl, shrink=not args.no_shrink,
            explicit_spec=args.spec, refs=refs, device=args.device)
        refs.update(summary["reference_digests"])
        failed += summary["failed"]
        print(f"[chaos] {scen}: {summary['passed']}/{summary['schedules']} "
              f"schedules passed; faults injected: "
              f"{summary['faults_by_kind']}; slowest recovery "
              f"{summary['slowest_recovery_s']:.2f}s")
    print(f"[chaos] campaign {'PASSED' if not failed else 'FAILED'} "
          f"({failed} failing schedule(s); workdir {workdir})")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
