"""Deterministic fault injection for exercising the recovery paths.

A copy of ``dml_cnn_cifar10_tpu/utils/faults.py``: the same kinds, spec
grammar, chaos vocabularies and seeded sampler. ``--fault_spec
"nan@120,ckpt_corrupt@200,sigterm@300"`` fires each fault ONCE at the
first dispatch seam of ``Trainer.fit`` where the global step reaches its
trigger. The run supervisor (``train/supervisor.py``) builds one injector
and threads it through every attempt, so a recovered run replaying the
same steps does not re-injure itself.

Step-seam kinds:

- ``nan`` — multiply the first parameter by NaN, in place (``mul_``), so
  the real forward and backward produce a non-finite loss. In place
  because a chunk's CUDA graph replays against the parameters' addresses:
  a new tensor would never reach the graph.
- ``ckpt_corrupt`` — truncate the newest checkpoint on disk to half,
  leaving its checksum sidecar stale, as a crashed copy or bit rot would;
  the restore walk must fall back to an older one. Waits until a
  checkpoint exists.
- ``sigterm`` — deliver SIGTERM to this process: the trainer's
  ``PreemptionGuard`` path (finish the dispatch, checkpoint, exit 0).
- ``data_stall`` — raise :class:`DataStallError` at the seam, the stand-in
  for a wedged input pipeline; the supervisor classifies it as a
  recoverable data failure.

Cluster kinds (need a :class:`~parallel.cluster.ClusterMonitor`, i.e.
``--cluster_dir``; they raise :class:`InjectedFault` without one):

- ``heartbeat_stall`` — stop publishing heartbeats while training goes
  on: from outside, a dead host. Peers restart without this process; its
  eviction check fences it.
- ``host_lost`` — ``os._exit`` with no cleanup, no checkpoint and no
  flushed buffers (exit code :data:`EXIT_HOST_LOST`). Under
  ``--peer_redundancy`` the host is lost after its pending replica
  pushes committed and a beat advertised them
  (``ClusterMonitor.flush_replicas``), so the peer-recovery drill
  decides ``source="peer"`` whatever the push thread's timing; a loss
  with no usable replica is what ``replica_stale`` drills.
- ``collective_hang`` — block the main thread at the seam while the
  publisher keeps beating: a wedged collective. This process's watchdog
  ends it past ``collective_timeout_s``.
- ``host_return`` — hold the seam until a returning host's
  ``rejoin``-phase beat appears (or an expand was already granted), so
  the 2→1→2 elastic drill expands at a known step.
- ``decision_corrupt`` — overwrite the restart-decision file with a
  decodable but bogus decision and a mismatched sidecar; the hardened
  reader must classify it, never adopt it.
- ``replica_corrupt`` — truncate one part file of every owner's newest
  committed peer replica (``ckpt/peerstore.py``): the restore's sidecar
  check classifies the damage and falls back to the disk walk.
- ``replica_stale`` — delete every owner's newest committed replica while
  the beats still advertise it: a decided peer restore misses and falls
  back to disk. Both replica kinds wait until a replica is committed;
  they act once the pushes of this process's newest boundary, its own
  and those of the peers past it, have committed
  (:func:`_newest_replica_dirs`).

Network kinds (need ``--cluster_transport net``, ``parallel/net.py``;
they raise :class:`InjectedFault` on the file transport): the injecting
process POSTs the fault to the coordination service (``/fault``,
``utils/netfaults.py``), isolating itself. ``net_partition`` holds its
requests unanswered for ``netfaults.PARTITION_HEAL_S``: beats stop
landing, reads come back empty, a decision cannot be committed, and the
bounded client turns that into the ordinary ``peer_lost`` / eviction
paths (under ``--elastic_expand`` the process rejoins when it heals).
``net_delay`` answers late for a window, ``net_drop`` answers every
second request 503 for a window (the client's retries absorb it),
``net_dup`` applies writes twice for a window (atomic replaces make it
invisible).

Recovery-phase triggers (``kind@phase``) fire inside the supervisor's
recovery paths instead of at a step, through :meth:`FaultInjector.
phase_hook`: ``@restore`` at the checkpoint-restore seam of a recovery
attempt (``Trainer.init_or_restore``; a fresh run's restore does not
count), ``@decide`` on the chief right after it commits a restart or
expand decision, ``@adopt`` on any seat right after it adopts one. The
kinds allowed there are :data:`PHASE_FAULT_KINDS`.

:class:`FaultSchedule` is the seeded sampler over the ``CHAOS_*``
vocabularies that the chaos oracle (``tools/chaos.py``) draws from: the
same seed yields the JAX sampler's schedule. Every injection logs a
``fault`` record (``injected: true``). Unknown kinds and malformed
entries raise ``ValueError``, as in the JAX module.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import shutil
import signal
import time
from typing import List, Optional, Sequence

import torch

#: The kinds this module fires: the step seam's, the cluster's, the peer
#: replicas' and the network's (the JAX module's tuple).
FAULT_KINDS = ("nan", "ckpt_corrupt", "sigterm", "data_stall",
               "heartbeat_stall", "host_lost", "collective_hang",
               "host_return", "decision_corrupt", "replica_corrupt",
               "replica_stale", "net_partition", "net_delay",
               "net_drop", "net_dup")

#: The network subset, armed on the coordination service
#: (``utils/netfaults.py``).
NET_FAULT_KINDS = ("net_partition", "net_delay", "net_drop", "net_dup")

#: Recovery-path seams a fault may be phase-qualified to (``kind@phase``),
#: owned by the supervisor and ``Trainer.init_or_restore``.
FAULT_PHASES = ("restore", "adopt", "decide")

#: Kinds that make sense at a phase seam (no train state to poison there,
#: and a blocking kind would deadlock the recovery itself).
PHASE_FAULT_KINDS = ("ckpt_corrupt", "sigterm", "data_stall",
                     "host_lost", "heartbeat_stall", "decision_corrupt")

#: Bounded wait for a ``host_return`` drill's returning host.
HOST_RETURN_TIMEOUT_S = 300.0

#: Bounded wait of a replica fault for the pushes it acts on.
REPLICA_SETTLE_S = 10.0

#: Exit code of a ``host_lost`` injection (distinct from the watchdog's
#: own abort code, ``parallel/cluster.py:EXIT_WATCHDOG_ABORT``).
EXIT_HOST_LOST = 77


class InjectedFault(RuntimeError):
    """Base class for failures raised (not merely caused) by injection."""


class DataStallError(InjectedFault):
    """Injected stand-in for a wedged or failed input pipeline."""


@dataclasses.dataclass
class FaultEvent:
    kind: str
    step: Optional[int] = None
    fired: bool = False
    phase: Optional[str] = None

    @property
    def trigger(self) -> str:
        """The ``@``-suffix this event was parsed from."""
        return self.phase if self.phase is not None else str(self.step)


def parse_fault_spec(spec: str) -> List[FaultEvent]:
    """``"kind@trigger,kind@trigger,..."`` → ordered fault events: the
    step events by (step, kind), then the phase events by (phase, kind),
    the JAX parser's order. A trigger is a global step or a phase of
    :data:`FAULT_PHASES`; several faults may share one (they fire in
    spec order). Unknown kinds, malformed entries and phase triggers on
    kinds outside :data:`PHASE_FAULT_KINDS` raise ``ValueError``."""
    events = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        kind, sep, trigger = entry.partition("@")
        kind, trigger = kind.strip(), trigger.strip()
        if not sep or kind not in FAULT_KINDS:
            raise ValueError(
                f"bad fault spec entry {entry!r}: want kind@trigger with "
                f"kind in {FAULT_KINDS}")
        if trigger in FAULT_PHASES:
            if kind not in PHASE_FAULT_KINDS:
                raise ValueError(
                    f"bad fault spec entry {entry!r}: kind {kind!r} "
                    f"cannot be phase-qualified (allowed: "
                    f"{PHASE_FAULT_KINDS})")
            events.append(FaultEvent(kind, phase=trigger))
            continue
        try:
            step = int(trigger)
        except ValueError:
            raise ValueError(
                f"bad fault spec entry {entry!r}: trigger {trigger!r} is "
                f"neither an integer step nor a phase in "
                f"{FAULT_PHASES}") from None
        if step < 0:
            raise ValueError(f"bad fault spec entry {entry!r}: negative "
                             f"step")
        events.append(FaultEvent(kind, step))
    return sorted(events, key=lambda e: (
        e.step is None, e.step if e.step is not None else 0,
        e.phase or "", e.kind))


def format_fault_spec(events: Sequence[FaultEvent]) -> str:
    """The ``--fault_spec`` string of ``events``: the inverse of
    :func:`parse_fault_spec`."""
    return ",".join(f"{e.kind}@{e.trigger}" for e in events)


@torch.no_grad()
def poison_state(state):
    """Multiply the first parameter by NaN in place; returns ``state``."""
    for p in state.params.values():
        p.mul_(float("nan"))
        break
    return state


def corrupt_latest_checkpoint(log_dir: str) -> Optional[str]:
    """Truncate the newest checkpoint file (of a ``.sharded`` directory,
    its first shard file) to half its size. Returns the checkpoint's
    path, or None when there is no checkpoint yet."""
    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib

    path = ckpt_lib.latest_checkpoint(log_dir)
    if path is None:
        return None
    target = path
    if os.path.isdir(path):
        target = os.path.join(path, sorted(
            n for n in os.listdir(path) if n.endswith(".msgpack"))[0])
    size = os.path.getsize(target)
    with open(target, "r+b") as f:
        f.truncate(size // 2)
    return path


def _newest_replica_dirs(cluster) -> List[str]:
    """Each owner's newest committed replica directory in the cluster's
    peer store (the owners of the store's world): the set the next
    diskless restore would read. This process's pending pushes are
    flushed first; a peer whose beat is past this process's newest
    committed boundary has queued its push of it, and is waited for
    (bounded by :data:`REPLICA_SETTLE_S`) until that commits, so the fault
    lands on the same set whatever the push threads' timing. Empty when
    nothing is committed yet (or the monitor has no peer store)."""
    store = getattr(cluster, "peer_store", None)
    if store is None:
        return []
    store.flush()
    want = store.replica_step
    if want >= 0:
        beats = cluster.store.read_all()
        waiting = [p for p in store.world if p != store.process_id
                   and p in beats and beats[p].step >= want]
        deadline = time.time() + REPLICA_SETTLE_S
        while waiting and time.time() < deadline:
            waiting = [p for p in waiting
                       if (store.committed_steps(p) or [-1])[-1] < want]
            if waiting:
                time.sleep(0.05)
    out = []
    for owner in store.world:
        steps = store.committed_steps(owner)
        if steps:
            out.append(store._step_dir(owner, steps[-1]))
    return out


def corrupt_peer_replicas(cluster) -> List[str]:
    """Truncate one part file inside every owner's NEWEST committed peer
    replica, the set the next diskless restore would read; the sidecar
    check classifies the damage (``ReplicaMiss``) and the restore falls
    back to disk. Returns the truncated files (empty: stay pending)."""
    victims = []
    for sdir in _newest_replica_dirs(cluster):
        parts = sorted(n for n in os.listdir(sdir) if n.endswith(".msgpack"))
        if not parts:
            continue
        victim = os.path.join(sdir, parts[0])
        with open(victim, "r+b") as f:
            f.truncate(os.path.getsize(victim) // 2)
        victims.append(victim)
    return victims


def stale_peer_replicas(cluster) -> List[str]:
    """Delete every owner's NEWEST committed replica directory, keeping
    older ones. The stores' counters (and so the beats) still advertise
    the deleted step, so a chief that decides ``source="peer"`` finds a
    miss and the restore falls back to disk. Returns the deleted
    directories (empty: stay pending)."""
    removed = _newest_replica_dirs(cluster)
    for sdir in removed:
        shutil.rmtree(sdir, ignore_errors=True)
    return removed


def corrupt_decision_file(cluster) -> str:
    """Corrupt the cluster's restart-decision file the nasty way: a
    decodable but bogus decision (absurd epoch, no survivors: adopting it
    would fence every live host) beside a MISMATCHED sidecar, which only
    the sidecar check catches. Returns the file's path."""
    coord = cluster.coordinator
    bogus = {"epoch": cluster.epoch + 997, "world_size": 1,
             "restore_step": 0, "survivors": [], "kind": "shrink"}
    with open(coord.path, "w") as f:
        json.dump(bogus, f)
    with open(coord.sidecar_path, "w") as f:
        json.dump({"algo": "sha256", "digest": "0" * 64}, f)
    return coord.path


#: Default sampler vocabulary: every (kind, trigger) the chaos campaign
#: may draw for a SUPERVISED one-process run, each recoverable to the end
#: (sigterm and host_lost on the only process end the run by design:
#: they are the cluster scenarios' backbone faults, not sampled ones).
CHAOS_VOCABULARY = (
    "nan@step", "ckpt_corrupt@step", "data_stall@step",
    "decision_corrupt@step", "ckpt_corrupt@restore",
    "data_stall@restore", "decision_corrupt@restore",
)

#: The 2-process cluster scenario's SURVIVOR seat (the dead peer carries
#: the backbone ``host_lost``): recovery-phase compound faults too.
CHAOS_CLUSTER_VOCABULARY = CHAOS_VOCABULARY + (
    "decision_corrupt@decide", "heartbeat_stall@adopt",
)

#: The 2→1→2 expand scenario's surviving chief. Left out:
#: ``heartbeat_stall@adopt`` (a chief going dark right before re-admitting
#: a joiner starts an evict/rejoin ping-pong of unbounded wall-clock) and
#: ``decision_corrupt`` (the respawned seat learns of its eviction FROM
#: the decision file; corrupting it leaves that seat beating forever and
#: the ``host_return`` hold times out by construction).
CHAOS_EXPAND_VOCABULARY = (
    "nan@step", "ckpt_corrupt@step", "data_stall@step",
    "ckpt_corrupt@restore", "data_stall@restore",
)

#: The 2-process ``peer_recovery`` scenario (peer redundancy on): the
#: cluster vocabulary plus the replica faults, which live ONLY here: they
#: wait for a committed replica, so a scenario without redundancy would
#: schedule faults that never fire.
CHAOS_PEER_VOCABULARY = CHAOS_CLUSTER_VOCABULARY + (
    "replica_corrupt@step", "replica_stale@step",
)

#: The JAX package's one-process unified-runtime scenario (``--mode
#: run``). The port has no runtime yet (ROADMAP.md Queue 1 item 6); the
#: vocabulary is data and is kept whole.
CHAOS_RUNTIME_VOCABULARY = (
    "nan@step", "ckpt_corrupt@step", "data_stall@step",
    "ckpt_corrupt@restore", "data_stall@restore",
)

#: The 2-process ``net_partition`` scenario's SERVER seat (the
#: partitioned seat carries the ``net_partition`` backbone): the expand
#: vocabulary (the partitioned peer rejoins through the same expand arc)
#: plus the recoverable link faults on the service's own loopback link.
#: ``net_partition`` itself is not sampled: partitioning the seat that
#: HOSTS the service holds its own loopback requests.
CHAOS_NET_VOCABULARY = CHAOS_EXPAND_VOCABULARY + (
    "net_delay@step", "net_drop@step", "net_dup@step",
)


@dataclasses.dataclass
class FaultSchedule:
    """A seeded, reproducible compound-fault schedule: ``generate(seed,
    budget)`` draws ``budget`` faults from a vocabulary of ``kind@step`` /
    ``kind@phase`` templates with a :class:`random.Random` of ``seed``, the
    JAX sampler's draws in the JAX sampler's order, so a seed names the
    same schedule in both packages."""

    seed: int
    events: List[FaultEvent]

    @property
    def spec(self) -> str:
        return format_fault_spec(self.events)

    @classmethod
    def generate(cls, seed: int, budget: int,
                 vocabulary: Sequence[str] = CHAOS_VOCABULARY,
                 min_step: int = 1, max_step: int = 35,
                 ckpt_every: int = 10) -> "FaultSchedule":
        """Sample ``budget`` faults. A step template gets a uniform step in
        ``[min_step, max_step]`` (several faults may share a step); a
        phase template is kept once (a phase event is one-shot).
        ``ckpt_corrupt`` steps start after the SECOND checkpoint can exist
        (``2 * ckpt_every + 1``): corrupting the only checkpoint right
        before a recovery needs it has no recovery to fuzz."""
        if budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        seen_phase = set()
        for _ in range(budget):
            kind, _, trigger = rng.choice(list(vocabulary)).partition("@")
            if trigger == "step":
                lo = max(min_step, 2 * ckpt_every + 1) \
                    if kind == "ckpt_corrupt" else min_step
                events.append(
                    FaultEvent(kind, rng.randint(lo, max(lo, max_step))))
            elif (kind, trigger) not in seen_phase:
                seen_phase.add((kind, trigger))
                events.append(FaultEvent(kind, phase=trigger))
        # Through the parser: every entry validated, the canonical order.
        return cls(seed, parse_fault_spec(format_fault_spec(events)))


def _needs_cluster(cluster, what: str) -> None:
    if cluster is None:
        raise InjectedFault(f"{what} injection needs --cluster_dir (no "
                            f"ClusterMonitor)")


class FaultInjector:
    """One-shot fault firing at the training loop's dispatch seam
    (``Trainer.fit`` calls :meth:`step_hook` once a dispatch) and at the
    recovery seams (:meth:`phase_hook`). Owned by the supervisor across
    restarts so fired events stay fired."""

    def __init__(self, events: List[FaultEvent]):
        self.events = events
        # Set by the supervisor once a recoverable failure is being
        # handled: ``@restore`` events fire only at RECOVERY restores.
        self.recovering = False
        # The last step the step hook saw: phase events fire outside the
        # step loop and borrow it for their records.
        self._last_step = 0

    @classmethod
    def from_spec(cls, spec: Optional[str]) -> Optional["FaultInjector"]:
        if not spec:
            return None
        return cls(parse_fault_spec(spec))

    def pending(self) -> List[FaultEvent]:
        return [e for e in self.events if not e.fired]

    def _log(self, logger, step: int, kind: str, **extra) -> None:
        if logger is not None:
            logger.log("fault", step=step, fault=kind, injected=True,
                       **extra)

    def step_hook(self, step: int, state, log_dir: str, logger=None,
                  chief: bool = True, cluster=None):
        """Fire every due, unfired step event; returns ``state`` (poisoned
        in place by ``nan``). ``ckpt_corrupt`` stays pending until a
        checkpoint exists, and only the chief, which writes the
        checkpoints, truncates one. ``data_stall`` raises after marking
        itself fired. The cluster kinds take the trainer's
        :class:`ClusterMonitor` (``cluster``) and raise without one."""
        self._last_step = step
        for ev in self.events:
            if ev.phase is not None or ev.fired or step < ev.step:
                continue
            if ev.kind == "nan":
                ev.fired = True
                state = poison_state(state)
                self._log(logger, step, ev.kind)
            elif ev.kind == "ckpt_corrupt":
                if not chief:
                    ev.fired = True
                    continue
                path = corrupt_latest_checkpoint(log_dir)
                if path is None:
                    continue  # no checkpoint yet: stay pending
                ev.fired = True
                self._log(logger, step, ev.kind, path=path)
            elif ev.kind == "sigterm":
                ev.fired = True
                self._log(logger, step, ev.kind)
                os.kill(os.getpid(), signal.SIGTERM)
            elif ev.kind == "data_stall":
                ev.fired = True
                self._log(logger, step, ev.kind)
                raise DataStallError(f"injected data stall at step {step}")
            elif ev.kind == "heartbeat_stall":
                _needs_cluster(cluster, ev.kind)
                ev.fired = True
                self._log(logger, step, ev.kind)
                cluster.stall_heartbeats()
            elif ev.kind == "host_lost":
                ev.fired = True
                self._log(logger, step, ev.kind)
                if cluster is not None:
                    cluster.flush_replicas()
                # Abrupt death: no checkpoint, no drain, no atexit. The
                # JSONL line above is line-buffered (already written).
                os._exit(EXIT_HOST_LOST)
            elif ev.kind == "collective_hang":
                _needs_cluster(cluster, ev.kind)
                ev.fired = True
                self._log(logger, step, ev.kind)
                # Wedge the main thread while the publisher keeps beating;
                # only the watchdog's collective_timeout_s abort ends it.
                while True:
                    time.sleep(0.05)
            elif ev.kind == "decision_corrupt":
                _needs_cluster(cluster, ev.kind)
                ev.fired = True
                path = corrupt_decision_file(cluster)
                self._log(logger, step, ev.kind, path=path)
            elif ev.kind in ("replica_corrupt", "replica_stale"):
                _needs_cluster(cluster, ev.kind)
                paths = (corrupt_peer_replicas if ev.kind ==
                         "replica_corrupt" else stale_peer_replicas)(cluster)
                if not paths:
                    continue  # no committed replica yet: stay pending
                ev.fired = True
                self._log(logger, step, ev.kind, path=paths[0])
            elif ev.kind in NET_FAULT_KINDS:
                client = getattr(cluster, "net_client", None)
                if client is None:
                    raise InjectedFault(
                        f"{ev.kind} injection needs --cluster_transport "
                        f"net (no network between the file store and its "
                        f"directory to break)")
                ev.fired = True
                # Armed ON the coordination service, isolating THIS
                # process: the arm request must land before the fault
                # takes effect, so the injecting seat is the isolated one.
                rec = client.post_fault(ev.kind,
                                        isolate=[cluster.process_id])
                self._log(logger, step, ev.kind, isolate=rec.get("isolate"),
                          duration_s=rec.get("duration_s"))
            elif ev.kind == "host_return":
                _needs_cluster(cluster, ev.kind)
                ev.fired = True
                self._log(logger, step, ev.kind)
                # Hold this step until a rejoin announcement is visible,
                # so the chief's rejoin scan fires at the next seam. An
                # expand already granted satisfies the drill too (the
                # grant consumed the announcement).
                deadline = time.time() + HOST_RETURN_TIMEOUT_S
                while not cluster.rejoin_candidates():
                    d = cluster.coordinator.read()
                    if d is not None and d.kind == "expand":
                        break
                    if time.time() > deadline:
                        raise InjectedFault(
                            f"host_return@{ev.step}: no rejoin announcement "
                            f"within {HOST_RETURN_TIMEOUT_S:.0f}s — did the "
                            f"returning host start with --elastic_expand?")
                    time.sleep(0.05)
        return state

    def phase_hook(self, phase: str, log_dir: str, logger=None,
                   cluster=None) -> None:
        """Fire every unfired event qualified to ``phase``: the recovery
        twin of :meth:`step_hook`, called by the supervisor at the
        ``decide``/``adopt`` seams and by ``Trainer.init_or_restore`` at
        the ``restore`` seam, which counts only while
        :attr:`recovering`. The record borrows the last step the step
        hook saw and carries the phase."""
        if phase not in FAULT_PHASES:
            raise ValueError(f"unknown fault phase {phase!r} "
                             f"(want one of {FAULT_PHASES})")
        if phase == "restore" and not self.recovering:
            return
        step = self._last_step
        for ev in self.events:
            if ev.fired or ev.phase != phase:
                continue
            if ev.kind == "ckpt_corrupt":
                # The drill exercises the FALLBACK walk: it fires only
                # when an older candidate exists to fall back to.
                from dml_cnn_cifar10_tpu_torch.ckpt import \
                    checkpoint as ckpt_lib
                if len(ckpt_lib.all_checkpoint_steps(log_dir)) < 2:
                    continue
                path = corrupt_latest_checkpoint(log_dir)
                if path is None:
                    continue
                ev.fired = True
                self._log(logger, step, ev.kind, phase=phase, path=path)
            elif ev.kind == "sigterm":
                ev.fired = True
                self._log(logger, step, ev.kind, phase=phase)
                os.kill(os.getpid(), signal.SIGTERM)
            elif ev.kind == "data_stall":
                ev.fired = True
                self._log(logger, step, ev.kind, phase=phase)
                raise DataStallError(
                    f"injected data stall at recovery phase {phase!r}")
            elif ev.kind == "host_lost":
                ev.fired = True
                self._log(logger, step, ev.kind, phase=phase)
                if logger is not None:
                    logger.flush()
                if cluster is not None:
                    cluster.flush_replicas()
                os._exit(EXIT_HOST_LOST)
            elif ev.kind == "heartbeat_stall":
                _needs_cluster(cluster, f"{ev.kind}@{phase}")
                ev.fired = True
                self._log(logger, step, ev.kind, phase=phase)
                cluster.stall_heartbeats()
            elif ev.kind == "decision_corrupt":
                _needs_cluster(cluster, f"{ev.kind}@{phase}")
                ev.fired = True
                path = corrupt_decision_file(cluster)
                self._log(logger, step, ev.kind, phase=phase, path=path)
