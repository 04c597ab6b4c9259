"""Deterministic fault injection for exercising the recovery paths.

A copy of ``dml_cnn_cifar10_tpu/utils/faults.py`` without its chaos
sampler (``FaultSchedule``, which belongs to the chaos oracle) and the
kinds that need the peer replicas or the network transport. The spec
grammar is the JAX module's: ``--fault_spec "nan@120,ckpt_corrupt@200,
sigterm@300"`` fires each fault ONCE at the first dispatch seam of
``Trainer.fit`` where the global step reaches its trigger. The run
supervisor (``train/supervisor.py``) builds one injector and threads it
through every attempt, so a recovered run replaying the same steps does
not re-injure itself.

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
  flushed buffers (exit code :data:`EXIT_HOST_LOST`).
- ``collective_hang`` — block the main thread at the seam while the
  publisher keeps beating: a wedged collective. This process's watchdog
  ends it past ``collective_timeout_s``.
- ``host_return`` — hold the seam until a returning host's
  ``rejoin``-phase beat appears (or an expand was already granted), so
  the 2→1→2 elastic drill expands at a known step.
- ``decision_corrupt`` — overwrite the restart-decision file with a
  decodable but bogus decision and a mismatched sidecar; the hardened
  reader must classify it, never adopt it.

Recovery-phase triggers (``kind@phase``) fire inside the supervisor's
recovery paths instead of at a step, through :meth:`FaultInjector.
phase_hook`: ``@restore`` at the checkpoint-restore seam of a recovery
attempt (``Trainer.init_or_restore``; a fresh run's restore does not
count), ``@decide`` on the chief right after it commits a restart or
expand decision, ``@adopt`` on any seat right after it adopts one. The
kinds allowed there are :data:`PHASE_FAULT_KINDS`.

Every injection logs a ``fault`` record (``injected: true``). The JAX
module's ``replica_corrupt``, ``replica_stale`` and ``net_*`` kinds need
its peer replicas and its network transport, which are not ported: they
raise ``NotImplementedError`` naming ROADMAP.md Queue 1 item 5. Unknown
kinds and malformed entries raise ``ValueError``, as in the JAX module.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import List, Optional, Sequence

import torch

#: The kinds this module fires: the step seam's, then the cluster's.
FAULT_KINDS = ("nan", "ckpt_corrupt", "sigterm", "data_stall",
               "heartbeat_stall", "host_lost", "collective_hang",
               "host_return", "decision_corrupt")

#: The JAX module's kinds that need its peer replicas or its network
#: transport.
_QUEUED_KINDS = ("replica_corrupt", "replica_stale", "net_partition",
                 "net_delay", "net_drop", "net_dup")
_QUEUE_ITEM = ("ROADMAP.md Queue 1 item 5 (the rest of resilience: the "
               "peer replicas, the net transport, their fault kinds and "
               "the chaos oracle)")

#: Recovery-path seams a fault may be phase-qualified to (``kind@phase``),
#: owned by the supervisor and ``Trainer.init_or_restore``.
FAULT_PHASES = ("restore", "adopt", "decide")

#: Kinds that make sense at a phase seam (no train state to poison there,
#: and a blocking kind would deadlock the recovery itself).
PHASE_FAULT_KINDS = ("ckpt_corrupt", "sigterm", "data_stall",
                     "host_lost", "heartbeat_stall", "decision_corrupt")

#: Bounded wait for a ``host_return`` drill's returning host.
HOST_RETURN_TIMEOUT_S = 300.0

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
    :data:`FAULT_PHASES`. Unknown kinds, malformed entries and phase
    triggers on kinds outside :data:`PHASE_FAULT_KINDS` raise
    ``ValueError``; the kinds that need the peer replicas or the net
    transport raise ``NotImplementedError``."""
    events = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        kind, sep, trigger = entry.partition("@")
        kind, trigger = kind.strip(), trigger.strip()
        if sep and kind in _QUEUED_KINDS:
            raise NotImplementedError(
                f"fault spec entry {entry!r} needs the peer replicas or the "
                f"net transport, which are not ported to PyTorch; see "
                f"{_QUEUE_ITEM}")
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
