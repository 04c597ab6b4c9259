"""Deterministic fault injection at the training loop's step seam.

A trimmed copy of ``dml_cnn_cifar10_tpu/utils/faults.py``: the spec
grammar (``--fault_spec "nan@120,ckpt_corrupt@200,sigterm@300"``) and the
four kinds that fire at the dispatch seam of ``Trainer.fit``, each ONCE at
the first seam where the global step reaches its trigger:

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
  for a wedged input pipeline.

Every injection logs a ``fault`` record (``injected: true``). The JAX
module's cluster and network kinds and its ``@phase`` triggers belong to
the supervisor and the cluster layer, which are not ported: they raise
``NotImplementedError`` naming ROADMAP.md Queue 1 item 5. Unknown kinds
and malformed entries raise ``ValueError``, as in the JAX module.
"""

from __future__ import annotations

import dataclasses
import os
import signal
from typing import List, Optional, Sequence

import torch

#: The kinds this module fires (the step seam of one trainer).
FAULT_KINDS = ("nan", "ckpt_corrupt", "sigterm", "data_stall")

#: The JAX module's other kinds and its recovery-phase triggers.
_QUEUED_KINDS = ("heartbeat_stall", "host_lost", "collective_hang",
                 "host_return", "decision_corrupt", "replica_corrupt",
                 "replica_stale", "net_partition", "net_delay",
                 "net_drop", "net_dup")
_QUEUED_PHASES = ("restore", "adopt", "decide")
_QUEUE_ITEM = ("ROADMAP.md Queue 1 item 5 (the supervisor, the cluster "
               "layer and their fault kinds)")


class InjectedFault(RuntimeError):
    """Base class for failures raised (not merely caused) by injection."""


class DataStallError(InjectedFault):
    """Injected stand-in for a wedged or failed input pipeline."""


@dataclasses.dataclass
class FaultEvent:
    kind: str
    step: int
    fired: bool = False

    @property
    def trigger(self) -> str:
        return str(self.step)


def parse_fault_spec(spec: str) -> List[FaultEvent]:
    """``"kind@step,kind@step,..."`` → fault events in (step, kind) order,
    the JAX parser's (several faults at one step fire by kind). Unknown
    kinds and malformed entries raise ``ValueError``; the JAX module's
    kinds and phase triggers that are not ported raise
    ``NotImplementedError``."""
    events = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        kind, sep, trigger = entry.partition("@")
        kind, trigger = kind.strip(), trigger.strip()
        if sep and (kind in _QUEUED_KINDS or trigger in _QUEUED_PHASES):
            raise NotImplementedError(
                f"fault spec entry {entry!r} is not ported to PyTorch "
                f"(the port fires {FAULT_KINDS} at a training step); see "
                f"{_QUEUE_ITEM}")
        if not sep or kind not in FAULT_KINDS:
            raise ValueError(
                f"bad fault spec entry {entry!r}: want kind@step with "
                f"kind in {FAULT_KINDS}")
        try:
            step = int(trigger)
        except ValueError:
            raise ValueError(
                f"bad fault spec entry {entry!r}: trigger {trigger!r} is "
                f"not an integer step") from None
        if step < 0:
            raise ValueError(f"bad fault spec entry {entry!r}: negative "
                             f"step")
        events.append(FaultEvent(kind, step))
    return sorted(events, key=lambda e: (e.step, e.kind))


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


class FaultInjector:
    """One-shot, step-keyed fault firing at the training loop's dispatch
    seam (``Trainer.fit`` calls :meth:`step_hook` once a dispatch)."""

    def __init__(self, events: List[FaultEvent]):
        self.events = events

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
                  chief: bool = True):
        """Fire every due, unfired event; returns ``state`` (poisoned in
        place by ``nan``). ``ckpt_corrupt`` stays pending until a
        checkpoint exists, and only the chief, which writes the
        checkpoints, truncates one. ``data_stall`` raises after marking
        itself fired."""
        for ev in self.events:
            if ev.fired or step < ev.step:
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
        return state
