"""Deterministic network-fault state for the coordination transport.

A copy of ``dml_cnn_cifar10_tpu/utils/netfaults.py`` (it imports nothing
of JAX; the port keeps its own copy). The file-backed coordination store
(``parallel/cluster.py``) cannot be partitioned, delayed or lossy: the
filesystem either works or the whole simulation is dead. The network
transport (``parallel/net.py``) can, and this module is the one source of
truth for *which* fault is armed against *whom*: the
:class:`~dml_cnn_cifar10_tpu_torch.parallel.net.CoordServer` consults
:func:`server_action` once a request (beats, decision files, replica
pushes).

Fault kinds (armed by ``--fault_spec`` entries in ``utils/faults.py``,
which POST them to the server's ``/fault`` endpoint, or directly by
:func:`arm` in an in-process simulation):

- ``net_partition`` — requests from the isolated process ids are HELD:
  the server never answers, like a switch that ate the reply packets.
  The client's socket timeout is the only thing that bounds the hang,
  which is the hardening the chaos oracle's ``no_net_timeout`` plant
  strips. Heals after ``PARTITION_HEAL_S``: requests arriving after the
  heal are answered, held ones never are.
- ``net_delay`` — every request from the isolated ids is answered
  ``DELAY_PER_REQUEST_S`` late for ``DELAY_WINDOW_S``.
- ``net_drop`` — every second request from the isolated ids is answered
  ``503 injected_drop`` for ``DROP_WINDOW_S`` (the client's bounded
  retries must absorb it).
- ``net_dup`` — writes from the isolated ids are applied twice for
  ``DUP_WINDOW_S`` (the store's atomic-replace commits make the
  duplicate invisible).

All state is process-local and deterministic: the chaos schedule's fault
steps say when, this module says what.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

#: The network-fault vocabulary (mirrored into faults.FAULT_KINDS).
NET_FAULT_KINDS = ("net_partition", "net_delay", "net_drop", "net_dup")

#: Partition duration: long enough that the isolated side declares its
#: peers dead (peer_dead_after_s is 2.5s in the sims) and runs the full
#: classify → evict → rejoin arc, short enough that the heal lands well
#: inside the rejoin wait budget.
PARTITION_HEAL_S = 6.0

#: Per-request added latency and window of a ``net_delay``.
DELAY_PER_REQUEST_S = 0.25
DELAY_WINDOW_S = 2.0

#: Window of a ``net_drop`` (every 2nd request 503s inside it).
DROP_WINDOW_S = 2.0

#: Window of a ``net_dup`` (writes applied twice inside it).
DUP_WINDOW_S = 2.0

_DURATIONS = {"net_partition": PARTITION_HEAL_S,
              "net_delay": DELAY_WINDOW_S,
              "net_drop": DROP_WINDOW_S,
              "net_dup": DUP_WINDOW_S}

_lock = threading.Lock()
_faults: List[dict] = []


def arm(kind: str, isolate: Sequence[int],
        duration_s: Optional[float] = None,
        now: Optional[float] = None) -> dict:
    """Arm one fault against the ``isolate`` process ids; returns the
    armed record (kind, isolate, duration_s, until). Unknown kinds fail
    loudly — a typo'd drill that silently injects nothing would void
    the test it was written for."""
    if kind not in NET_FAULT_KINDS:
        raise ValueError(f"unknown net fault kind {kind!r} "
                         f"(want one of {NET_FAULT_KINDS})")
    now = time.time() if now is None else now
    duration = _DURATIONS[kind] if duration_s is None else float(duration_s)
    rec = {"kind": kind, "isolate": sorted(int(p) for p in isolate),
           "duration_s": duration, "until": now + duration,
           "armed_at": now, "n": 0}
    with _lock:
        _faults.append(rec)
    return rec


def clear() -> None:
    """Disarm everything (test/sim teardown)."""
    with _lock:
        _faults.clear()


def active(now: Optional[float] = None) -> List[dict]:
    """Currently-armed faults; expired ones are pruned as a side
    effect (held partition connections stay held — the hold loop keys
    on :func:`is_isolated` going false, i.e. on this prune)."""
    now = time.time() if now is None else now
    with _lock:
        _faults[:] = [f for f in _faults if f["until"] > now]
        return list(_faults)


def _match(kind: str, pid: Optional[int],
           now: Optional[float] = None) -> Optional[dict]:
    for f in active(now):
        if f["kind"] != kind:
            continue
        if pid is None or not f["isolate"] or pid in f["isolate"]:
            return f
    return None


def is_isolated(pid: Optional[int],
                now: Optional[float] = None) -> bool:
    """True while a ``net_partition`` covering ``pid`` is active (the JAX
    package's fleet router reads it too; the port has no router yet)."""
    return _match("net_partition", pid, now) is not None


def server_action(pid: Optional[int],
                  now: Optional[float] = None) -> tuple:
    """What the coordination server should do with one request from
    ``pid``: ``("hold",)`` never answer (partition), ``("drop",)``
    answer 503 (every 2nd request inside a drop window), ``("delay",
    secs)`` answer late, ``("dup",)`` apply writes twice, ``("ok",)``
    proceed. Checked once per request, in severity order."""
    if is_isolated(pid, now):
        return ("hold",)
    f = _match("net_drop", pid, now)
    if f is not None:
        with _lock:
            f["n"] += 1
            n = f["n"]
        if n % 2 == 1:
            return ("drop",)
    f = _match("net_delay", pid, now)
    if f is not None:
        return ("delay", DELAY_PER_REQUEST_S)
    if _match("net_dup", pid, now) is not None:
        return ("dup",)
    return ("ok",)


def snapshot() -> Dict[str, list]:
    """Read-only view for telemetry/debugging."""
    return {"active": [dict(f) for f in active()]}
