"""Run-health telemetry: host-loop spans, goodput accounting, the
card's memory, and the latency statistics serving reads.

A copy of ``dml_cnn_cifar10_tpu/utils/telemetry.py``:

- :class:`SpanTracer`: a ring-buffered context-manager tracer the trainer
  wraps around its host-loop phases (first dispatch and graph capture,
  data wait, dispatch, boundary drain, eval, checkpoint, the ranks'
  preemption exchange). Disabled, ``span()`` returns a shared no-op
  context manager: no allocation, no clock read. Finished spans go out as
  ``span`` records through ``MetricsLogger`` (:func:`flush_boundary`) and
  as a Chrome trace-event file (:meth:`SpanTracer.export_chrome_trace`).
- Goodput: top-level spans carry a category (``compile`` / ``data`` /
  ``eval`` / ``checkpoint`` / ``sync``); :meth:`SpanTracer.goodput` gives
  the fraction of wall-clock since the tracer epoch spent in each, with
  productive training as the remainder, so the fractions sum to 1. On the
  asynchronous paths a host data wait can overlap device work, so
  ``data_frac`` is an upper bound on the device's starvation.
- :func:`hbm_stats`: the process's device-memory snapshot from the CUDA
  caching allocator (``torch.cuda.memory_stats``: bytes allocated now and
  at peak, the card's total memory as the limit). A host query, no device
  read and no synchronization; on the CPU ``available=False`` with zeros.
- ``percentile`` and ``latency_summary``, which serving reads.

The training-health scalars are not computed here: they are computed in
the step (``parallel/step.py``, ``health_metrics``) and ride the
boundary's one device read. The JAX module's alert engine hook in
:func:`flush_boundary` is not ported (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Optional

# Category order pins the goodput report layout.
GOODPUT_CATEGORIES = ("compile", "data", "eval", "checkpoint", "sync")


class _NullSpan:
    """Shared no-op context manager: the disabled tracer's span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: Optional[str]):
        self._tracer = tracer
        self.name = name
        self.cat = cat

    def __enter__(self):
        self.t0 = time.perf_counter()
        self._tracer._depth += 1
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tr = self._tracer
        tr._depth -= 1
        tr._record(self.name, self.cat, self.t0, t1 - self.t0, tr._depth)
        return False


class SpanTracer:
    """Ring-buffered host-loop span tracer and goodput aggregator.

    ``with tracer.span("eval", cat="eval"): ...`` records one finished
    span. Only depth-0 spans with a category count toward goodput (a
    nested span's time is its parent's). The ring keeps the newest
    ``max_spans`` finished spans for the Chrome export; :meth:`drain`
    hands out, and forgets, the spans finished since the last drain.
    Overflow is counted (``dropped``), never silent.
    """

    def __init__(self, enabled: bool = True, max_spans: int = 65536):
        self.enabled = enabled
        self.max_spans = max_spans
        self.dropped = 0
        self._depth = 0
        # (name, cat, start_s, dur_s, depth) tuples; _ring feeds the
        # Chrome export, _pending the incremental JSONL flush.
        self._ring = collections.deque(maxlen=max_spans)
        self._pending = collections.deque(maxlen=max_spans)
        self._cat_secs = dict.fromkeys(GOODPUT_CATEGORIES, 0.0)
        self._epoch = time.perf_counter()
        self._wall_epoch = time.time()

    def start(self) -> None:
        """Reset the goodput epoch (at loop entry)."""
        self._epoch = time.perf_counter()
        self._wall_epoch = time.time()

    def span(self, name: str, cat: Optional[str] = None):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat)

    def _record(self, name, cat, t0, dur, depth) -> None:
        if len(self._ring) == self.max_spans \
                or len(self._pending) == self.max_spans:
            self.dropped += 1
        rec = (name, cat, t0 - self._epoch, dur, depth)
        self._ring.append(rec)
        self._pending.append(rec)
        if depth == 0 and cat is not None:
            self._cat_secs[cat] = self._cat_secs.get(cat, 0.0) + dur

    def drain(self) -> list:
        """Spans finished since the last drain (and forget them)."""
        out = list(self._pending)
        self._pending.clear()
        return out

    def goodput(self, now: Optional[float] = None) -> dict:
        """Cumulative goodput since the epoch: ``{total_s, train_frac,
        <cat>_frac...}``. ``train_frac`` is the unattributed remainder
        (dispatch, boundary drain and host logging count as productive:
        the device runs training steps meanwhile), so the fractions sum
        to 1. The remainder is taken from the rounded fractions, so the
        sum holds after rounding too (the JAX module rounds it alone and
        can miss 1 by a few 1e-6)."""
        total = max((now if now is not None else time.perf_counter())
                    - self._epoch, 1e-9)
        out = {"total_s": round(total, 4)}
        attributed = 0.0
        for cat in sorted(self._cat_secs):
            secs = min(self._cat_secs[cat], total - attributed)
            attributed += secs
            out[f"{cat}_frac"] = round(secs / total, 6)
        out["train_frac"] = round(
            1.0 - sum(out[f"{cat}_frac"] for cat in self._cat_secs), 6)
        return out

    def export_chrome_trace(self, path: str, pid: int = 0) -> None:
        """Write the retained spans as a Chrome trace-event JSON file
        (Perfetto or chrome://tracing); ``ts`` is microseconds since the
        tracer epoch."""
        events = [{"name": name, "ph": "X",
                   "ts": round(start * 1e6, 1),
                   "dur": round(dur * 1e6, 1),
                   "pid": pid, "tid": depth,
                   **({"cat": cat} if cat else {})}
                  for name, cat, start, dur, depth in self._ring]
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"epoch_unix_s": round(self._wall_epoch, 3),
                             "dropped_spans": self.dropped}}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)


def percentile(values, q: float):
    """Linearly-interpolated percentile (numpy's default method) of an
    UNSORTED sequence; ``None`` on empty input. Dependency-free so the
    serving hot path and ``tools/loadgen.py`` share one definition
    without importing numpy for a handful of floats."""
    if not values:
        return None
    vs = sorted(values)
    if len(vs) == 1:
        return vs[0]
    rank = (len(vs) - 1) * (q / 100.0)
    lo = int(rank)
    hi = min(lo + 1, len(vs) - 1)
    frac = rank - lo
    return vs[lo] * (1.0 - frac) + vs[hi] * frac


def latency_summary(seconds, prefix: str = "") -> dict:
    """p50/p95/p99/mean/max of a latency sample, in MILLISECONDS. Keys
    are ``{prefix}p50_ms`` etc.; all ``None`` when the sample is empty so
    JSONL records keep their required keys (null-valued, per the schema
    of ``tools/check_jsonl_schema.py``)."""
    if not seconds:
        return {f"{prefix}{k}": None
                for k in ("p50_ms", "p95_ms", "p99_ms", "mean_ms", "max_ms")}
    return {
        f"{prefix}p50_ms": round(percentile(seconds, 50) * 1e3, 3),
        f"{prefix}p95_ms": round(percentile(seconds, 95) * 1e3, 3),
        f"{prefix}p99_ms": round(percentile(seconds, 99) * 1e3, 3),
        f"{prefix}mean_ms": round(sum(seconds) / len(seconds) * 1e3, 3),
        f"{prefix}max_ms": round(max(seconds) * 1e3, 3),
    }


def hbm_stats(device=None) -> dict:
    """The process's device-memory snapshot: the CUDA caching allocator's
    bytes allocated now and at peak on ``device``, and the card's total
    memory as the limit. A host query of the allocator (no device read,
    no synchronization). Zeros with ``available=False`` for a CPU device
    or none, so the ``hbm`` record is written on every backend."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return {"available": False, "devices": 0, "bytes_in_use": 0,
                "peak_bytes": 0, "bytes_limit": 0}
    s = torch.cuda.memory_stats(device)
    return {"available": True, "devices": 1,
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(
                torch.cuda.get_device_properties(device).total_memory)}


def flush_boundary(tracer: SpanTracer, logger, step: int,
                   final: bool = False, device=None) -> None:
    """Write the boundary telemetry through ``MetricsLogger``: every span
    finished since the last flush, the cumulative goodput and a memory
    snapshot of ``device``. Host work only, no device read."""
    if not tracer.enabled:
        return
    for name, cat, start, dur, depth in tracer.drain():
        logger.log("span", step=step, name=name,
                   start_s=round(start, 4), dur_s=round(dur, 4),
                   depth=depth, **({"cat": cat} if cat else {}))
    gp = tracer.goodput()
    if tracer.dropped:
        gp["dropped_spans"] = tracer.dropped
    if final:
        gp["final"] = 1
    logger.log("goodput", step=step, **gp)
    logger.log("hbm", step=step, **hbm_stats(device))
