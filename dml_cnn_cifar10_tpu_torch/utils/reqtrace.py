"""Request tracing for the serving path.

A copy of ``dml_cnn_cifar10_tpu/utils/reqtrace.py``. One request, one
``trace_id``, minted at the client (the port's ``tools/loadgen.py``), or
by the serve HTTP handler for an external caller that sends no header,
and carried on the ``X-DML-Trace`` header: client → HTTP handler →
micro-batcher queue → engine dispatch. Each hop appends one ``rspan``
JSONL record to its process's stream; ``trace_id`` joins them and
``wallclock`` (unix seconds at the hop's start) places them on one clock.

Sampling is decided once, at the head (``--trace_sample_rate``), and the
decision rides in the header's ``s`` bit, so a sampled trace is whole. A
request that is shed flips :meth:`TraceContext.force`, so the interesting
requests are captured even at sample rate 0. Everything here is host
bookkeeping on numbers the hops already have: no device reads.
"""

from __future__ import annotations

import os
import random
import time
from typing import Optional

#: The propagation header: ``"<hex trace id>;s=<0|1>"`` where ``s`` is
#: the head-sampling decision (sampled OR forced at send time).
TRACE_HEADER = "X-DML-Trace"


class TraceContext:
    """One request's trace identity + sampling state.

    Shared BY REFERENCE across the threads a request crosses (HTTP
    handler thread, batcher dispatch thread): a downstream hop that
    forces the trace (shed, retry) makes every LATER span emit, which
    is exactly the forced-sample contract.
    """

    __slots__ = ("trace_id", "sampled", "forced")

    def __init__(self, trace_id: str, sampled: bool,
                 forced: bool = False):
        self.trace_id = trace_id
        self.sampled = bool(sampled)
        self.forced = bool(forced)

    @property
    def emit(self) -> bool:
        """Should spans for this trace be written?"""
        return self.sampled or self.forced

    def force(self) -> None:
        """Forced-sample override: the request was shed or retried —
        capture it regardless of the head-sampling decision."""
        self.forced = True

    def header(self) -> str:
        """Wire form for :data:`TRACE_HEADER` on the NEXT hop."""
        return f"{self.trace_id};s={1 if self.emit else 0}"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TraceContext({self.trace_id}, sampled={self.sampled}, "
                f"forced={self.forced})")


def mint(sample_rate: float = 0.0) -> TraceContext:
    """Client-side: new trace id + the head-sampling roll."""
    rate = max(0.0, min(1.0, float(sample_rate or 0.0)))
    sampled = rate >= 1.0 or (rate > 0.0 and random.random() < rate)
    return TraceContext(os.urandom(8).hex(), sampled)


def parse(header_value: Optional[str],
          sample_rate: float = 0.0) -> TraceContext:
    """Server-side: adopt the caller's trace context from the header,
    or mint one (an external caller without the header becomes the
    trace root at THIS hop). A malformed header also mints — tracing
    must never fail a request."""
    if not header_value:
        return mint(sample_rate)
    trace_id, _, rest = header_value.partition(";")
    trace_id = trace_id.strip()
    if not trace_id:
        return mint(sample_rate)
    sampled = False
    for part in rest.split(";"):
        k, _, v = part.partition("=")
        if k.strip() == "s":
            sampled = v.strip() == "1"
    return TraceContext(trace_id, sampled)


def wallclock_at(perf_t: float) -> float:
    """Unix seconds of a past ``time.perf_counter()`` reading — how the
    hops stamp span STARTS without carrying a second clock around."""
    return time.time() - (time.perf_counter() - perf_t)


def emit_span(logger, ctx: Optional[TraceContext], hop: str,
              dur_s: float, wallclock: float, **fields) -> None:
    """One ``rspan`` record, iff the trace is sampled-or-forced and a
    logger exists. ``dur_s`` is the hop's own latency contribution,
    ``wallclock`` the hop's absolute start time."""
    if logger is None or ctx is None or not ctx.emit:
        return
    logger.log("rspan", trace_id=ctx.trace_id, hop=hop,
               dur_ms=round(max(dur_s, 0.0) * 1e3, 3),
               wallclock=round(wallclock, 6), **fields)
