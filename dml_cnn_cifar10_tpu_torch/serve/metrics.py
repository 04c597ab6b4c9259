"""Serving telemetry: latency percentiles, batch fill and shed counts
on the JSONL stream.

A copy of ``dml_cnn_cifar10_tpu/serve/metrics.py``: what a request waited
for (queue against device), whether the batcher earns its keep (batch
fill), and whether admission control sheds instead of collapsing. One
:class:`ServeMetrics` is shared by the batcher's worker thread and every
client thread, all mutation under one lock; :meth:`ServeMetrics.emit`
writes ``serve`` window records and a final cumulative ``serve_done``
through ``MetricsLogger``, with the fields ``tools/check_jsonl_schema.py``
knows.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from dml_cnn_cifar10_tpu_torch.utils.metrics_registry import \
    default_registry
from dml_cnn_cifar10_tpu_torch.utils.telemetry import (latency_summary,
                                                       percentile)


class _Window:
    """One accumulation window's raw samples (no derived stats)."""

    __slots__ = ("submitted", "completed", "shed_queue", "shed_deadline",
                 "cache_hits", "latencies", "queue_waits", "device_secs",
                 "fills", "batches", "t0")

    def __init__(self):
        self.submitted = 0
        self.completed = 0
        self.shed_queue = 0
        self.shed_deadline = 0
        self.cache_hits = 0
        self.latencies = []       # submit -> result, seconds
        self.queue_waits = []     # submit -> dispatch start, seconds
        self.device_secs = []     # per batch
        self.fills = []           # real_rows / bucket per batch
        self.batches = 0
        self.t0 = time.perf_counter()


class ServeMetrics:
    """Thread-safe serving counters with windowed + cumulative views."""

    def __init__(self):
        self._lock = threading.Lock()
        self._win = _Window()
        self._total = _Window()

    # --- recording (called from client + worker threads) ---

    def record_submit(self) -> None:
        with self._lock:
            self._win.submitted += 1
            self._total.submitted += 1

    def record_cache_hit(self) -> None:
        """A request answered from the response cache — it bypassed the
        batcher, so it appears in ``cache_hit`` ONLY (not in
        requests/completed, which count batcher traffic)."""
        with self._lock:
            for w in (self._win, self._total):
                w.cache_hits += 1

    def record_shed(self, reason: str) -> None:
        field = "shed_queue" if reason == "queue_full" else "shed_deadline"
        with self._lock:
            for w in (self._win, self._total):
                setattr(w, field, getattr(w, field) + 1)

    def record_batch(self, bucket: int, n_real: int,
                     device_s: float) -> None:
        with self._lock:
            for w in (self._win, self._total):
                w.batches += 1
                w.device_secs.append(device_s)
                w.fills.append(n_real / bucket)

    def record_done(self, latency_s: float, queue_wait_s: float) -> None:
        with self._lock:
            for w in (self._win, self._total):
                w.completed += 1
                w.latencies.append(latency_s)
                w.queue_waits.append(queue_wait_s)
        # Live-export histogram (GET /metrics): the windowed JSONL
        # records carry percentiles only — a Prometheus consumer wants
        # the raw distribution. Host-side dict work per completion.
        default_registry().histogram(
            "dml_serve_latency_ms",
            "End-to-end request latency (submit -> result)"
        ).observe(latency_s * 1e3)

    # --- reporting ---

    @staticmethod
    def _snapshot(w: _Window, now: float) -> dict:
        span = max(now - w.t0, 1e-9)
        lat = latency_summary(w.latencies)
        qw50 = percentile(w.queue_waits, 50)
        dev50 = percentile(w.device_secs, 50)
        dev99 = percentile(w.device_secs, 99)
        return {
            "requests": w.submitted,
            "completed": w.completed,
            "shed_queue": w.shed_queue,
            "shed_deadline": w.shed_deadline,
            "cache_hit": w.cache_hits,
            "qps": round(w.completed / span, 2),
            "p50_ms": lat["p50_ms"],
            "p95_ms": lat["p95_ms"],
            "p99_ms": lat["p99_ms"],
            "max_ms": lat["max_ms"],
            "queue_wait_p50_ms":
                None if qw50 is None else round(qw50 * 1e3, 3),
            "device_p50_ms":
                None if dev50 is None else round(dev50 * 1e3, 3),
            "device_p99_ms":
                None if dev99 is None else round(dev99 * 1e3, 3),
            "batches": w.batches,
            "batch_fill":
                round(sum(w.fills) / len(w.fills), 4) if w.fills else None,
            "window_s": round(span, 3),
        }

    def window(self, reset: bool = True) -> dict:
        """Stats since the last window reset (the periodic serve record)."""
        with self._lock:
            out = self._snapshot(self._win, time.perf_counter())
            if reset:
                self._win = _Window()
        return out

    def cumulative(self) -> dict:
        """Run-lifetime stats (the ``serve_done`` / report payload)."""
        with self._lock:
            out = self._snapshot(self._total, time.perf_counter())
        total = (out["completed"] + out["shed_queue"]
                 + out["shed_deadline"])
        out["shed_fraction"] = round(
            (out["shed_queue"] + out["shed_deadline"]) / total, 4) \
            if total else 0.0
        return out

    def emit(self, logger, final: bool = False) -> None:
        """Write one ``serve`` window record (and, when ``final``, the
        cumulative ``serve_done``) through ``MetricsLogger``."""
        if logger is None:
            return
        # wallclock: serve-only streams have no heartbeat records, so
        # these windows are the clock-alignment anchor that lets
        # tools/trace_aggregate.py place this stream on the merged
        # timeline.
        logger.log("serve", **self.window(reset=True),
                   wallclock=time.time())
        if final:
            done = self.cumulative()
            done["total_s"] = done.pop("window_s")
            logger.log("serve_done", **done, wallclock=time.time())
