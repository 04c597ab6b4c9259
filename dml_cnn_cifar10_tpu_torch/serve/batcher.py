"""Dynamic micro-batcher: single-image requests -> padded bucket batches.

Port of ``dml_cnn_cifar10_tpu/serve/batcher.py``. One image is the unit a
request arrives in, a large batch the unit the card runs well; a short
coalescing window over a thread-safe queue reconciles them:

- Clients :meth:`MicroBatcher.submit` one image and get a
  ``concurrent.futures.Future`` of its logits row.
- One worker thread takes the first waiting request, then keeps
  collecting until the largest bucket is full or ``batch_window_s`` has
  passed: under load batches are full, and a lone request waits at most
  one window.
- The batch is padded with zero images up to the SMALLEST bucket that
  fits (e.g. 1/8/32/128): the engine holds one captured CUDA graph a
  bucket (``serve/engine.py``). Rows are computed independently by the
  eval forward, and only the first ``n_real`` rows go back to futures, so
  padding never leaks into a real response.
- The worker sets the engine's card as its thread's current device before
  its first batch (the current CUDA device is per thread).

Overload is shed, not buffered: admission control bounds the queue
(``submit`` raises :class:`ShedError` when it is full), and a request may
carry a deadline: one whose deadline passed while queued fails with
:class:`ShedError` at dispatch rather than taking device lanes nobody is
waiting for. The JAX package's per-tenant tier shedding (an autopilot
action) is not ported.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

import torch

from dml_cnn_cifar10_tpu_torch.serve.engine import ServingEngine
from dml_cnn_cifar10_tpu_torch.serve.metrics import ServeMetrics
from dml_cnn_cifar10_tpu_torch.utils import reqtrace


class ShedError(RuntimeError):
    """Request shed by admission control (``queue_full``), deadline
    expiry (``deadline``), or server shutdown (``shutdown``)."""

    def __init__(self, reason: str):
        super().__init__(f"request shed: {reason}")
        self.reason = reason


class VersionedLogits(np.ndarray):
    """A logits row tagged with the model ``version`` that computed it.

    Still a plain ndarray for every numeric purpose; the tag is what lets
    the HTTP front end put ``"version"`` in each response, making a
    checkpoint hot-swap observable end to end."""

    version: Optional[str] = None


def _versioned_row(row, version) -> VersionedLogits:
    out = np.array(row).view(VersionedLogits)
    out.version = version
    return out


class _Request:
    __slots__ = ("image", "future", "t_enqueue", "deadline", "trace")

    def __init__(self, image, future, t_enqueue, deadline, trace=None):
        self.image = image
        self.future = future
        self.t_enqueue = t_enqueue
        self.deadline = deadline
        self.trace = trace


class MicroBatcher:
    """Thread-safe coalescing request queue in front of a
    :class:`ServingEngine`.

    ``buckets`` must be ascending positive batch sizes; the largest is
    the max batch per dispatch. ``batch_window_s`` is the maximum extra
    latency coalescing may add to the request at the head of a batch.
    ``default_deadline_s`` (None = no deadline) applies to submits that
    don't carry their own.
    """

    def __init__(self, engine: ServingEngine,
                 buckets: Sequence[int] = (1, 8, 32, 128),
                 max_queue_depth: int = 256,
                 batch_window_s: float = 0.002,
                 default_deadline_s: Optional[float] = None,
                 metrics: Optional[ServeMetrics] = None,
                 warmup: bool = True,
                 logger=None):
        bs = [int(b) for b in buckets]
        if not bs or any(b <= 0 for b in bs) or sorted(set(bs)) != bs:
            raise ValueError(
                f"buckets must be ascending positive ints, got {buckets}")
        self.engine = engine
        self.buckets = tuple(bs)
        self.batch_window_s = float(batch_window_s)
        self.default_deadline_s = default_deadline_s
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.logger = logger
        self._q: "queue.Queue[_Request]" = queue.Queue(
            maxsize=int(max_queue_depth))
        self._stop = threading.Event()
        if warmup:
            self.compile_secs = engine.warmup(self.buckets)
        else:
            self.compile_secs = {}
        self._worker = threading.Thread(target=self._run,
                                        name="microbatcher", daemon=True)
        self._worker.start()

    # --- client side ---

    def submit(self, image: np.ndarray,
               deadline_s: Optional[float] = None,
               trace: Optional[reqtrace.TraceContext] = None) -> Future:
        """Enqueue one ``uint8 [H, W, C]`` image; returns a Future of
        its ``[K]`` logits row. Raises :class:`ShedError` at once when
        the queue is at depth (admission control) or the server is
        stopping. ``trace`` is the request's trace context; a shed forces
        it, so shed requests appear even at sample rate 0."""
        image = np.asarray(image)
        if image.shape != self.engine.image_shape \
                or image.dtype != np.uint8:
            raise ValueError(
                f"expected uint8 image of shape {self.engine.image_shape}, "
                f"got {image.dtype} {image.shape}")
        if self._stop.is_set():
            raise ShedError("shutdown")
        now = time.perf_counter()
        dl = deadline_s if deadline_s is not None else self.default_deadline_s
        req = _Request(image, Future(), now,
                       None if dl is None else now + dl, trace)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self.metrics.record_shed("queue_full")
            if trace is not None:
                trace.force()
                reqtrace.emit_span(self.logger, trace, "batcher", 0.0,
                                   reqtrace.wallclock_at(now),
                                   shed="queue_full")
            raise ShedError("queue_full") from None
        self.metrics.record_submit()
        return req.future

    def queue_depth(self) -> int:
        """Requests currently waiting (approximate — the queue is live).
        Published in ``/healthz`` so a prober sees backpressure without
        submitting traffic."""
        return self._q.qsize()

    def close(self, drain: bool = True) -> None:
        """Stop admitting; by default let the worker drain what is
        already queued, otherwise fail queued requests with
        ``ShedError("shutdown")``."""
        self._stop.set()
        if not drain:
            while True:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    break
                self.metrics.record_shed("shutdown")
                req.future.set_exception(ShedError("shutdown"))
        self._worker.join()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful-shutdown close: stop admitting, let already-queued
        batches finish for at most ``timeout`` seconds, then shed
        whatever is still waiting. Returns True when everything queued
        completed inside the deadline. The queue hand-off is race-free:
        each request is popped by exactly one side (worker dispatch or
        the shed sweep), so no future resolves twice."""
        self._stop.set()
        self._worker.join(timeout)
        if not self._worker.is_alive():
            return True
        self.close(drain=False)
        return False

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- worker side ---

    def _pick_bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _collect(self):
        """One batch's worth of requests: first request (blocking poll),
        then coalesce until the largest bucket fills or the window
        closes."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        t_close = time.perf_counter() + self.batch_window_s
        while len(batch) < self.buckets[-1]:
            remaining = t_close - time.perf_counter()
            if remaining <= 0:
                # Past the window, still take whatever is already queued
                # (free fill, no extra wait).
                try:
                    batch.append(self._q.get_nowait())
                    continue
                except queue.Empty:
                    break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _dispatch(self, batch) -> None:
        t_start = time.perf_counter()
        live = []
        for r in batch:
            if r.deadline is not None and t_start > r.deadline:
                self.metrics.record_shed("deadline")
                if r.trace is not None:
                    r.trace.force()
                    reqtrace.emit_span(
                        self.logger, r.trace, "batcher",
                        t_start - r.t_enqueue,
                        reqtrace.wallclock_at(r.t_enqueue),
                        shed="deadline")
                r.future.set_exception(ShedError("deadline"))
            else:
                live.append(r)
        if not live:
            return
        bucket = self._pick_bucket(len(live))
        padded = np.zeros((bucket, *self.engine.image_shape), np.uint8)
        for i, r in enumerate(live):
            padded[i] = r.image
        try:
            # The versioned forward: each response carries the weights
            # version that computed it, so a hot-swap shows end to end.
            logits, device_s, version = \
                self.engine.forward_timed_versioned(padded)
        except Exception as e:
            # A device failure must not strand clients on futures that
            # never resolve; the error reaches every one of them.
            for r in live:
                r.future.set_exception(e)
            return
        self.metrics.record_batch(bucket, len(live), device_s)
        t_done = time.perf_counter()
        emitting = [r for r in live
                    if r.trace is not None and r.trace.emit]
        if emitting and self.logger is not None:
            # One batch span causally linked (via batch_id) to its N
            # member spans: the coalescing penalty each member paid in
            # the queue is visible per request, while the batch span
            # carries the shared device context once.
            batch_id = os.urandom(4).hex()
            reqtrace.emit_span(
                self.logger,
                reqtrace.TraceContext(batch_id, True), "batch",
                t_done - t_start, reqtrace.wallclock_at(t_start),
                n=len(live), bucket=bucket,
                device_ms=round(device_s * 1e3, 3), version=version)
            for r in emitting:
                reqtrace.emit_span(
                    self.logger, r.trace, "batcher",
                    t_start - r.t_enqueue,
                    reqtrace.wallclock_at(r.t_enqueue),
                    batch_id=batch_id, version=version)
                reqtrace.emit_span(
                    self.logger, r.trace, "engine", device_s,
                    reqtrace.wallclock_at(t_start),
                    batch_id=batch_id, version=version)
        for i, r in enumerate(live):
            self.metrics.record_done(t_done - r.t_enqueue,
                                     t_start - r.t_enqueue)
            r.future.set_result(_versioned_row(logits[i], version))

    def _run(self) -> None:
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)
        while True:
            batch = self._collect()
            if batch:
                self._dispatch(batch)
            elif self._stop.is_set():
                return
