"""The ``--mode serve`` runtime: engine + batcher behind a stdlib HTTP
front end, with periodic telemetry flushes.

Port of ``dml_cnn_cifar10_tpu/serve/server.py``.
``http.server.ThreadingHTTPServer`` runs one thread a connection, and
each request thread parks on a batcher future (the real concurrency limit
is the bucket size, not the thread count). Unlike the JAX package's
server it speaks HTTP/1.1 with persistent connections, and listens with
a backlog of 1,024: with a connection a request and the default backlog
of 5, 32 to 128 clients on one host spent seconds a request in TCP
connects (``PERF.md``). The endpoints:

- ``POST /predict``: the body is one raw image, exactly ``H*W*C`` bytes
  of uint8 (the CIFAR on-disk pixel layout, row-major HWC). The reply is
  ``{"class": argmax, "logits": [...], "version": ...}``; 400 on a wrong
  byte count, 503 with the reason when the request is shed.
- ``GET /stats``: the cumulative :class:`ServeMetrics` snapshot.
- ``GET /healthz``: liveness, the version served, the queue depth and the
  engine's input contract.
- ``GET /metrics``: the process's registry in Prometheus text format
  (``utils/metrics_registry.py``), fed by the same ``serve`` window
  records the JSONL stream carries, plus the latency histogram.

What is served (:func:`resolve_engine`): an explicit
``serve.artifact_path`` must exist (a typo falling back to fresh weights
would serve garbage); else ``<log_dir>/model.pt2`` when present; else the
latest checkpoint is restored and served live, versioned with its step
and hot-swappable. The JAX package's alert engine, flight recorder and
compile cache are not ported.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from dml_cnn_cifar10_tpu_torch.serve.batcher import MicroBatcher, ShedError
from dml_cnn_cifar10_tpu_torch.serve.engine import ServingEngine
from dml_cnn_cifar10_tpu_torch.serve.metrics import ServeMetrics
from dml_cnn_cifar10_tpu_torch.utils import reqtrace


def _make_handler(batcher: MicroBatcher, metrics: ServeMetrics,
                  replica_id: int = 0, hop: str = "server",
                  logger=None, sample_rate: float = 0.0, cache=None):
    image_bytes = 1
    for d in batcher.engine.image_shape:
        image_bytes *= d
    started_at = time.time()

    class Handler(BaseHTTPRequestHandler):
        # Persistent connections (every reply carries its length): a
        # client pays the TCP connect once, not once a request. No Nagle:
        # the headers and the body are two writes, and the second must
        # not wait for the first's delayed ACK.
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_text(self, code: int, text: str) -> None:
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # access log -> metrics, not stderr
            pass

        def do_GET(self):
            if self.path == "/metrics":
                from dml_cnn_cifar10_tpu_torch.utils.metrics_registry \
                    import default_registry
                self._reply_text(200, default_registry().render())
            elif self.path == "/healthz":
                self._reply(200, {
                    "ok": True,
                    "replica_id": replica_id,
                    "version": batcher.engine.version,
                    "queue_depth": batcher.queue_depth(),
                    "uptime_s": round(time.time() - started_at, 3),
                    "image_shape": batcher.engine.image_shape,
                    "buckets": batcher.buckets})
            elif self.path == "/stats":
                self._reply(200, metrics.cumulative())
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            import numpy as np
            # The body is read before any reply: bytes left unread on a
            # kept connection would be parsed as the next request.
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            if self.path != "/predict":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            if len(body) != image_bytes:
                self._reply(400, {
                    "error": f"expected {image_bytes} raw uint8 bytes "
                             f"(HWC {batcher.engine.image_shape}), "
                             f"got {len(body)}"})
                return
            # The response cache, before the batcher: an exact hit under
            # the serving version answers at once. It flushes on any
            # version change, so a hot-swap never serves a stale answer.
            if cache is not None:
                hit = cache.lookup(
                    body, batcher.engine.version)
                if hit is not None:
                    metrics.record_cache_hit()
                    self._reply(200, hit)
                    return
            image = np.frombuffer(body, np.uint8).reshape(
                batcher.engine.image_shape)
            # Adopt the caller's trace context, or become the root. It is
            # shared with the batcher thread, so a shed there forces this
            # hop's span too.
            ctx = reqtrace.parse(self.headers.get(reqtrace.TRACE_HEADER),
                                 sample_rate)
            t0 = time.perf_counter()
            try:
                logits = batcher.submit(image, trace=ctx).result()
            except ShedError as e:
                reqtrace.emit_span(logger, ctx, hop,
                                   time.perf_counter() - t0,
                                   reqtrace.wallclock_at(t0),
                                   status=503, shed=e.reason,
                                   replica_id=replica_id)
                self._reply(503, {"shed": e.reason})
                return
            # The weights version that computed THIS response.
            version = logits.version
            payload = {"class": int(logits.argmax()),
                       "logits": [float(v) for v in logits],
                       "version": version}
            if cache is not None:
                cache.store(body, version, payload)
            reqtrace.emit_span(logger, ctx, hop,
                               time.perf_counter() - t0,
                               reqtrace.wallclock_at(t0),
                               status=200, version=version,
                               replica_id=replica_id)
            self._reply(200, payload)

    return Handler


class _Server(ThreadingHTTPServer):
    """The stdlib server with a listen backlog for many clients: the
    default of 5 pending connections makes a burst of clients wait for
    TCP's SYN retransmits (a second and up) instead of the batcher."""

    request_queue_size = 1024


class _MetricsFlusher(threading.Thread):
    """Periodic ``serve`` window records while the server runs."""

    def __init__(self, metrics: ServeMetrics, logger, every_s: float):
        super().__init__(name="serve-metrics", daemon=True)
        self._metrics = metrics
        self._logger = logger
        self._every = every_s
        self._stop = threading.Event()

    def run(self):
        while not self._stop.wait(self._every):
            self._metrics.emit(self._logger)

    def stop(self):
        self._stop.set()


def resolve_engine(cfg, logger=None, replica_id: int = 0) -> ServingEngine:
    """The artifact if one is configured or present, else the latest
    checkpoint's weights (the EMA when kept), served live and versioned
    with its step. On ``cfg.device``: the card unless the caller asks
    for the CPU."""
    from dml_cnn_cifar10_tpu_torch import export as export_lib
    from dml_cnn_cifar10_tpu_torch.utils.platform import resolve_device

    device = resolve_device(cfg.device)
    path = cfg.serve.artifact_path
    if path:
        if not os.path.exists(path):
            raise SystemExit(
                f"--serve_artifact {path} does not exist (refusing to "
                f"fall back to fresh weights)")
    else:
        path = os.path.join(cfg.log_dir, export_lib.ARTIFACT_NAME)
        if not os.path.exists(path):
            path = None
    if path is not None:
        return ServingEngine.from_artifact(path, device, logger=logger,
                                           replica_id=replica_id)
    model, params, step = export_lib.restore_serving_params(cfg, device)
    return ServingEngine.from_params(model, cfg.data, params, device,
                                     logger=logger, version=str(step),
                                     replica_id=replica_id)


def main_serve(cfg, task_index: int = 0,
               ready_event: Optional[threading.Event] = None,
               stop_event: Optional[threading.Event] = None,
               engine: Optional[ServingEngine] = None) -> int:
    """Blocking serve loop with a graceful SIGTERM/SIGINT drain.

    ``ready_event`` is set once the HTTP socket listens and every bucket
    is warm (captured on the card); tests and ``tools/loadgen.py
    --target`` wait on it. ``stop_event`` asks for the same graceful
    shutdown from another thread (where the signal guard is a no-op).
    ``engine`` serves a caller's engine instead of
    :func:`resolve_engine`'s (a caller that swaps weights into it).

    Shutdown (``utils/preemption.PreemptionGuard``): stop accepting, let
    queued batches finish for at most ``serve.drain_deadline_s``, shed the
    rest, flush the final ``serve_done`` record, return 0.
    """
    from dml_cnn_cifar10_tpu_torch.serve.cache import ResponseCache
    from dml_cnn_cifar10_tpu_torch.utils.logging import MetricsLogger
    from dml_cnn_cifar10_tpu_torch.utils.preemption import PreemptionGuard

    serve_cfg = cfg.serve
    # The logger before the engine: the bucket warm-up logs `compile`.
    logger = MetricsLogger(jsonl_path=cfg.metrics_jsonl,
                           task_index=task_index)
    if engine is None:
        engine = resolve_engine(cfg, logger=logger, replica_id=task_index)
    elif engine.logger is None:
        engine.logger = logger
    metrics = ServeMetrics()
    batcher = MicroBatcher(
        engine, buckets=serve_cfg.buckets,
        max_queue_depth=serve_cfg.max_queue_depth,
        batch_window_s=serve_cfg.batch_window_ms / 1e3,
        default_deadline_s=None if serve_cfg.deadline_ms is None
        else serve_cfg.deadline_ms / 1e3,
        metrics=metrics, logger=logger)
    print(f"[serve] engine={engine.source} on {engine.device} image_shape="
          f"{engine.image_shape} buckets={batcher.buckets} "
          f"warmup_s={batcher.compile_secs} version={engine.version}")

    response_cache = ResponseCache(serve_cfg.cache_size) \
        if serve_cfg.cache_size > 0 else None
    server = _Server(
        ("", serve_cfg.port),
        _make_handler(batcher, metrics, replica_id=task_index,
                      hop="server", logger=logger,
                      sample_rate=serve_cfg.trace_sample_rate,
                      cache=response_cache))
    flusher = _MetricsFlusher(metrics, logger, serve_cfg.metrics_every_s)
    flusher.start()
    # The accept loop runs on its own thread so the main thread can park
    # on the shutdown signals (signal handlers fire on the main thread).
    accept = threading.Thread(target=server.serve_forever,
                              name="serve-accept", daemon=True)
    drained = True
    try:
        with PreemptionGuard() as guard:
            accept.start()
            print(f"[serve] listening on :{server.server_address[1]} "
                  f"(POST /predict, GET /stats, GET /healthz, "
                  f"GET /metrics)", flush=True)
            if ready_event is not None:
                ready_event.set()
            try:
                while not guard.requested and (
                        stop_event is None or not stop_event.is_set()):
                    time.sleep(0.1)
                why = (f"signal {guard.signum}" if guard.requested
                       else "stop requested")
            except KeyboardInterrupt:
                why = "keyboard interrupt"
            print(f"[serve] {why}: draining in-flight batches "
                  f"(deadline {serve_cfg.drain_deadline_s:.1f}s)")
            server.shutdown()          # stop accepting; accept loop exits
            accept.join()
            drained = batcher.drain(timeout=serve_cfg.drain_deadline_s)
    finally:
        # Handler threads have resolved futures by now (a result or a
        # ShedError), so the close's thread join is bounded.
        server.server_close()
        flusher.stop()
        if batcher._worker.is_alive():   # drain never ran (startup crash)
            batcher.close()
        metrics.emit(logger, final=True)
        logger.flush()
        logger.close()
    print(f"[serve] exiting cleanly "
          f"({'drained' if drained else 'drain deadline hit; backlog shed'})")
    return 0
