#!/usr/bin/env python
"""Load generator for the port's serving path: closed- or open-loop
traffic, or traffic MIXES, with a JSON report.

The port's own copy of ``tools/loadgen.py``. Two drive modes:

- **closed** (default): ``--concurrency`` client threads each submit one
  request, wait for its result and submit the next: the throughput is
  whatever the engine sustains at that concurrency.
- **open**: requests arrive on a fixed ``--qps`` schedule whatever the
  completions: past capacity the queue grows until admission control
  sheds, and the report's ``shed_fraction`` says so.

Mixes (``--mix``), open loop, one report row each:

- ``steady``: constant ``--qps``;
- ``diurnal``: a half-sine ramp 25% → 100% → 25% of ``--qps``;
- ``burst``: alternating 2x / 0.2x ``--qps`` phases of an eighth of the
  duration each;
- ``adversarial``: the steady rate with 25% of the requests malformed
  (a wrong byte count, or a wrong image shape in process): rejects are
  counted apart (``rejected``) and must not disturb the rest.

Two targets:

- in-process (default): a port ``ServingEngine`` built here, on
  ``--device`` (the card unless ``--device cpu``): ``--artifact PATH``
  serves an ``export.py`` artifact, otherwise a fresh model from
  ``--seed`` (``--model``, geometry from ``--image_size`` and
  ``--crop_size``);
- ``--target http://host:port``: a running ``--mode serve`` server over
  HTTP (raw-bytes ``POST /predict``, one persistent connection a client
  thread), transport included.

Requests replay CIFAR test images (``--source dataset``, raw uint8 from
the records) or random pixels (``--source random``). ``--check_labels``
drives the images of an npz instead and checks each response's class
against its label. The report (``--report``) carries the achieved qps,
the latency percentiles, ``shed_fraction``, ``errors`` (any failure that
is neither a shed nor a reject), batch fill (in process) and
``version_mix``: the responses counted by the model version that
answered, which shows a hot-swap from the client side.

Usage:
    python -m dml_cnn_cifar10_tpu_torch.tools.loadgen --mode closed \\
        --concurrency 8 --duration_s 10
    python -m dml_cnn_cifar10_tpu_torch.tools.loadgen --mode open \\
        --qps 500 --deadline_ms 50 --artifact /tmp/logs/model.pt2
    python -m dml_cnn_cifar10_tpu_torch.tools.loadgen --mix \\
        diurnal,burst,adversarial --qps 200 --target http://localhost:8000
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import sys
import threading
import time

#: Oversize fraction of the adversarial mix.
ADVERSARIAL_OVERSIZE = 0.25

#: mix name -> rate multiplier over u = elapsed/duration in [0, 1].
MIX_RATE = {
    "steady": lambda u: 1.0,
    "diurnal": lambda u: 0.25 + 0.75 * math.sin(math.pi * u),
    "burst": lambda u: 2.0 if int(u * 8) % 2 == 0 else 0.2,
    "adversarial": lambda u: 1.0,
}


def build_engine(args):
    """The in-process engine: the artifact, or a fresh model."""
    import torch

    from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    from dml_cnn_cifar10_tpu_torch.serve.engine import ServingEngine
    from dml_cnn_cifar10_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    if args.artifact:
        return ServingEngine.from_artifact(args.artifact, device)
    model_cfg = ModelConfig(name=args.model, logit_relu=False)
    data_cfg = DataConfig(image_height=args.image_size,
                          image_width=args.image_size,
                          crop_height=args.crop_size,
                          crop_width=args.crop_size, normalize="scale")
    model = get_model(args.model)(model_cfg, data_cfg)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    params = {n: p.detach() for n, p in model.named_parameters()}
    params.update((n, b.detach()) for n, b in model.named_buffers())
    return ServingEngine.from_params(model, data_cfg, params, device)


def load_images(args, image_shape):
    """``[N, H, W, C]`` uint8 request pool."""
    import numpy as np

    if args.source == "dataset":
        from dml_cnn_cifar10_tpu_torch.config import DataConfig
        from dml_cnn_cifar10_tpu_torch.data import ensure_dataset, test_files
        from dml_cnn_cifar10_tpu_torch.data.pipeline import _load_split

        h, w, c = image_shape
        cfg = DataConfig(dataset=args.dataset, data_dir=args.data_dir,
                         image_height=h, image_width=w, num_channels=c,
                         synthetic_test_records=512)
        ensure_dataset(cfg)
        images, _ = _load_split(test_files(cfg), cfg)
        return images
    rng = np.random.default_rng(args.seed)
    return rng.integers(0, 256, (256, *image_shape), dtype=np.uint8)


def load_check_set(path):
    """``--check_labels``: ``(images, {sha1(image bytes): label})`` from
    an npz with ``images`` [N, H, W, C] uint8 and ``labels`` [N], keyed by
    the request body's digest because the drive loops walk the pool
    concurrently."""
    import numpy as np

    with np.load(path) as z:
        images = np.ascontiguousarray(z["images"]).astype(np.uint8)
        labels = np.asarray(z["labels"]).astype(np.int64)
    if images.ndim != 4 or images.shape[0] != labels.shape[0]:
        raise SystemExit(
            f"--check_labels: want images [N,H,W,C] + labels [N], got "
            f"images {images.shape} / labels {labels.shape}")
    by_digest = {hashlib.sha1(images[i].tobytes()).hexdigest():
                 int(labels[i]) for i in range(images.shape[0])}
    return images, by_digest


class ClientStats:
    """Client-side accounting shared by every drive mode."""

    def __init__(self):
        self.lock = threading.Lock()
        self.completed = 0
        self.shed = 0
        self.rejected = 0
        self.errors = 0
        self.error_kinds = {}
        self.label_checked = 0
        self.label_correct = 0
        self.latencies = []
        self.samples = []   # (latency_s, trace_id, version) per completion
        self.versions = {}

    def record(self, outcome: str, dt: float = 0.0, version=None,
               trace_id=None, correct=None, error=None):
        with self.lock:
            if outcome == "ok":
                self.completed += 1
                self.latencies.append(dt)
                self.samples.append((dt, trace_id, version))
                if version is not None:
                    key = str(version)
                    self.versions[key] = self.versions.get(key, 0) + 1
                if correct is not None:
                    self.label_checked += 1
                    self.label_correct += int(correct)
            elif outcome == "shed":
                self.shed += 1
            elif outcome == "rejected":
                self.rejected += 1
            else:
                self.errors += 1
                key = str(error)[:120]
                self.error_kinds[key] = self.error_kinds.get(key, 0) + 1


class HttpClient:
    """Blocking ``POST /predict`` against a serve worker, one persistent
    HTTP/1.1 connection a client thread."""

    def __init__(self, target: str):
        from urllib.parse import urlsplit

        url = urlsplit(target)
        self.host, self.port = url.hostname, url.port or 80
        self._local = threading.local()

    def _connection(self):
        import http.client

        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._local.conn = http.client.HTTPConnection(
                self.host, self.port, timeout=60)
        return conn

    def predict(self, body: bytes, trace_header=None):
        """``("ok", payload)`` | ``("shed", None)`` | ``("rejected",
        None)``; any other answer raises. A kept connection the server
        has closed is opened again once (a prediction is idempotent)."""
        import http.client

        from dml_cnn_cifar10_tpu_torch.utils import reqtrace

        headers = {"Content-Type": "application/octet-stream"}
        if trace_header:
            headers[reqtrace.TRACE_HEADER] = trace_header
        for attempt in (0, 1):
            conn = self._connection()
            try:
                conn.request("POST", "/predict", body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                break
            except (http.client.HTTPException, ConnectionError):
                conn.close()
                self._local.conn = None
                if attempt:
                    raise
        if resp.status == 200:
            return "ok", json.loads(data)
        if resp.status == 503:
            return "shed", None
        if resp.status == 400:
            return "rejected", None
        raise RuntimeError(f"HTTP {resp.status}: {data[:200]!r}")


def run_closed(submit, images, args, stats):
    """``--concurrency`` threads in submit → wait → repeat lockstep."""
    stop_at = time.perf_counter() + args.duration_s
    counter = {"i": 0}
    lock = threading.Lock()

    def worker():
        while time.perf_counter() < stop_at:
            with lock:
                idx = counter["i"] = (counter["i"] + 1) % len(images)
            submit(images[idx], stats, False)
    threads = [threading.Thread(target=worker)
               for _ in range(args.concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def run_open(submit, images, args, stats, rate_fn=None,
             oversize_frac: float = 0.0):
    """Open-loop arrivals: each request on its own short-lived thread, so
    a slow engine cannot slow the arrival schedule. ``rate_fn(u)`` scales
    ``--qps`` over normalized elapsed time (the mixes); ``oversize_frac``
    of the arrivals are malformed."""
    import numpy as np

    rate_fn = rate_fn or MIX_RATE["steady"]
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    t_end = t0 + args.duration_s
    pending = []
    i = 0
    next_at = t0
    while next_at < t_end:
        now = time.perf_counter()
        if now < next_at:
            time.sleep(next_at - now)
        oversize = bool(oversize_frac) and rng.random() < oversize_frac
        img = images[i % len(images)]
        i += 1
        th = threading.Thread(target=submit, args=(img, stats, oversize))
        th.start()
        pending.append(th)
        rate = max(args.qps * rate_fn((next_at - t0) / args.duration_s),
                   1e-6)
        next_at += 1.0 / rate
    for th in pending:
        th.join(timeout=60)


def _row(stats: ClientStats, wall: float) -> dict:
    from dml_cnn_cifar10_tpu_torch.utils.telemetry import latency_summary

    total = stats.completed + stats.shed
    lat = latency_summary(stats.latencies)
    slowest = sorted(stats.samples, key=lambda s: -s[0])[:5]
    row = {
        "requests": total,
        "completed": stats.completed,
        "shed": stats.shed,
        "rejected": stats.rejected,
        "errors": stats.errors,
        "error_kinds": dict(stats.error_kinds),
        "shed_fraction": round(stats.shed / total, 4) if total else 0.0,
        "achieved_qps": round(stats.completed / wall, 2) if wall else 0.0,
        "latency_ms": {
            "p50": lat["p50_ms"], "p95": lat["p95_ms"],
            "p99": lat["p99_ms"], "mean": lat["mean_ms"],
            "max": lat["max_ms"],
        },
        "version_mix": dict(stats.versions),
        "slowest": [{"latency_ms": round(dt * 1e3, 3),
                     "trace_id": tid, "version": ver}
                    for dt, tid, ver in slowest],
    }
    if stats.label_checked:
        row["label_checked"] = stats.label_checked
        row["accuracy"] = round(
            stats.label_correct / stats.label_checked, 4)
    return row


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dml_cnn_cifar10_tpu_torch.tools.loadgen",
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=["closed", "open"], default="closed")
    ap.add_argument("--mix", type=str, default=None,
                    help="comma-separated traffic mixes to run (steady, "
                         "diurnal, burst, adversarial), one report row "
                         "each; open-loop drive, --mode is ignored")
    ap.add_argument("--concurrency", type=int, default=8,
                    help="closed-loop client threads")
    ap.add_argument("--qps", type=float, default=100.0,
                    help="open-loop arrival rate (mixes scale it)")
    ap.add_argument("--duration_s", type=float, default=10.0,
                    help="duration per profile (each mix runs this long)")
    ap.add_argument("--deadline_ms", type=float, default=None)
    ap.add_argument("--buckets", type=str, default="1,8,32,128")
    ap.add_argument("--queue_depth", type=int, default=256)
    ap.add_argument("--batch_window_ms", type=float, default=2.0)
    ap.add_argument("--artifact", type=str, default=None,
                    help="serve this export.py artifact instead of a "
                         "fresh-initialized model")
    ap.add_argument("--target", type=str, default=None,
                    help="drive a running --mode serve HTTP endpoint "
                         "instead of an in-process engine")
    ap.add_argument("--device", type=str, default="cuda",
                    help="in-process engine's device: cuda (default; "
                         "raises without a card) or cpu")
    ap.add_argument("--model", type=str, default="cnn")
    ap.add_argument("--image_size", type=int, default=32)
    ap.add_argument("--crop_size", type=int, default=24)
    ap.add_argument("--source", choices=["random", "dataset"],
                    default="random")
    ap.add_argument("--check_labels", type=str, default=None,
                    help="npz with images [N,H,W,C] uint8 + labels [N]: "
                         "drive THESE images and check each response's "
                         "class against its label; the report gains "
                         "accuracy and label_checked")
    ap.add_argument("--dataset", type=str, default="synthetic")
    ap.add_argument("--data_dir", type=str, default="cifar10data")
    ap.add_argument("--metrics_jsonl", type=str, default=None,
                    help="also append JSONL records: client rspan spans "
                         "(both targets) and serve/serve_done windows "
                         "(in process)")
    ap.add_argument("--trace_sample_rate", type=float, default=0.0,
                    help="head-sample this fraction of requests for "
                         "tracing (rspan records; shed requests are "
                         "always captured)")
    ap.add_argument("--report", type=str, default="loadgen_report.json")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np

    from dml_cnn_cifar10_tpu_torch.utils import reqtrace

    logger = None
    if args.metrics_jsonl:
        from dml_cnn_cifar10_tpu_torch.utils.logging import MetricsLogger
        logger = MetricsLogger(jsonl_path=args.metrics_jsonl)

    mixes = None
    if args.mix:
        mixes = [m.strip() for m in args.mix.split(",") if m.strip()]
        unknown = [m for m in mixes if m not in MIX_RATE]
        if unknown:
            raise SystemExit(f"unknown mix(es) {unknown}; choose from "
                             f"{sorted(MIX_RATE)}")

    batcher = None
    metrics = None
    labels_by_digest = None
    if args.target:
        client = HttpClient(args.target)
        rng = np.random.default_rng(args.seed)
        images = rng.integers(
            0, 256, (256, args.image_size, args.image_size, 3),
            dtype=np.uint8)
        if args.check_labels:
            images, labels_by_digest = load_check_set(args.check_labels)

        def submit(img, stats, oversize):
            # Oversize = a wrong byte count on the wire: the server must
            # answer 400 without disturbing well-formed requests.
            body = img.tobytes() + (b"\x00" if oversize else b"")
            ctx = reqtrace.mint(args.trace_sample_rate)
            t0 = time.perf_counter()
            try:
                outcome, payload = client.predict(
                    body, trace_header=ctx.header())
            except Exception as e:
                stats.record("error", error=repr(e))
                return
            dt = time.perf_counter() - t0
            version = (payload or {}).get("version")
            correct = None
            if labels_by_digest is not None and outcome == "ok":
                label = labels_by_digest.get(hashlib.sha1(body).hexdigest())
                if label is not None:
                    correct = payload.get("class") == label
            if outcome == "shed":
                ctx.force()
            reqtrace.emit_span(logger, ctx, "client", dt,
                               reqtrace.wallclock_at(t0),
                               outcome=outcome, version=version)
            stats.record(outcome, dt, version, trace_id=ctx.trace_id,
                         correct=correct)
    else:
        from dml_cnn_cifar10_tpu_torch.serve.batcher import (MicroBatcher,
                                                             ShedError)
        from dml_cnn_cifar10_tpu_torch.serve.metrics import ServeMetrics

        engine = build_engine(args)
        images = load_images(args, engine.image_shape)
        if args.check_labels:
            images, labels_by_digest = load_check_set(args.check_labels)
        metrics = ServeMetrics()
        buckets = tuple(int(b) for b in args.buckets.split(",") if b)
        batcher = MicroBatcher(
            engine, buckets=buckets, max_queue_depth=args.queue_depth,
            batch_window_s=args.batch_window_ms / 1e3,
            default_deadline_s=None if args.deadline_ms is None
            else args.deadline_ms / 1e3,
            metrics=metrics, logger=logger)
        print(f"[loadgen] engine ready on {engine.device} (warmup_s="
              f"{batcher.compile_secs}); driving for {args.duration_s}s "
              f"per profile", flush=True)

        def submit(img, stats, oversize):
            # Oversize = a wrong image shape: admission validation rejects
            # it before it can reach the queue.
            if oversize:
                img = np.zeros((img.shape[0] + 1, *img.shape[1:]),
                               np.uint8)
            ctx = reqtrace.mint(args.trace_sample_rate)
            t0 = time.perf_counter()
            try:
                row = batcher.submit(img, trace=ctx).result()
            except ShedError:
                dt = time.perf_counter() - t0
                ctx.force()
                reqtrace.emit_span(logger, ctx, "client", dt,
                                   reqtrace.wallclock_at(t0),
                                   outcome="shed")
                stats.record("shed", dt, trace_id=ctx.trace_id)
                return
            except ValueError:
                stats.record("rejected")
                return
            except Exception as e:
                stats.record("error", error=repr(e))
                return
            dt = time.perf_counter() - t0
            version = row.version
            correct = None
            if labels_by_digest is not None:
                label = labels_by_digest.get(
                    hashlib.sha1(img.tobytes()).hexdigest())
                if label is not None:
                    correct = int(np.asarray(row).argmax()) == label
            reqtrace.emit_span(logger, ctx, "client", dt,
                               reqtrace.wallclock_at(t0),
                               outcome="ok", version=version)
            stats.record("ok", dt, version, trace_id=ctx.trace_id,
                         correct=correct)

    def engine_side_stats(reset: bool) -> dict:
        if metrics is None:
            return {}
        return metrics.window(reset=True) if reset \
            else metrics.cumulative()

    loadgen_meta = {
        "mode": args.mode if mixes is None else "mix",
        "engine": "http" if args.target else "inprocess",
        "concurrency": args.concurrency,
        "target_qps": args.qps if (mixes or args.mode == "open")
        else None,
        "duration_s": args.duration_s,
        "deadline_ms": args.deadline_ms,
        "buckets": args.buckets,
        "queue_depth": args.queue_depth,
        "batch_window_ms": args.batch_window_ms,
        "source": args.source,
        "check_labels": args.check_labels,
        "seed": args.seed,
    }

    try:
        if mixes is None:
            stats = ClientStats()
            t0 = time.perf_counter()
            if args.mode == "closed":
                run_closed(submit, images, args, stats)
            else:
                run_open(submit, images, args, stats)
            wall = time.perf_counter() - t0
            report = {"loadgen": loadgen_meta, **_row(stats, wall)}
            engine_side = engine_side_stats(reset=False)
            for key in ("batch_fill", "batches", "queue_wait_p50_ms",
                        "device_p50_ms"):
                if key in engine_side:
                    report[key] = engine_side[key]
        else:
            rows = []
            for mix in mixes:
                print(f"[loadgen] mix {mix!r}: open loop, base qps "
                      f"{args.qps}, {args.duration_s}s", flush=True)
                stats = ClientStats()
                t0 = time.perf_counter()
                run_open(submit, images, args, stats,
                         rate_fn=MIX_RATE[mix],
                         oversize_frac=ADVERSARIAL_OVERSIZE
                         if mix == "adversarial" else 0.0)
                wall = time.perf_counter() - t0
                row = {"mix": mix, "duration_s": round(wall, 3),
                       **_row(stats, wall)}
                engine_side = engine_side_stats(reset=True)
                for key in ("batch_fill", "batches"):
                    if key in engine_side:
                        row[key] = engine_side[key]
                rows.append(row)
            report = {"loadgen": loadgen_meta, "mixes": rows}
    finally:
        if batcher is not None:
            batcher.close()
            if logger is not None:
                metrics.emit(logger, final=True)
        if logger is not None:
            logger.close()

    with open(args.report, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report))
    print(f"[loadgen] wrote {args.report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
