"""PyTorch port, serve/ + tools/loadgen.py on the CPU.

The batcher's contract against a stub engine, as the JAX package's
``tests/test_serve.py`` pins it (bucket choice and padding isolation,
bursts split at the largest bucket, bad submits and buckets, queue-full
and deadline shedding, drain and its deadline); the live engine's
hot-swap (version tags flip, a mismatched candidate is rejected with a
``swap_rejected`` record, the weights are never overwritten under a batch
still running on them); the ``--mode serve`` server over HTTP on every
route with a graceful drain, a schema-clean stream and kept connections
that stay in step after an error reply; the port's load
generator; and the metrics registry's exposition against the JAX
package's for the same records.
"""

import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu.utils import metrics_registry as jax_registry
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              TrainConfig)
from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
from dml_cnn_cifar10_tpu_torch.serve import (MicroBatcher, ServeMetrics,
                                             ServingEngine, ShedError)
from dml_cnn_cifar10_tpu_torch.serve.cache import ResponseCache
from dml_cnn_cifar10_tpu_torch.utils import metrics_registry
from dml_cnn_cifar10_tpu_torch.utils.logging import MetricsLogger
from tools import check_jsonl_schema

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_exp():
    """One ``torch.exp`` before the module's tests: with torch 2.13.0+cpu
    (MKL 2024.2, AVX-512) the first ``exp`` of a freshly started worker
    process can be off by 1.5e-4 relative when several workers start
    together, and is exact from the second call on (ROADMAP.md Queue 3)."""
    torch.exp(torch.linspace(-10.0, 0.0, 1 << 16))


class StubEngine:
    """Deterministic fake device: logits row i = [sum(image i), lane i],
    so any cross-lane leak or misrouting shows up as a wrong sum."""

    image_shape = (2, 2, 1)
    device = torch.device("cpu")
    version = "stub"

    def __init__(self, forward_s: float = 0.0, gate: threading.Event = None):
        self.batch_sizes = []
        self.forward_s = forward_s
        self.gate = gate

    def warmup(self, buckets):
        return {}

    def forward_timed_versioned(self, batch):
        if self.gate is not None:
            self.gate.wait(timeout=10)
        if self.forward_s:
            time.sleep(self.forward_s)
        self.batch_sizes.append(batch.shape[0])
        logits = np.stack(
            [np.array([float(batch[i].sum()), float(i)], np.float32)
             for i in range(batch.shape[0])])
        return logits, self.forward_s, self.version


def _stub_images(n, shape=(2, 2, 1), seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, *shape), dtype=np.uint8)


def test_bucket_selection_and_padding_isolation():
    eng = StubEngine()
    with MicroBatcher(eng, buckets=(1, 4, 16), batch_window_s=0.2,
                      warmup=False) as b:
        imgs = _stub_images(6)
        res = [f.result(timeout=10) for f in [b.submit(im) for im in imgs]]
    # One window, padded to the smallest bucket that fits (16, not 4).
    assert eng.batch_sizes == [16]
    for i, (im, r) in enumerate(zip(imgs, res)):
        assert r[0] == float(im.sum()) and r[1] == float(i)
        assert r.version == "stub"
    snap = b.metrics.cumulative()
    assert snap["completed"] == 6 and snap["batches"] == 1
    assert snap["batch_fill"] == pytest.approx(6 / 16)


def test_oversized_burst_splits_at_max_bucket():
    eng = StubEngine()
    with MicroBatcher(eng, buckets=(1, 4), batch_window_s=0.2,
                      warmup=False) as b:
        for f in [b.submit(im) for im in _stub_images(6, seed=1)]:
            f.result(timeout=10)
    assert eng.batch_sizes == [4, 4]


def test_bad_submit_and_bad_buckets_rejected():
    eng = StubEngine()
    with MicroBatcher(eng, buckets=(1,), warmup=False) as b:
        with pytest.raises(ValueError, match="shape"):
            b.submit(np.zeros((3, 3, 1), np.uint8))
        with pytest.raises(ValueError, match="shape"):
            b.submit(np.zeros((2, 2, 1), np.int32))
    for bad in ((4, 1), (), (0, 2), (2, 2)):
        with pytest.raises(ValueError, match="buckets"):
            MicroBatcher(eng, buckets=bad, warmup=False)


def test_queue_full_sheds_at_admission():
    gate = threading.Event()
    metrics = ServeMetrics()
    b = MicroBatcher(StubEngine(gate=gate), buckets=(1,), max_queue_depth=1,
                     batch_window_s=0.0, metrics=metrics, warmup=False)
    try:
        f1 = b.submit(_stub_images(1)[0])     # dequeued, wedged on gate
        time.sleep(0.1)
        b.submit(_stub_images(1)[0])          # fills the 1-deep queue
        with pytest.raises(ShedError) as exc:
            b.submit(_stub_images(1)[0])
        assert exc.value.reason == "queue_full"
        assert metrics.cumulative()["shed_queue"] == 1
    finally:
        gate.set()
        b.close()
    assert f1.result(timeout=10) is not None


def test_deadline_expired_requests_shed_at_dispatch():
    gate = threading.Event()
    metrics = ServeMetrics()
    b = MicroBatcher(StubEngine(gate=gate), buckets=(1,), max_queue_depth=8,
                     batch_window_s=0.0, metrics=metrics, warmup=False)
    try:
        b.submit(_stub_images(1)[0])          # wedges the worker
        time.sleep(0.05)
        doomed = b.submit(_stub_images(1)[0], deadline_s=0.01)
        time.sleep(0.05)
    finally:
        gate.set()
        b.close()
    with pytest.raises(ShedError, match="deadline"):
        doomed.result(timeout=10)
    snap = metrics.cumulative()
    assert snap["shed_deadline"] == 1 and snap["completed"] == 1


def test_batcher_drain_completes_queued_work():
    b = MicroBatcher(StubEngine(), buckets=(1, 4), max_queue_depth=64,
                     batch_window_s=0.001)
    futs = [b.submit(img) for img in _stub_images(8)]
    assert b.drain(timeout=5.0) is True
    assert all(f.done() and f.exception() is None for f in futs)
    with pytest.raises(ShedError, match="shutdown"):
        b.submit(_stub_images(1)[0])


def test_batcher_drain_deadline_sheds_backlog():
    b = MicroBatcher(StubEngine(forward_s=0.25), buckets=(1,),
                     max_queue_depth=64, batch_window_s=0.0)
    futs = [b.submit(img) for img in _stub_images(6)]
    assert b.drain(timeout=0.3) is False
    ok = sum(1 for f in futs if f.exception() is None)
    shed = sum(1 for f in futs if isinstance(f.exception(), ShedError))
    assert ok >= 1 and shed >= 1 and ok + shed == len(futs)


def test_serve_metrics_jsonl_schema(tmp_path):
    metrics = ServeMetrics()
    with MicroBatcher(StubEngine(), buckets=(1, 4), batch_window_s=0.05,
                      metrics=metrics, warmup=False) as b:
        for f in [b.submit(im) for im in _stub_images(3, seed=2)]:
            f.result(timeout=10)
    path = str(tmp_path / "serve.jsonl")
    logger = MetricsLogger(jsonl_path=path)
    metrics.emit(logger)
    metrics.emit(logger, final=True)
    logger.close()
    assert check_jsonl_schema.check_file(path, strict=True) == []
    kinds = [json.loads(l)["kind"] for l in open(path)]
    assert kinds == ["serve", "serve", "serve_done"]


# ---- the live engine on the CPU -----------------------------------------

DATA = DataConfig(normalize="standardize")


def _cnn_params(seed):
    model = CNN(ModelConfig(logit_relu=False), DATA)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model, {n: p.detach().clone() for n, p in model.named_parameters()}


def _images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3),
                                                dtype=np.uint8)


@pytest.fixture
def live():
    model, params = _cnn_params(0)
    return ServingEngine.from_params(model, DATA, params, "cpu", version="1")


def test_serve_equals_direct_forward(live):
    imgs = _images(5, seed=1)
    with MicroBatcher(live, buckets=(1, 8), batch_window_s=0.25) as b:
        served = [f.result(timeout=60) for f in [b.submit(im)
                                                 for im in imgs]]
    assert b.metrics.cumulative()["batches"] == 1
    padded = np.zeros((8, 32, 32, 3), np.uint8)
    padded[:5] = imgs
    direct, _ = live.forward_timed(padded)
    for i in range(5):
        assert served[i].version == "1"
        np.testing.assert_array_equal(served[i], direct[i])


def test_zero_padding_stays_finite_and_cannot_leak(live):
    """A zero pad image standardizes by the 1/sqrt(n) floor, not 0/0; and
    other pad content leaves the real rows' logits as they were."""
    imgs = _images(3, seed=2)
    zeros_pad = np.zeros((8, 32, 32, 3), np.uint8)
    zeros_pad[:3] = imgs
    full_pad = np.full((8, 32, 32, 3), 255, np.uint8)
    full_pad[:3] = imgs
    a, _ = live.forward_timed(zeros_pad)
    c, _ = live.forward_timed(full_pad)
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a[:3], c[:3], rtol=1e-6, atol=1e-6)


def test_try_swap_flips_versions_and_serves_the_new_weights(tmp_path):
    model, p0 = _cnn_params(0)
    _, p1 = _cnn_params(1)
    path = str(tmp_path / "swap.jsonl")
    logger = MetricsLogger(jsonl_path=path)
    eng = ServingEngine.from_params(model, DATA, p0, "cpu", version="10",
                                    logger=logger)
    ref0 = ServingEngine.from_params(model, DATA, p0, "cpu")
    ref1 = ServingEngine.from_params(model, DATA, p1, "cpu")
    imgs = _images(4, seed=3)
    for version, params, ref in (("20", p1, ref1), ("30", p0, ref0),
                                 ("40", p1, ref1)):
        assert eng.try_swap(params, version=version) == (True, "swapped")
        got, _, tag = eng.forward_timed_versioned(imgs)
        assert tag == version == eng.version
        np.testing.assert_array_equal(got, ref.forward_timed(imgs)[0])
    assert eng.swap_count == 3
    logger.close()
    recs = [json.loads(l) for l in open(path)]
    assert [(r["from_version"], r["version"]) for r in recs] == [
        ("10", "20"), ("20", "30"), ("30", "40")]
    assert check_jsonl_schema.check_file(path, strict=True) == []


def test_try_swap_rejects_a_mismatched_candidate(tmp_path, live):
    path = str(tmp_path / "reject.jsonl")
    live.logger = MetricsLogger(jsonl_path=path)
    imgs = _images(2, seed=4)
    before, _ = live.forward_timed(imgs)
    wide = CNN(ModelConfig(logit_relu=False, num_classes=12), DATA)
    ok, reason = live.try_swap(dict(wide.named_parameters()), version="2")
    assert not ok and "full3" in reason
    _, good = _cnn_params(1)
    del good["conv1.bias"]
    ok, reason = live.try_swap(good, version="3")
    assert not ok and "conv1.bias" in reason
    _, half = _cnn_params(1)
    ok, reason = live.try_swap({n: t.double() for n, t in half.items()},
                               version="4")
    assert not ok and "float64" in reason
    live.logger.close()
    assert live.version == "1" and live.swap_count == 0
    np.testing.assert_array_equal(live.forward_timed(imgs)[0], before)
    recs = [json.loads(l) for l in open(path)]
    assert [r["kind"] for r in recs] == ["swap_rejected"] * 3
    assert [r["version"] for r in recs] == ["2", "3", "4"]
    assert check_jsonl_schema.check_file(path, strict=True) == []


def test_artifact_engine_is_not_swappable(tmp_path):
    from dml_cnn_cifar10_tpu_torch import export as export_lib

    model, params = _cnn_params(0)
    path = str(tmp_path / "model.pt2")
    export_lib.save_exported(path, export_lib.export_forward(model, DATA))
    art = ServingEngine.from_artifact(path, "cpu")
    ok, reason = art.try_swap(params, version="9")
    assert not ok and "not swappable" in reason and art.version == "artifact"


def test_swap_never_overwrites_a_slot_under_a_running_batch():
    """A batch still running keeps the old weights to its end: a swap
    started meanwhile waits for it under the run lock, the batch's logits
    and tag are the old version's, and the next batch runs the new
    weights under the new tag."""
    model, p0 = _cnn_params(0)
    _, p1 = _cnn_params(1)
    eng = ServingEngine.from_params(model, DATA, p0, "cpu", version="0")
    imgs = _images(2, seed=5)
    want_old, _ = ServingEngine.from_params(model, DATA, p0, "cpu") \
        .forward_timed(imgs)
    want_new, _ = ServingEngine.from_params(model, DATA, p1, "cpu") \
        .forward_timed(imgs)
    entered, release = threading.Event(), threading.Event()
    run = eng._run

    def gated(x, params):
        out = run(x, params)
        if threading.current_thread().name == "inflight":
            entered.set()
            assert release.wait(30)
        return out

    eng._run = gated
    result, swapped = {}, {}
    batch = threading.Thread(name="inflight", target=lambda: result.update(
        out=eng.forward_timed_versioned(imgs)))
    batch.start()
    assert entered.wait(30)
    swap = threading.Thread(target=lambda: swapped.update(
        ok=eng.try_swap(p1, version="1")))
    swap.start()
    time.sleep(0.3)
    assert swap.is_alive() and eng.version == "0"     # waits on the batch
    assert all(torch.equal(eng._params[n], p0[n]) for n in p0)
    release.set()
    batch.join(30)
    swap.join(30)
    assert not batch.is_alive() and not swap.is_alive()
    assert swapped["ok"] == (True, "swapped")
    logits, _, tag = result["out"]
    assert tag == "0"
    np.testing.assert_array_equal(logits, want_old)
    assert eng.version == "1"
    assert all(torch.equal(eng._params[n], p1[n]) for n in p1)
    logits, _, tag = eng.forward_timed_versioned(imgs)
    assert tag == "1"
    np.testing.assert_array_equal(logits, want_new)


def test_response_cache_flushes_on_a_version_change():
    cache = ResponseCache(2)
    cache.store(b"a", "1", {"class": 1})
    cache.store(b"b", "1", {"class": 2})
    assert cache.lookup(b"a", "1") == {"class": 1}
    cache.store(b"c", "1", {"class": 3})              # evicts b (LRU)
    assert cache.lookup(b"b", "1") is None
    assert cache.lookup(b"a", "2") is None and len(cache) == 0
    assert cache.flushes == 1
    with pytest.raises(ValueError):
        ResponseCache(0)


@pytest.mark.parametrize("kind,fields", [
    ("serve", dict(requests=5, completed=4, shed_queue=1, shed_deadline=0,
                   cache_hit=2, qps=3.5, p50_ms=1.25, p99_ms=None,
                   batch_fill=0.5)),
    ("compile", dict(key=None, phase="serve_warmup", hit=False,
                     compile_s=0.75, source="uncached")),
    ("serve_done", dict(requests=5, completed=4, shed_fraction=0.2)),
], ids=["serve", "compile", "serve_done"])
def test_registry_renders_what_the_jax_registry_renders(kind, fields):
    ours, theirs = (metrics_registry.MetricsRegistry(),
                    jax_registry.MetricsRegistry())
    for _ in range(2):
        metrics_registry.observe_record(kind, fields, registry=ours)
        jax_registry.observe_record(kind, fields, registry=theirs)
    ours.histogram("dml_serve_latency_ms", "latency").observe(3.0)
    theirs.histogram("dml_serve_latency_ms", "latency").observe(3.0)
    assert ours.render() == theirs.render()
    jax_registry.parse_prometheus_text(ours.render())


# ---- the server and the load generator ----------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve_cfg(tmp_path, buckets):
    """A ``--mode serve`` config on the CPU: a fresh CNN served live."""
    cfg = TrainConfig(log_dir=str(tmp_path / "logs"), device="cpu",
                      metrics_jsonl=str(tmp_path / "m.jsonl"))
    cfg.model.logit_relu = False
    cfg.serve.port = _free_port()
    cfg.serve.buckets = buckets
    return cfg


def _start_serve(cfg):
    """``main_serve`` in a thread, once it is ready: (thread, stop event,
    {"rc": exit code} once it returns)."""
    from dml_cnn_cifar10_tpu_torch.serve.server import main_serve

    ready, stop = threading.Event(), threading.Event()
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault("rc", main_serve(
        cfg, ready_event=ready, stop_event=stop)), daemon=True)
    t.start()
    assert ready.wait(120), "server never became ready"
    return t, stop, rc


def test_main_serve_routes_drain_and_stream(tmp_path):
    """``--mode serve`` on the CPU with no artifact and no checkpoint:
    fresh weights served live at version 0, every route answered, a
    graceful drain on stop, a ``serve_done`` record, and a stream that
    passes the strict schema lint. The port's load generator drives it
    over HTTP meanwhile."""
    from dml_cnn_cifar10_tpu_torch.tools import loadgen

    cfg = _serve_cfg(tmp_path, (1, 4))
    cfg.serve.metrics_every_s = 0.2
    cfg.serve.cache_size = 8
    cfg.serve.trace_sample_rate = 1.0
    t, stop, rc = _start_serve(cfg)
    url = f"http://127.0.0.1:{cfg.serve.port}"

    status, body = _get(url + "/healthz")
    health = json.loads(body)
    assert status == 200 and health["version"] == "0"
    assert health["image_shape"] == [32, 32, 3] and health["buckets"] == [1, 4]
    img = _images(1, seed=6)[0].tobytes()
    status, first = _post(url + "/predict", img)
    assert status == 200 and first["version"] == "0"
    assert first["class"] == int(np.argmax(first["logits"]))
    assert _post(url + "/predict", img) == (200, first)     # a cache hit
    status, err = _post(url + "/predict", img[:-1])
    assert status == 400 and "3072" in err["error"]
    assert _post(url + "/nope", img)[0] == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(url + "/nope")
    assert e.value.code == 404
    report = str(tmp_path / "report.json")
    assert loadgen.main(["--target", url, "--mode", "closed",
                         "--concurrency", "2", "--duration_s", "0.5",
                         "--report", report]) == 0
    rep = json.load(open(report))
    assert rep["completed"] > 0 and rep["errors"] == 0
    assert rep["version_mix"] == {"0": rep["completed"]}
    stats = json.loads(_get(url + "/stats")[1])
    # The first request and its cache hit, then loadgen's (its pool of
    # 256 random images may repeat: those repeats are cache hits too).
    assert stats["completed"] + stats["cache_hit"] == rep["completed"] + 2
    assert stats["cache_hit"] >= 1
    status, text = _get(url + "/metrics")
    fams = jax_registry.parse_prometheus_text(text.decode())
    assert "dml_serve_latency_ms" in fams

    stop.set()
    t.join(60)
    assert not t.is_alive() and rc["rc"] == 0
    recs = [json.loads(l) for l in open(cfg.metrics_jsonl)]
    kinds = [r["kind"] for r in recs]
    assert kinds.count("compile") == 2 and kinds[-1] == "serve_done"
    assert recs[-1]["completed"] == stats["completed"]
    assert {r["hop"] for r in recs if r["kind"] == "rspan"} >= {
        "server", "batcher", "engine", "batch"}
    assert check_jsonl_schema.check_file(cfg.metrics_jsonl,
                                         strict=True) == []


def test_kept_connection_stays_in_step_after_an_error_reply(tmp_path):
    """HTTP/1.1 keeps the connection: a POST to a wrong path or with a
    wrong byte count is answered after its body is read, so the next
    request on the same connection parses and is served."""
    cfg = _serve_cfg(tmp_path, (1,))
    t, stop, rc = _start_serve(cfg)
    img = _images(1, seed=7)[0].tobytes()
    conn = http.client.HTTPConnection("127.0.0.1", cfg.serve.port,
                                      timeout=60)
    try:
        for path, body, code in (("/nope", img, 404),
                                 ("/predict", img[:-5], 400),
                                 ("/predict", img, 200),
                                 ("/nope", img, 404),
                                 ("/predict", img, 200)):
            conn.request("POST", path, body=body)
            r = conn.getresponse()
            reply = json.loads(r.read())
            assert r.status == code, (path, reply)
            if code == 200:
                assert reply["version"] == "0"
    finally:
        conn.close()
        stop.set()
        t.join(60)
    assert not t.is_alive() and rc["rc"] == 0


def test_loadgen_closed_loop_smoke(tmp_path):
    from dml_cnn_cifar10_tpu_torch.tools import loadgen

    report_path = str(tmp_path / "report.json")
    jsonl_path = str(tmp_path / "serve.jsonl")
    assert loadgen.main([
        "--device", "cpu", "--mode", "closed", "--concurrency", "2",
        "--duration_s", "0.5", "--buckets", "1,8",
        "--report", report_path, "--metrics_jsonl", jsonl_path]) == 0
    report = json.load(open(report_path))
    assert report["completed"] > 0 and report["errors"] == 0
    assert report["requests"] == report["completed"] + report["shed"]
    assert report["shed_fraction"] == 0.0 and report["achieved_qps"] > 0
    for q in ("p50", "p95", "p99"):
        assert report["latency_ms"][q] > 0
    assert 0.0 < report["batch_fill"] <= 1.0
    assert check_jsonl_schema.check_file(jsonl_path, strict=True) == []


def test_loadgen_open_loop_past_capacity_sheds(tmp_path):
    """Overload is shed, not buffered: a tight queue and deadline under an
    arrival rate past what the CPU engine sustains; the adversarial mix's
    malformed requests are rejected apart."""
    from dml_cnn_cifar10_tpu_torch.tools import loadgen

    report_path = str(tmp_path / "report.json")
    assert loadgen.main([
        "--device", "cpu", "--mix", "steady,adversarial", "--qps", "2000",
        "--duration_s", "0.5", "--buckets", "1,8", "--queue_depth", "4",
        "--deadline_ms", "2", "--report", report_path]) == 0
    steady, adversarial = json.load(open(report_path))["mixes"]
    assert steady["shed_fraction"] > 0 and steady["errors"] == 0
    assert adversarial["rejected"] > 0 and adversarial["errors"] == 0


def test_cli_serve_flags_plumb_into_config():
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)

    cfg = config_from_args(build_parser().parse_args([
        "--mode", "serve", "--serve_buckets", "2,16",
        "--serve_queue_depth", "7", "--serve_batch_window_ms", "3.5",
        "--serve_deadline_ms", "40", "--serve_port", "0",
        "--serve_artifact", "/x/model.pt2", "--serve_cache_size", "5",
        "--serve_metrics_every_s", "1.5", "--serve_drain_deadline_s", "2",
        "--trace_sample_rate", "0.5"]))
    s = cfg.serve
    assert (s.buckets, s.max_queue_depth, s.batch_window_ms, s.deadline_ms,
            s.port, s.artifact_path, s.cache_size, s.metrics_every_s,
            s.drain_deadline_s, s.trace_sample_rate) == (
        (2, 16), 7, 3.5, 40, 0, "/x/model.pt2", 5, 1.5, 2.0, 0.5)
    assert cfg.device == "cuda"           # the card unless asked otherwise
    with pytest.raises(SystemExit):
        config_from_args(build_parser().parse_args(
            ["--serve_buckets", "1,x"]))
