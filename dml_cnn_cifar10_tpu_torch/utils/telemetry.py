"""Latency statistics for the serving path.

The two functions of ``dml_cnn_cifar10_tpu/utils/telemetry.py`` that
serving reads (``percentile`` and ``latency_summary``, copied); its span
tracer and device-memory snapshot are not ported.
"""

from __future__ import annotations


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
