"""Live metrics: a process-local registry + Prometheus-text export.

A trimmed copy of ``dml_cnn_cifar10_tpu/utils/metrics_registry.py``:
thread-safe counters, gauges and histograms that ``GET /metrics`` on the
serve server renders in the standard text exposition format.

- **No new instrumentation.** The numbers are already in the JSONL
  records: :func:`observe_record` is the one translation table from
  record kinds to metrics, and ``MetricsLogger`` calls it for every
  record it writes (``utils/logging.py``). The one direct registry call
  is the serving latency histogram (``serve/metrics.py``), a number that
  never enters the stream.
- **Zero device traffic.** Everything here is host-side dict work.
- **Process-local.** One registry per process (:func:`default_registry`);
  aggregation is the scraper's job.

The kinds translated are the serving path's: ``serve`` windows and the
``compile`` records of its bucket warm-up. ``serve_done`` is the run's
cumulative record and updates nothing (its windows were counted). The
JAX package's training, fleet and runtime kinds, its text parser and its
stats HTTP thread (``StatsServer``) are not ported.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

#: Default histogram buckets (milliseconds: the one histogram is the
#: serving latency).
DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0, 2500.0)


def _fmt(v: float) -> str:
    """Prometheus-text float: integers render bare, specials by name."""
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for n, v in zip(names, values))
    return "{" + inner + "}"


class _Metric:
    """One named metric family: help text, type, per-label-set values."""

    def __init__(self, name: str, help_text: str, mtype: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_text
        self.type = mtype
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} wants labels {self.labelnames}, "
                f"got {sorted(labels)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def values(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._values)


class Counter(_Metric):
    """Monotone counter. ``inc`` by a non-negative delta."""

    def __init__(self, name, help_text, labelnames=()):
        super().__init__(name, help_text, "counter", labelnames)

    def inc(self, delta: float = 1.0, **labels) -> None:
        if delta < 0:
            return  # counters never go down; a bad delta is dropped
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + delta


class Gauge(_Metric):
    """Point-in-time value; the last ``set`` wins."""

    def __init__(self, name, help_text, labelnames=()):
        super().__init__(name, help_text, "gauge", labelnames)

    def set(self, value, **labels) -> None:
        if value is None:
            return  # null-valued JSONL fields simply don't update
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)


class Histogram(_Metric):
    """Cumulative-bucket histogram (the Prometheus shape: every bucket
    counts observations ≤ its bound, plus ``+Inf``/sum/count series)."""

    def __init__(self, name, help_text, labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_text, "histogram", labelnames)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._totals: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(key,
                                             [0] * len(self.buckets))
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + float(value)
            self._totals[key] = self._totals.get(key, 0) + 1

    def snapshot(self) -> Dict[Tuple[str, ...], dict]:
        with self._lock:
            return {key: {"buckets": list(self._counts[key]),
                          "sum": self._sums[key],
                          "count": self._totals[key]}
                    for key in self._counts}


class MetricsRegistry:
    """Thread-safe named-metric registry; ``render()`` is the
    ``/metrics`` payload. Registration is idempotent by name (the same
    seam may re-register across supervisor restart attempts)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name, help_text, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_text, labelnames=labelnames, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls) \
                    or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name} re-registered with a different "
                    f"type/labels ({m.type}{m.labelnames})")
            return m

    def counter(self, name, help_text="", labelnames=()) -> Counter:
        return self._register(Counter, name, help_text, labelnames)

    def gauge(self, name, help_text="", labelnames=()) -> Gauge:
        return self._register(Gauge, name, help_text, labelnames)

    def histogram(self, name, help_text="", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help_text, labelnames,
                              buckets=buckets)

    def render(self) -> str:
        """The standard text exposition format (version 0.0.4): HELP +
        TYPE comments, one ``name{labels} value`` line per series."""
        with self._lock:
            metrics = sorted(self._metrics.values(),
                             key=lambda m: m.name)
        lines: List[str] = []
        for m in metrics:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.type}")
            if isinstance(m, Histogram):
                for key, snap in sorted(m.snapshot().items()):
                    for bound, n in zip(m.buckets, snap["buckets"]):
                        lines.append(
                            m.name + "_bucket"
                            + _label_str(tuple(m.labelnames) + ("le",),
                                         key + (_fmt(bound),))
                            + f" {n}")
                    lines.append(
                        m.name + "_bucket"
                        + _label_str(tuple(m.labelnames) + ("le",),
                                     key + ("+Inf",))
                        + f" {snap['count']}")
                    lines.append(m.name + "_sum"
                                 + _label_str(m.labelnames, key)
                                 + f" {_fmt(snap['sum'])}")
                    lines.append(m.name + "_count"
                                 + _label_str(m.labelnames, key)
                                 + f" {snap['count']}")
                continue
            for key, value in sorted(m.values().items()):
                lines.append(m.name + _label_str(m.labelnames, key)
                             + f" {_fmt(value)}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the process-default registry + the JSONL-kind translation table
# ---------------------------------------------------------------------------

_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-local registry every export surface renders."""
    return _DEFAULT


def observe_record(kind: str, fields: dict,
                   registry: Optional[MetricsRegistry] = None) -> None:
    """Translate one JSONL record into registry updates. Called by
    ``MetricsLogger.log`` for every record it writes; unknown kinds are
    ignored. Fail-open: a malformed record must not take down the
    logger."""
    reg = registry if registry is not None else _DEFAULT
    try:
        _observe_record(kind, fields, reg)
    except Exception:
        pass


def _observe_record(kind: str, f: dict, reg: MetricsRegistry) -> None:
    if kind == "compile":
        reg.counter("dml_compile_lookups_total",
                    "Compile-seam lookups by hit/miss",
                    labelnames=("hit",)
                    ).inc(1, hit="true" if f.get("hit") else "false")
        reg.counter("dml_compile_seconds_total",
                    "Seconds spent obtaining compiled programs"
                    ).inc(f.get("compile_s") or 0.0)
    elif kind == "serve":
        reg.gauge("dml_serve_qps", "Completed requests/s, last window"
                  ).set(f.get("qps"))
        reg.gauge("dml_serve_p50_ms", "Latency p50, last window"
                  ).set(f.get("p50_ms"))
        reg.gauge("dml_serve_p99_ms", "Latency p99, last window"
                  ).set(f.get("p99_ms"))
        reg.gauge("dml_serve_batch_fill",
                  "Mean batch fill fraction, last window"
                  ).set(f.get("batch_fill"))
        reg.counter("dml_serve_requests_total", "Requests submitted"
                    ).inc(f.get("requests") or 0)
        reg.counter("dml_serve_completed_total", "Requests completed"
                    ).inc(f.get("completed") or 0)
        shed = reg.counter("dml_serve_shed_total",
                           "Requests shed by admission control",
                           labelnames=("reason",))
        shed.inc(f.get("shed_queue") or 0, reason="queue_full")
        shed.inc(f.get("shed_deadline") or 0, reason="deadline")
        reg.counter("dml_serve_cache_hits_total",
                    "Requests answered by the response cache "
                    "(bypassed the batcher)"
                    ).inc(f.get("cache_hit") or 0)
