"""Device-time attribution: a step-gated torch.profiler window and a
zero-fetch device step-time estimator.

Port of ``dml_cnn_cifar10_tpu/utils/devprof.py`` on ``torch.profiler``:

- :class:`ProfileWindow` — ``--profile_at_steps N:K`` captures a
  torch.profiler trace from global step N for K steps (closing at the
  next drained boundary), exports it as a Chrome trace under
  ``--profile_dir`` (default ``<log_dir>/devprof``), and parses it on the
  host into ``devtime`` records: per lane, the top kernels and the
  compute / collective / infeed buckets.
- :class:`DeviceStepEstimator` — a copy: two clock reads around the
  loop's existing boundary fetch give the per-step device time and the
  host's blocked share, with no extra device read.

Lanes (:func:`parse_trace_doc`): the device's events are torch.profiler's
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events, one lane per device
(``pid``). Without any (the CPU) the host's ``cpu_op`` and
``user_annotation`` events stand in, one lane per process, so the record
shape stays the same; nested host events then count their parents again.
Buckets (:func:`classify_op`, on lowercased names): ``collective`` is the
JAX package's collective names plus NCCL's kernels (``AllReduce``,
``SendRecv``, ``AllToAll``: every ``nccl`` kernel) and gloo's;
``infeed`` its data movement, which takes in ``Memcpy HtoD``/``DtoH``;
everything else is ``compute``.

``optimizer_ms`` (an overlapping total, not a fourth bucket) is the device
time inside the train step's ``record_function("optimizer")``: the
profiler puts the range on the device's timeline as a
``gpu_user_annotation`` interval, and each kernel of the same stream that
starts inside it counts. A CUDA graph replays kernels without the ranges
they were captured in; a lane with no ``optimizer`` interval counts the
update kernels by name instead (K1/K2, ``sgd_multi_kernel``), which covers
the SGD update only. On a host lane the range's own event counts.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
from typing import List, Optional

#: Device-time buckets, in report order.
DEVTIME_BUCKETS = ("compute", "collective", "infeed")

#: The step's update scope (parallel/step.py: record_function).
SCOPE_RE = re.compile(r"optimizer")
#: The update kernels a CUDA graph replays without their scope.
UPDATE_KERNEL_RE = re.compile(r"sgd_multi_kernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")

_COLLECTIVE_RE = re.compile(
    r"all[-_]?reduce|all[-_]?gather|reduce[-_]?scatter|all[-_]?to[-_]?all"
    r"|collective[-_]?permute|collective|ppermute|psum|\bsend\b|\brecv\b"
    r"|nccl|sendrecv|gloo")
_INFEED_RE = re.compile(
    r"infeed|outfeed|\bcopy\b|copy[-_]?start|copy[-_]?done|transfer"
    r"|memcpy|h2d|d2h|host[-_]?to[-_]?device|device[-_]?to[-_]?host")


def classify_op(name: str) -> str:
    """Bucket an op/event name: ``collective`` | ``infeed`` | ``compute``."""
    low = name.lower()
    if _COLLECTIVE_RE.search(low):
        return "collective"
    if _INFEED_RE.search(low):
        return "infeed"
    return "compute"


def parse_profile_at_steps(spec: Optional[str]):
    """``"N:K"`` → ``(start_step, n_steps)``; None/empty → None. A typo'd
    spec raises instead of profiling nothing."""
    if not spec:
        return None
    parts = spec.split(":")
    try:
        if len(parts) != 2:
            raise ValueError
        start, n = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"--profile_at_steps must be START:COUNT (e.g. 100:20), got "
            f"{spec!r}")
    if start < 0 or n < 1:
        raise ValueError(
            f"--profile_at_steps needs START >= 0 and COUNT >= 1, got "
            f"{spec!r}")
    return start, n


def _inside(ev, spans) -> bool:
    """``ev`` starts inside one of ``spans`` (``(start, end)`` µs)."""
    return any(lo <= ev["ts"] < hi for lo, hi in spans)


def parse_trace_doc(doc: dict, top_k: int = 12) -> List[dict]:
    """Chrome-trace dict (torch.profiler's export) → per-lane device-time
    records (no I/O): the device lanes when the trace has device events,
    else the host lanes, else any lane with complete events."""
    events = doc.get("traceEvents") or []
    pid_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e.get("pid")] = (e.get("args") or {}).get("name", "")
    xs = [e for e in events
          if e.get("ph") == "X" and e.get("dur") is not None]
    if not xs:
        return []
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    host = [e for e in xs if e.get("cat") in HOST_CATS]
    lane_events = device or host or xs
    # The update scope's intervals on the device's timeline, by stream.
    scopes = {}
    for e in xs:
        if e.get("cat") == "gpu_user_annotation" and \
                SCOPE_RE.search((e.get("name") or "").lower()):
            scopes.setdefault((e.get("pid"), e.get("tid")), []).append(
                (e["ts"], e["ts"] + e["dur"]))
    out = []
    pids = {e.get("pid") for e in lane_events}
    for pid in sorted(pids, key=lambda p: (str(pid_names.get(p, "")),
                                           str(p))):
        evs = [e for e in lane_events if e.get("pid") == pid]
        by_op = {}
        optimizer_us = 0.0
        t_lo = min(e["ts"] for e in evs)
        t_hi = max(e["ts"] + e["dur"] for e in evs)
        lane_scoped = any(p == pid for p, _ in scopes)
        for e in evs:
            name = e.get("name") or "?"
            agg = by_op.setdefault(name, [0.0, 0])
            agg[0] += e["dur"]          # microseconds
            agg[1] += 1
            if device:
                hit = (_inside(e, scopes.get((pid, e.get("tid")), ()))
                       if lane_scoped else UPDATE_KERNEL_RE.search(name))
            else:
                hit = SCOPE_RE.search(name.lower())
            if hit:
                optimizer_us += e["dur"]
        buckets = dict.fromkeys(DEVTIME_BUCKETS, 0.0)
        total_us = 0.0
        for name, (dur_us, _calls) in by_op.items():
            buckets[classify_op(name)] += dur_us
            total_us += dur_us
        top = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:top_k]
        out.append({
            "device": pid_names.get(pid) or f"pid:{pid}",
            "total_ms": round(total_us / 1e3, 3),
            "compute_ms": round(buckets["compute"] / 1e3, 3),
            "collective_ms": round(buckets["collective"] / 1e3, 3),
            "infeed_ms": round(buckets["infeed"] / 1e3, 3),
            "optimizer_ms": round(optimizer_us / 1e3, 3),
            "window_ms": round((t_hi - t_lo) / 1e3, 3),
            "top_ops": [
                {"name": name, "bucket": classify_op(name),
                 "dur_ms": round(dur_us / 1e3, 3), "calls": calls,
                 "frac": round(dur_us / total_us, 4) if total_us else 0.0}
                for name, (dur_us, calls) in top],
        })
    return out


class ProfileWindow:
    """Step-gated torch.profiler capture + host-side trace parsing.

    The trainer calls :meth:`maybe_start` before each dispatch (arms at the
    first at/after ``start_step``) and :meth:`maybe_stop` at each
    iteration end with the boundary's ``drained`` flag: the stop waits for
    a drained boundary at/after ``start + n_steps``, so the window closes
    on an idle device. :meth:`close` (the loop's ``finally``) stops a
    window the run ended inside of. A profiler or parse error prints one
    warning and the run continues.
    """

    def __init__(self, start_step: int, n_steps: int, out_dir: str,
                 logger=None, top_k: int = 12):
        self.start_step = start_step
        self.n_steps = n_steps
        self.out_dir = out_dir
        self.logger = logger
        self.top_k = top_k
        self.state = "pending"            # pending -> active -> done
        self._armed_at = start_step
        self._prof = None
        #: Per-step device time inside the update scope from the parsed
        #: window (mean over lanes); None until a window completes.
        self.optimizer_step_ms: Optional[float] = None
        #: The parsed lanes of the completed window.
        self.lanes: List[dict] = []

    @classmethod
    def from_config(cls, cfg, logger=None) -> Optional["ProfileWindow"]:
        """The window ``cfg.profile_at_steps`` asks for (None = off),
        writing under ``cfg.profile_dir`` or ``<log_dir>/devprof``."""
        spec = parse_profile_at_steps(cfg.profile_at_steps)
        if spec is None:
            return None
        out_dir = cfg.profile_dir or os.path.join(cfg.log_dir, "devprof")
        return cls(spec[0], spec[1], out_dir, logger=logger)

    def maybe_start(self, step: int) -> None:
        if self.state != "pending" or step < self.start_step:
            return
        self.state = "active"
        self._armed_at = step
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
        except Exception as e:              # fail-open
            print(f"[devprof] profiler start failed at step {step}: "
                  f"{e!r}", file=sys.stderr)
            self.state = "done"

    def maybe_stop(self, step: int, drained: bool = True) -> None:
        if self.state != "active" or not drained \
                or step < self.start_step + self.n_steps:
            return
        self._finish(step)

    def close(self, step: int) -> None:
        """End-of-run stop for a window the run finished inside."""
        if self.state == "active":
            self._finish(step)

    def _finish(self, step: int) -> None:
        self.state = "done"
        path = os.path.join(self.out_dir,
                            f"trace_{self._armed_at}_{step}.json")
        try:
            self._prof.stop()
            os.makedirs(self.out_dir, exist_ok=True)
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                lanes = parse_trace_doc(json.load(f), top_k=self.top_k)
        except Exception as e:
            print(f"[devprof] profiler stop/parse failed at step {step}: "
                  f"{e!r}", file=sys.stderr)
            return
        finally:
            self._prof = None
        if not lanes:
            print(f"[devprof] no parseable trace in {path}", file=sys.stderr)
            return
        self.lanes = lanes
        steps = max(1, step - self._armed_at)
        self.optimizer_step_ms = round(
            sum(ln["optimizer_ms"] for ln in lanes) / len(lanes) / steps, 4)
        for lane in lanes:
            if self.logger is not None:
                self.logger.log("devtime", step=step, **lane)
            top = lane["top_ops"][0] if lane["top_ops"] else None
            head = (f"; top op {top['name'][:80]} {top['dur_ms']:.1f} ms "
                    f"({100 * top['frac']:.1f}%)") if top else ""
            print(f"[devprof] {lane['device']}: {lane['total_ms']:.1f} ms "
                  f"attributed over steps {self._armed_at}..{step} "
                  f"(compute {lane['compute_ms']:.1f} / collective "
                  f"{lane['collective_ms']:.1f} / infeed "
                  f"{lane['infeed_ms']:.1f}){head}")


class DeviceStepEstimator:
    """Per-boundary device step-time estimate from the boundary fetch.

    ``mark(step)`` at the end of any iteration that drained (and once
    after the first dispatch returns); at a metrics boundary, two clock
    reads around the existing fetch feed :meth:`boundary`. The window
    ``[mark, drain_end]`` holds every training dispatch since the mark
    plus the drain, which the device runs back to back (unless starved),
    so ``(drain_end − mark) / steps`` estimates the per-step device time
    and ``drain_end − drain_start`` is the host's blocked share. An upper
    bound when the device starves; the profile window settles that.
    """

    __slots__ = ("_mark",)

    def __init__(self):
        self._mark = None

    def mark(self, step: int, now: Optional[float] = None) -> None:
        self._mark = (step, time.perf_counter() if now is None else now)

    def boundary(self, step: int, drain_start: float, drain_end: float):
        """→ ``(device_step_ms, drain_wait_ms)``; the first is ``None``
        before any mark (schema keys stay present, null-valued)."""
        drain_ms = round(max(drain_end - drain_start, 0.0) * 1e3, 3)
        if self._mark is None:
            return None, drain_ms
        mark_step, mark_t = self._mark
        steps = step - mark_step
        if steps <= 0:
            return None, drain_ms
        return round((drain_end - mark_t) / steps * 1e3, 4), drain_ms
