"""The device side of serving: uint8 batches in, logits out, one CUDA
graph per batch bucket, and the checkpoint hot-swap seam.

Port of ``dml_cnn_cifar10_tpu/serve/engine.py``. Two ways to build one,
one call contract:

- :meth:`ServingEngine.from_artifact` — the ``export.py`` artifact
  (weights embedded, symbolic batch, the eval decode in front). The input
  geometry is read from the artifact's own input spec, so a server needs
  no ``DataConfig``. Its weights are the program's: not swappable.
- :meth:`ServingEngine.from_params` — live weights run through
  ``export.make_variable_serving_fn``, held in the engine's own copy.
  :meth:`try_swap` moves a candidate to the device before it takes any
  lock, then copies it into that copy and sets the version under the run
  lock, which every forward holds: a batch in flight finishes on the old
  weights, the next runs the new ones, and every response's version tag
  says which. Serving pauses only for the device-to-device copy.

On the card, where the JAX package compiles each bucket once, the engine
captures each bucket's forward as one CUDA graph, with a static input and
output buffer: :meth:`warmup` runs each forward once on a side stream
(cuDNN and cuBLAS choose their kernels, the flash kernels' library
loads), captures it, and replays it once on zeros, all before traffic. A
batch is one host-to-device copy of its uint8 pixels, one replay and one
copy of the logits back. The graphs read the engine's own weight
tensors, so weights change only by ``copy_`` into them, never by
rebinding; a replay whose weight tensors are not the ones captured
raises. A batch size with no graph yet (outside the warmed buckets) is
captured at its first use. A failed capture or kernel build raises:
there is no eager, plain or CPU fallback on the card. Each replay adds
to ``ops/flash_attention.LAUNCHES`` the launches its capture recorded
(the ViT-Ti graph: 12 K3), the capture's own and its warm-up's are not
counted. All graphs share one memory pool; one lock serializes the
forwards (they share the static buffers) and the swaps' copies. On the
CPU the same forward runs eagerly under the same lock, so the tests
cover the swap logic.

Every response carries the engine's ``version`` read under the run lock
with its batch (the checkpoint step it serves, ``artifact`` for an
artifact), threaded by the batcher into ``VersionedLogits``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from dml_cnn_cifar10_tpu_torch.config import DataConfig
from dml_cnn_cifar10_tpu_torch.ops import flash_attention
from dml_cnn_cifar10_tpu_torch.parallel.step import f32_parity

#: The kernel launch counters a serving forward can move.
_COUNTER = flash_attention.LAUNCHES


def _variable_spec(params: Dict[str, torch.Tensor]) -> tuple:
    """The (name, shape, dtype) signature a swap candidate must match."""
    return tuple(sorted((n, tuple(t.shape), str(t.dtype).split(".")[-1])
                        for n, t in params.items()))


def _spec_mismatch(want: tuple, got: tuple) -> str:
    """Human-readable first divergence between two variable specs."""
    w = {n: (s, d) for n, s, d in want}
    g = {n: (s, d) for n, s, d in got}
    if set(w) != set(g):
        return (f"param names differ: missing {sorted(set(w) - set(g))}, "
                f"unexpected {sorted(set(g) - set(w))}")
    for n in sorted(w):
        if w[n] != g[n]:
            return (f"leaf {n}: have {w[n][0]}/{w[n][1]}, candidate "
                    f"{g[n][0]}/{g[n][1]}")
    return "specs differ"


class _BucketGraph:
    """One bucket's forward, captured as a CUDA graph: its static
    buffers, the weight tensors' addresses it reads, and the kernel
    launches one replay makes."""

    def __init__(self, graph, static_in, static_out, ptrs, launches):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.ptrs = ptrs
        self.launches: Dict[str, int] = launches
        self.replays = 0


def _counter_delta(before: Dict[str, int]) -> Dict[str, int]:
    return {k: _COUNTER[k] - before[k] for k in _COUNTER
            if _COUNTER[k] != before[k]}


class ServingEngine:
    """Uint8 image batches in, numpy logits out, timed.

    ``run(images_u8, params)`` maps a ``uint8 [B, H, W, C]`` tensor on
    ``device`` and the weights (a ``{name: tensor}`` dict) to logits
    ``[B, K]``. ``params`` are an artifact's own tensors, or the engine's
    copy of live weights (``swappable``). ``image_shape`` is the
    per-request ``(H, W, C)`` the batcher validates and pads against;
    ``version`` tags every response; ``replica_id`` names the engine in
    swap records.
    """

    def __init__(self, run: Callable, params: Dict[str, torch.Tensor],
                 image_shape: Tuple[int, int, int], device,
                 source: str = "live", swappable: bool = False, logger=None,
                 version: str = "0", replica_id: int = 0):
        self._run = run
        self._params = params
        self.image_shape = tuple(int(d) for d in image_shape)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # An explicit index: the batcher's worker thread makes it its
            # current device.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.source = source
        self.swappable = swappable
        self.logger = logger
        self.version = str(version)
        self.replica_id = int(replica_id)
        self.swap_count = 0
        self._spec = _variable_spec(params)
        # One forward or swap copy at a time: the graphs share static
        # buffers and pool, and a batch reads the weights and the version
        # together.
        self._run_lock = threading.Lock()
        #: bucket -> its captured graph (on the card).
        self.graphs: Dict[int, _BucketGraph] = {}
        self._pool = None
        #: the last warmup's {bucket: compile event}.
        self.last_warmup: dict = {}
        if self.device.type == "cuda":
            f32_parity()

    @classmethod
    def from_artifact(cls, path: str, device="cuda", logger=None,
                      version: str = "artifact",
                      replica_id: int = 0) -> "ServingEngine":
        """Engine over an ``export.py`` artifact, its constants moved to
        ``device``. Weights, decode and input geometry all come from the
        artifact."""
        from dml_cnn_cifar10_tpu_torch import export as export_lib

        program = export_lib.load_program(path, device)
        module = program.module()
        tensors = dict(module.named_parameters())
        tensors.update(module.named_buffers())

        def run(images_u8, params):
            return module(images_u8)

        return cls(run, tensors, export_lib.artifact_image_shape(program),
                   device, source=path, logger=logger, version=version,
                   replica_id=replica_id)

    @classmethod
    def from_params(cls, model: nn.Module, data_cfg: DataConfig,
                    params: Dict[str, torch.Tensor], device="cuda",
                    logger=None, version: str = "0",
                    replica_id: int = 0) -> "ServingEngine":
        """Engine over live weights (``{name: tensor}``, the port's
        layouts, a model's running stats by their buffer names with them):
        a copy of ``params`` on ``device``, hot-swappable by
        :meth:`try_swap`."""
        from dml_cnn_cifar10_tpu_torch.export import make_variable_serving_fn

        device = torch.device(device)
        fn = make_variable_serving_fn(model.to(device), data_cfg)
        own = {n: t.detach().to(device).clone() for n, t in params.items()}
        return cls(fn, own, (data_cfg.image_height, data_cfg.image_width,
                             data_cfg.num_channels), device,
                   swappable=True, logger=logger, version=version,
                   replica_id=replica_id)

    def _on_device(self):
        """The engine's card as the current device (a no-op on the CPU)."""
        return torch.cuda.device(self.device) if self.device.type == "cuda" \
            else contextlib.nullcontext()

    # --- hot-swap seam ---

    def try_swap(self, params: Dict[str, torch.Tensor], model_state=None,
                 version: str = "?") -> Tuple[bool, str]:
        """Validate a new weight set and install it.

        The candidate must match the engine's contract (the same names,
        leaf shapes and dtypes), because the graphs were captured for
        exactly those tensors. A mismatch is rejected: a ``swap_rejected``
        record, ``(False, reason)``, and the old version keeps serving. On
        success the candidate is copied into the engine's weights and the
        version set under the run lock, after the batch in flight (if
        any) has finished. ``model_state`` (a model's eval-mode running
        stats, ``{buffer name: tensor}``) is swapped with the params: the
        candidate is their union, held to the engine's contract, which
        names the buffers of a model that keeps them (the ResNet) and
        none for one that does not."""
        t0 = time.perf_counter()
        version = str(version)
        if not self.swappable:
            return False, self._reject(
                version, "engine is artifact-backed (weights baked into "
                         "the program); not swappable")
        if model_state:
            params = {**params, **model_state}
        spec = _variable_spec(params)
        if spec != self._spec:
            return False, self._reject(version,
                                       _spec_mismatch(self._spec, spec))
        # The host-to-device transfer, the slow part, before any lock.
        staged = {n: t.detach().to(self.device) for n, t in params.items()}
        with self._on_device(), self._run_lock, torch.no_grad():
            for n, t in self._params.items():
                t.copy_(staged[n])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            from_version = self.version
            self.version = version
            self.swap_count += 1
        swap_ms = round((time.perf_counter() - t0) * 1e3, 3)
        if self.logger is not None:
            self.logger.log("swap", replica_id=self.replica_id,
                            version=version, from_version=from_version,
                            swap_ms=swap_ms)
        print(f"[serve] hot-swapped params {from_version} -> {version} in "
              f"{swap_ms:.1f} ms (swap #{self.swap_count})")
        return True, "swapped"

    def _reject(self, version: str, reason: str) -> str:
        if self.logger is not None:
            self.logger.log("swap_rejected", replica_id=self.replica_id,
                            version=version, reason=reason)
        print(f"[serve] REJECTED candidate version {version}: {reason} "
              f"(still serving {self.version})")
        return reason

    # --- warmup ---

    def warmup(self, buckets) -> dict:
        """Capture (on the card) or run once (on the CPU) every bucket's
        forward before traffic; one ``compile`` record a bucket. Returns
        ``{bucket: seconds}``."""
        out = {}
        self.last_warmup = {}
        for b in sorted(set(int(b) for b in buckets)):
            t0 = time.perf_counter()
            self.forward_timed(np.zeros((b, *self.image_shape), np.uint8))
            secs = time.perf_counter() - t0
            ev = {"key": None, "phase": "serve_warmup", "hit": False,
                  "compile_s": round(secs, 4), "source": "uncached"}
            if self.logger is not None:
                self.logger.log("compile", bucket=b,
                                graphs=int(self.device.type == "cuda"), **ev)
            self.last_warmup[b] = ev
            out[b] = round(secs, 3)
        return out

    # --- forward ---

    def _eager(self, batch_u8: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(batch_u8).to(self.device)
        with torch.no_grad():
            return self._run(x, self._params).cpu().numpy()

    def _capture(self, b: int) -> _BucketGraph:
        """Warm bucket ``b``'s forward up on a side stream, then capture
        it. The caller holds the run lock, on the engine's device."""
        static_in = torch.zeros((b, *self.image_shape), dtype=torch.uint8,
                                device=self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = dict(_COUNTER)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.no_grad():
            self._run(static_in, self._params)
        torch.cuda.current_stream().wait_stream(side)
        _COUNTER.update(before)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(graph, pool=self._pool):
            out = self._run(static_in, self._params)
        launches = _counter_delta(before)
        _COUNTER.update(before)
        g = _BucketGraph(graph, static_in, out,
                         tuple(t.data_ptr() for t in self._params.values()),
                         launches)
        self.graphs[b] = g
        return g

    def _replay(self, batch_u8: np.ndarray) -> np.ndarray:
        """One batch through its bucket's graph. The caller holds the run
        lock, on the engine's device."""
        b = int(batch_u8.shape[0])
        g = self.graphs.get(b) or self._capture(b)
        if tuple(t.data_ptr() for t in self._params.values()) != g.ptrs:
            raise RuntimeError(
                "a serving graph is bound to the weight tensors it was "
                "captured with; new weights must be copied into them")
        g.static_in.copy_(torch.from_numpy(batch_u8))
        g.graph.replay()
        logits = g.static_out.cpu().numpy()
        g.replays += 1
        for name, n in g.launches.items():
            _COUNTER[name] += n
        return logits

    def forward_eager(self, batch_u8: np.ndarray) -> np.ndarray:
        """The forward run eagerly, without a graph: the reference a
        replay is held against."""
        with self._on_device(), self._run_lock:
            return self._eager(np.ascontiguousarray(batch_u8))

    def forward_timed_versioned(self, batch_u8: np.ndarray):
        """``(logits [B, K], seconds, version)``: the version is read under
        the run lock together with the weights that compute this batch,
        so the tag always names the weights that produced the logits. The
        time covers the input copy, the forward and the logits' copy
        back: what a request waits for."""
        batch = np.ascontiguousarray(batch_u8)
        t0 = time.perf_counter()
        with self._on_device(), self._run_lock:
            version = self.version
            if self.device.type == "cuda":
                logits = self._replay(batch)
            else:
                logits = self._eager(batch)
        return logits, time.perf_counter() - t0, version

    def forward_timed(self, batch_u8: np.ndarray):
        """``(logits [B, K], seconds)``."""
        logits, secs, _ = self.forward_timed_versioned(batch_u8)
        return logits, secs
