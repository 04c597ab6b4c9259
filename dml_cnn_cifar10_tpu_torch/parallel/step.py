"""The training and eval steps, on one device or over a process mesh.

Port of ``dml_cnn_cifar10_tpu/parallel/step.py``:
:class:`TrainState`, :func:`init_train_state`, :func:`make_train_step`,
:func:`make_eval_step`. PyTorch runs eagerly, so a step is a plain
function: forward through the model with the state's parameters
(``torch.func.functional_call``), backward with ``torch.autograd.grad``,
then the in-place optimizer update (``train/optim.py``) whose fused form
is the hand-written CUDA kernel. No host synchronization happens inside
a step; the metrics it returns are device tensors. The model reads its
own compute dtype and attention switches from its ``ModelConfig``; the
step only keeps float32 products in full float32. Under grad the ViT's
attention runs the flash forward that saves its logsumexp (K4) and the
backward kernels (K6, K7); the eval step runs under ``no_grad``, so the
output-only forward (K3); under sequence parallelism the ring runs K5
forward and K6/K7 backward instead.

Over a mesh (``parallel/mesh.py``) each rank computes the loss of its own
batch slice, scaled by ``1/world``, and the gradients are summed over the
world in one flat all-reduce — the JAX package's ``psum``. That is the
mean over the global batch: every seq rank of a data row computes the same
loss from the same pooled features, and the pool's all-reduce sums the
gradient back over the seq ranks, so every leaf (token-side and post-pool
alike) arrives ``seq`` times over before the ``1/world`` share. The loss
and accuracy metrics are averaged over the data group; the eval step sums
``correct`` over it. Staleness emulation is not ported.

Chunked dispatch, one process (``TrainConfig.steps_per_dispatch``):
:func:`make_train_chunk` (host-fed raw uint8 chunks) and
:func:`make_train_chunk_resident` (the uint8 split resident on the device,
its rows gathered there by host indices or by the device index stream) run
K steps a call through one body, :func:`_chunk_body`, which decodes the
chunk first (``ops/preprocess.py``). On the CPU they run that body
eagerly. On the card each replays ONE CUDA graph of all K steps
(:class:`_GraphedChunk`): the first call warms the body up on a side
stream, puts the state back, captures the K steps and replays them; every
later call copies its inputs into the graph's static buffers (none on the
device stream) and replays. A capture or replay error propagates; there is
no eager fallback on the card. The graph is bound to the tensors of the
state it was captured with: parameters and optimizer state are updated in
place, and the update kernels' leaf tables and the LR's pointer are baked
into the graph, whose private memory pool keeps the gradients' addresses.
:func:`make_eval_resident` sweeps a resident split and
:func:`make_batch_eval_resident` scores one index-fed batch; they run
eagerly (once a boundary).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from dml_cnn_cifar10_tpu_torch.config import DataConfig, OptimConfig
from dml_cnn_cifar10_tpu_torch.data import device_stream
from dml_cnn_cifar10_tpu_torch.ops import flash_attention, optimizer
from dml_cnn_cifar10_tpu_torch.ops.preprocess import device_preprocess
from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh
from dml_cnn_cifar10_tpu_torch.train import loss as loss_lib
from dml_cnn_cifar10_tpu_torch.train import metrics as metrics_lib
from dml_cnn_cifar10_tpu_torch.train import optim as optim_lib


@dataclasses.dataclass
class TrainState:
    """Params + optimizer state + model state (empty for the CNN).

    ``params`` maps the model's parameter names to tensors on the device,
    in the port's layouts; ``opt`` is :func:`optim.sgd_init`'s dict.
    """

    params: Dict[str, torch.Tensor]
    opt: Dict[str, Any]
    model_state: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def step(self) -> torch.Tensor:
        return self.opt["step"]


def f32_parity() -> None:
    # Keep convolutions and matrix products in full float32 on the card:
    # cuDNN convolutions default to TF32 (~3 decimal digits), which would
    # break parity with the JAX package's float32 math.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def init_train_state(model: nn.Module, optim_cfg: OptimConfig,
                     device: torch.device,
                     generator: Optional[torch.Generator] = None
                     ) -> TrainState:
    """Initialize ``model``'s parameters from ``generator`` (on the CPU,
    so a seed gives the same weights on every device), move the model to
    ``device`` and build the optimizer state there. The state's params
    are the module's own ``nn.Parameter`` objects."""
    model.reset_parameters(generator)
    model.to(device)
    params = dict(model.named_parameters())
    return TrainState(params=params,
                      opt=optim_lib.sgd_init(params, optim_cfg, device))


def _sum_grads(grads, mesh: Mesh):
    """Sum the gradients over the world in place, in one all-reduce of
    their concatenation."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    mesh.all_reduce_(flat, "world")
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _data_mean(values, mesh: Optional[Mesh]) -> torch.Tensor:
    """Stack scalar metrics and average them over the data group."""
    v = torch.stack([t.float() for t in values])
    if mesh is not None and mesh.data > 1:
        mesh.all_reduce_(v, "data").div_(mesh.data)
    return v


def make_train_step(model: nn.Module, optim_cfg: OptimConfig,
                    mesh: Optional[Mesh] = None
                    ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                  Tuple[TrainState, dict]]:
    """``(state, images, labels) -> (state, {"loss", "accuracy"})``; the
    state is updated in place and returned. Over a mesh, ``images`` are
    this data rank's slice of the global batch and the metrics are the
    global batch's."""
    f32_parity()
    world = 1 if mesh is None else mesh.world

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        names = list(state.params)
        with torch.enable_grad():
            logits = functional_call(model, state.params, (images,))
            loss = loss_lib.softmax_cross_entropy(
                logits, labels, optim_cfg.label_smoothing)
            # The update kernels take contiguous leaves; a kernel that
            # reaches its layer through a permute (the ViT's HWIO patch
            # embed) gets its gradient back as a permuted view.
            grads = [g.contiguous() for g in torch.autograd.grad(
                loss / world if world > 1 else loss,
                [state.params[n] for n in names])]
        with torch.no_grad():
            if world > 1:
                _sum_grads(grads, mesh)
            loss_m, acc = _data_mean(
                [loss.detach(), metrics_lib.batch_accuracy(logits, labels)],
                mesh)
            optim_lib.sgd_update(dict(zip(names, grads)), state.opt,
                                 state.params, optim_cfg)
        return state, {"loss": loss_m, "accuracy": acc}

    return step


def make_eval_step(model: nn.Module, mesh: Optional[Mesh] = None
                   ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                 dict]:
    """``(state, images, labels) -> {"accuracy", "correct"}`` — single-batch
    accuracy for faithful eval (``cifar10cnn.py:237-241``) and the
    summable correct count for the full-test-set sweep, both over the
    data group's batches. Uses the parameter EMA when the optimizer keeps
    one."""
    f32_parity()

    @torch.no_grad()
    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        params = state.opt.get("ema", state.params)
        logits = functional_call(model, params, (images,))
        acc, = _data_mean([metrics_lib.batch_accuracy(logits, labels)],
                          mesh)
        correct = metrics_lib.correct_count(logits, labels)
        if mesh is not None:
            mesh.all_reduce_(correct, "data")
        return {"accuracy": acc, "correct": correct}

    return step


# --------------------------------------------------------------------------
# chunked dispatch: K steps a call (parallel/step.py:539-990 of the JAX
# package)
# --------------------------------------------------------------------------

# Past this many bytes of decoded float32 chunk, the decode moves into the
# step loop, one batch at a time (the JAX package's threshold).
_DECODE_IN_LOOP_BYTES = 1 << 30

# The kernels' launch counters: a replay adds what its capture recorded.
_COUNTERS = (optimizer.LAUNCHES, flash_attention.LAUNCHES)


def _chunk_body(model: nn.Module, optim_cfg: OptimConfig,
                data_cfg: Optional[DataConfig]):
    """``(state, images [K, B, ...], labels [K, B]) -> (state, metrics of
    the LAST step)``: the K-step math shared by every ``make_train_chunk*``.

    With ``data_cfg`` the images are RAW uint8 and the decode runs first,
    over the whole chunk at once (``[K, B]`` rows draw their augmentation
    at ``state.step + k``), or one batch a step past
    ``_DECODE_IN_LOOP_BYTES``; either way each batch decodes exactly as it
    would alone."""
    one_step = make_train_step(model, optim_cfg)

    def run(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        decode_in_loop = False
        if data_cfg is not None:
            k, b, h, w = images.shape[:4]
            decoded = (k * b * max(h, data_cfg.crop_height)
                       * max(w, data_cfg.crop_width)
                       * data_cfg.num_channels * 4)
            decode_in_loop = decoded > _DECODE_IN_LOOP_BYTES
            if not decode_in_loop:
                images = device_preprocess(images, data_cfg, state.step)
        metrics = None
        for i in range(images.shape[0]):
            imgs = images[i]
            if decode_in_loop:
                imgs = device_preprocess(imgs, data_cfg, state.step)
            state, metrics = one_step(state, imgs, labels[i])
        return state, metrics

    return run


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor of the state, in a fixed order."""
    out = list(state.params.values())
    for tree in (state.opt, state.model_state):
        for value in tree.values():
            if isinstance(value, Mapping):
                out.extend(value.values())
            elif isinstance(value, torch.Tensor):
                out.append(value)
    return out


def _counts() -> List[Dict[str, int]]:
    return [dict(c) for c in _COUNTERS]


def _set_counts(counts: List[Dict[str, int]]) -> None:
    for counter, saved in zip(_COUNTERS, counts):
        counter.update(saved)


def _delta(before: List[Dict[str, int]]) -> List[Dict[str, int]]:
    return [{k: c[k] - b[k] for k in c if c[k] != b[k]}
            for c, b in zip(_COUNTERS, before)]


class _GraphedChunk:
    """A chunk body replayed as one CUDA graph of its K steps.

    The first call runs the body once on a side stream (the warm-up that
    capture needs: cuDNN and cuBLAS choose their algorithms and
    workspaces, the kernels' libraries load), puts every tensor of the
    state back as it was, captures the body once on the caller's state and
    static input buffers, and replays it. Every call is one replay. The
    kernel launch counters count the caller's steps: each replay adds the
    launches its capture recorded; the warm-up's, whose results are thrown
    away, are kept apart in :attr:`warmup_launches`. The metrics returned
    are the graph's own output buffers, overwritten by the next replay.

    ``prepare(step)``, when given, runs on the host before the warm-up and
    before every replay with the chunk's first global step, which the
    wrapper tracks on the host (read from ``state.step`` once, at
    capture, then advanced by ``k`` a call): the device index stream's
    table refresh (``data/device_stream.py:EpochRows``).
    """

    def __init__(self, body: Callable, prepare: Optional[Callable] = None,
                 k: int = 0):
        self._body, self._prepare, self._k = body, prepare, k
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._tensors: List[torch.Tensor] = []
        self._inputs: List[torch.Tensor] = []
        self._metrics: Optional[dict] = None
        self._captured: List[Dict[str, int]] = []
        self._step = 0
        #: Replays run, and the launches of the warm-up before capture.
        self.replays = 0
        self.warmup_launches: Dict[str, int] = {}

    def __call__(self, state: TrainState, *inputs: torch.Tensor):
        dev = state.step.device
        with torch.cuda.device(dev):
            if self._graph is None:
                self._capture(state, inputs)
            else:
                current = _state_tensors(state)
                if len(current) != len(self._tensors) or any(
                        a is not b for a, b in zip(current, self._tensors)):
                    raise ValueError(
                        "this chunk's CUDA graph is bound to the tensors of "
                        "the state it was captured with; copy new values "
                        "into them in place")
                for dst, src in zip(self._inputs, inputs):
                    if src.shape != dst.shape:
                        raise ValueError(
                            f"chunk input of shape {tuple(src.shape)}; the "
                            f"graph was captured at {tuple(dst.shape)}")
                    dst.copy_(src)
            if self._prepare is not None:
                self._prepare(self._step)
            self._graph.replay()
        self._step += self._k
        self.replays += 1
        for counter, delta in zip(_COUNTERS, self._captured):
            for name, n in delta.items():
                counter[name] += n
        return state, self._metrics

    def _capture(self, state: TrainState, inputs) -> None:
        self._tensors = _state_tensors(state)
        self._inputs = [t.clone() for t in inputs]
        self._step = int(state.step)            # the one host read
        before = _counts()
        saved = [t.detach().clone() for t in self._tensors]
        if self._prepare is not None:
            self._prepare(self._step)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._body(state, *self._inputs)
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, s in zip(self._tensors, saved):
                t.copy_(s)
        del saved
        warm = _delta(before)
        self.warmup_launches = {k: n for d in warm for k, n in d.items()}
        _set_counts(before)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _, metrics = self._body(state, *self._inputs)
        self._captured = _delta(before)
        _set_counts(before)
        self._graph, self._metrics = graph, metrics


def _dispatch(eager: Callable,
              graphed: Optional[_GraphedChunk]) -> Callable:
    """What ``make_train_chunk*`` return: ``eager`` for a state on the
    CPU, the graph for a state on the card (never the other way round)."""
    def chunk(state: TrainState, *inputs: torch.Tensor):
        if not state.step.is_cuda:
            return eager(state, *inputs)
        if graphed is None:
            raise ValueError("the state is on the card but the resident "
                             "split is not")
        return graphed(state, *inputs)

    chunk.graph = graphed
    chunk.eager = eager
    chunk.check = lambda: None
    return chunk


def make_train_chunk(model: nn.Module, optim_cfg: OptimConfig,
                     data_cfg: Optional[DataConfig] = None
                     ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                   Tuple[TrainState, dict]]:
    """K training steps a call: ``(state, images [K, B, ...], labels
    [K, B]) -> (state, metrics of the LAST step)``, the state updated in
    place. With ``data_cfg`` the images are RAW uint8 full-size
    ``[K, B, H, W, C]`` and the decode runs on the device. On the card the
    K steps are one CUDA graph replay; the inputs are copied into its
    static buffers, so they must keep the shapes of the first call."""
    body = _chunk_body(model, optim_cfg, data_cfg)
    return _dispatch(body, _GraphedChunk(body))


def make_train_chunk_resident(
    model: nn.Module,
    optim_cfg: OptimConfig,
    dataset_images: torch.Tensor,
    dataset_labels: torch.Tensor,
    data_cfg: Optional[DataConfig] = None,
    index_stream: Optional[Tuple[int, int, int]] = None,
) -> Callable:
    """Chunked training against a device-resident split: ``(state, idx
    [K, B]) -> (state, metrics of the LAST step)``. ``dataset_images``
    ``[N, H, W, C]`` uint8 and ``dataset_labels`` ``[N]`` live on the
    state's device; the gather, the decode and the K steps run there, the
    host ships only the indices. Same math as :func:`make_train_chunk` on
    the same rows.

    ``index_stream=(seed, global_batch, K)`` generates the indices on the
    device too (``data/device_stream.py``, keyed on ``state.step``), and
    the call becomes ``(state,) -> (state, metrics)``: a training dispatch
    moves nothing host→device, and a resumed state continues the data
    order exactly. On the CPU the rows come from the exact cycle walk; in
    the card's graph from an epoch table that the wrapper refreshes
    between replays (:class:`device_stream.EpochRows`). The returned
    callable's ``check()`` reads the table's miss count and raises if it
    is not 0: call it at every boundary, before anything is logged or
    saved.
    """
    if data_cfg is None:
        # The resident rows are raw uint8: without a decode config the
        # model would silently train on 0-255 un-cropped pixels.
        raise ValueError(
            "make_train_chunk_resident requires data_cfg (the gathered "
            "dataset rows are raw uint8 and must be decoded on device)")
    body = _chunk_body(model, optim_cfg, data_cfg)

    if index_stream is None:
        def chunk_idx(state: TrainState, idx: torch.Tensor):
            return body(state, dataset_images[idx], dataset_labels[idx])

        return _dispatch(chunk_idx, _GraphedChunk(chunk_idx))

    seed, global_batch, k = index_stream
    n = dataset_images.shape[0]

    def chunk_exact(state: TrainState):
        idx = device_stream.chunk_shuffle_indices(seed, state.step,
                                                  global_batch, k, n)
        return body(state, dataset_images[idx], dataset_labels[idx])

    if not dataset_images.is_cuda:
        return _dispatch(chunk_exact, None)
    rows = device_stream.EpochRows(seed, global_batch, k, n,
                                   dataset_images.device)

    def chunk_table(state: TrainState):
        idx = rows.lookup(state.step)
        return body(state, dataset_images[idx], dataset_labels[idx])

    fn = _dispatch(chunk_exact, _GraphedChunk(chunk_table, rows.prepare, k))
    fn.rows = rows
    fn.check = rows.check
    return fn


def _eval_data_cfg(data_cfg: DataConfig) -> DataConfig:
    """Eval-time decode config: deterministic (all augmentation off)."""
    return data_cfg.without_augmentation()


def make_eval_resident(model: nn.Module, images_u8: np.ndarray,
                       labels: np.ndarray, data_cfg: DataConfig,
                       device: torch.device, batch_size: int = 128,
                       expected_batches: Optional[int] = None):
    """Full-split eval against a device-resident split: returns ``(fn,
    total)`` with ``fn(state) -> correct count`` (a device scalar) over
    all ``total`` records. The split is padded on the host to whole
    batches (pad labels -1 count 0, as ``full_sweep_padded``), placed on
    ``device`` once as ``[M, B, ...]`` uint8, and each call decodes and
    scores the M batches with one read at the end."""
    n = images_u8.shape[0]
    m = -(-n // batch_size)
    if expected_batches is not None and m != expected_batches:
        # The iterator's padded-sweep rule and this one must agree: the
        # host-fed and resident paths count over the same geometry.
        raise ValueError(
            f"resident eval computed {m} padded batches but the "
            f"iterator's sweep rule says {expected_batches}")
    pad = m * batch_size - n
    if pad:
        images_u8 = np.concatenate(
            [images_u8, np.zeros((pad, *images_u8.shape[1:]),
                                 images_u8.dtype)])
        labels = np.concatenate([labels, np.full((pad,), -1, labels.dtype)])
    ims = torch.from_numpy(np.ascontiguousarray(images_u8.reshape(
        m, batch_size, *images_u8.shape[1:]))).to(device)
    lbs = torch.from_numpy(labels.reshape(m, batch_size).astype(
        np.int64)).to(device)
    eval_step = make_eval_step(model)
    eval_cfg = _eval_data_cfg(data_cfg)

    def fn(state: TrainState) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.int64, device=device)
        for i in range(m):
            total += eval_step(state, device_preprocess(ims[i], eval_cfg),
                               lbs[i])["correct"]
        return total

    return fn, n


def make_batch_eval_resident(model: nn.Module, dataset_images: torch.Tensor,
                             dataset_labels: torch.Tensor,
                             data_cfg: DataConfig):
    """Single-batch accuracy against a device-resident split: ``fn(state,
    idx [B]) -> accuracy`` (device scalar), the index-fed mirror of
    :func:`make_eval_step` for the boundary metrics."""
    eval_step = make_eval_step(model)
    eval_cfg = _eval_data_cfg(data_cfg)

    def fn(state: TrainState, idx: torch.Tensor) -> torch.Tensor:
        images = device_preprocess(dataset_images[idx], eval_cfg)
        return eval_step(state, images, dataset_labels[idx])["accuracy"]

    return fn
