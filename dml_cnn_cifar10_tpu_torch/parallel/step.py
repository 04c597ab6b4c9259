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
batch slice, scaled by ``1/replicas``, and the gradients are summed over
the ``replica`` group (the world, without model ranks) in one flat
all-reduce — the JAX package's ``psum``. That is the mean over the global
batch: every seq rank of a data row computes the same loss from the same
pooled features, and the pool's all-reduce sums the gradient back over the
seq ranks, so every leaf (token-side and post-pool alike) arrives ``seq``
times over before the ``1/replicas`` share. Under tensor parallelism
(``parallel/tp.py``; the state carries the model's ``split``) the model
ranks of a data row compute the same loss; each holds the whole gradient
of its own slices and of the replicated leaves (the Megatron operators sum
the activations' gradients over the model ranks), so the sum over the
ranks that hold the same slices is the data-parallel sum; the replicated
leaves' gradients are model rank 0's on every model rank first (one
broadcast), which keeps their copies bit-equal under nondeterministic
kernels; norms sum a split leaf's squares over ``model``. Under pipeline
parallelism (``parallel/pipeline.py``; the ViT's stages, the state's
``split`` over ``pipe``) every stage of a data row computes the same loss
from the last stage's output; a stage holds the whole gradient of its own
blocks and of the replicated leaves (the embed's through the input
gradient that stage 0 sends back to every stage, the head's from the
shared output), so the sum over the ``replica`` group (the data ranks of
the same stage) is the data-parallel sum; the replicated leaves'
gradients are stage 0's on every stage first (one broadcast), and norms
sum a stage's block squares over ``pipe``. The CNN's spatial split
(``parallel/spatial.py``) follows the sequence split's rule: every leaf
arrives ``seq`` times over. The loss and
accuracy metrics are averaged over the data group; the eval step sums
``correct`` over it. A state sharded over the data ranks
(``--optimizer_sharding zero1``, ``--fsdp``: ``parallel/zero.py``; the
state carries its layout) has its gradients reduce-scattered into each
rank's shards instead, which the update kernels take as they are; the
parameters are all-gathered after the update (zero1) or before the forward
(fsdp), explicitly, where the JAX package leaves GSPMD to insert the same
collectives (its ``_zero1_update``, ``_fsdp_gather_wrap``).

A model with experts (``vit_moe``) returns ``(logits, router stats)``
(:func:`split_aux`): the loss adds ``moe_aux_coef · aux_loss`` and the
stats join the metrics as ``moe_*`` (JAX ``parallel/step.py:182-193``),
out of a chunk's replay like the loss. Its routing is global over the
data ranks (``ops/moe.py``), so the step's microbatches are the JAX
package's (:func:`moe_microbatches`).

Every step builder sets the card's float32 and cuDNN mode
(:func:`f32_parity`): TF32 off, cuDNN's deterministic algorithms.

Within a step (JAX ``parallel/step.py:311-414``): ``grad_accum`` A > 1
splits the batch into A microbatches, sums their gradients in order,
divides by A and applies ONE update (the update kernel still launches
once a step); the metrics are the microbatches' mean. ``async_staleness``
S >= 2 takes the gradients at the snapshot in slot ``step % S`` of the
optimizer state's ring (S − 1 updates old), applies them to the live
parameters, and writes the updated parameters into that slot; the slot is
a device tensor, so a captured step reads it on the card. The gradient
and the update run inside ``torch.profiler.record_function("fwd_bwd")``
and ``("optimizer")``, the JAX package's scope names, which a profile
window (``utils/devprof.py``) attributes device time by.

Chunked dispatch (``TrainConfig.steps_per_dispatch``):
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

Over a mesh (the JAX package's ``make_train_chunk*`` over its mesh), the
chunk runs the mesh's step: every rank holds the whole split, the device
index stream gives every rank the same global ``[K, B]`` rows (a pure
function of the step and the seed), and each data rank gathers and
decodes its own ``b = B / data`` columns, ``[:, data_rank·b :
(data_rank+1)·b]``, drawing each image's augmentation at its column of
the global batch; the seq ranks and the pipeline stages of a data row
take the same columns. Host indices arrive as global rows
(:func:`global_rows`). Over NCCL the collectives of the K steps (the
gradient all-reduce, the metric means, the ring hops, the all-to-alls,
the pipeline's stage hops and broadcasts, the spatial split's halo
exchanges and gather) are captured in the graph with the kernels. Over
gloo a collective on the card stages through host memory, which no graph
can hold, so there the chunk runs its K steps eagerly, the body the CPU
runs (:func:`chunk_is_graphed`). The evals sweep each data
rank's strided shard and sum the counts over the data ranks.
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
from dml_cnn_cifar10_tpu_torch.parallel import tp, zero
from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh
from dml_cnn_cifar10_tpu_torch.train import loss as loss_lib
from dml_cnn_cifar10_tpu_torch.train import metrics as metrics_lib
from dml_cnn_cifar10_tpu_torch.train import optim as optim_lib


@dataclasses.dataclass
class TrainState:
    """Params + optimizer state + model state (empty but for the ResNet).

    ``params`` maps the model's parameter names to tensors on the device,
    in the port's layouts; ``opt`` is :func:`optim.sgd_init`'s dict.
    ``model_state`` maps the model's buffer names to its own buffers (the
    ResNet's BatchNorm running stats, ``<bn>.mean``/``<bn>.var``), which
    a train step updates in place; ``stateful`` says the model keeps one
    (the JAX ``ModelDef.has_state``: its checkpoints carry the
    ``model_state`` tree, and an EMA run keeps ``opt["ema_mstate"]``, the
    running stats' average, which eval reads with the parameter EMA).
    Under a sharded ``layout`` (``parallel/zero.py``) the entries of
    ``layout.keys`` hold this rank's shards for every leaf the layout
    splits, views of one flat buffer an entry; fsdp's parameter buffer is
    ``flat["params"]``, which the step all-gathers.
    """

    params: Dict[str, torch.Tensor]
    opt: Dict[str, Any]
    model_state: Dict[str, Any] = dataclasses.field(default_factory=dict)
    layout: Optional[Any] = None
    flat: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    #: The model's ``tp.ModelSplit`` under tensor parallelism: which
    #: leaves hold this model rank's slice.
    split: Optional[Any] = None
    stateful: bool = False

    @property
    def step(self) -> torch.Tensor:
        return self.opt["step"]


#: The cuDNN mode every step builder sets, named on the trainer's
#: start-up line.
CUDNN_MODE = "cudnn deterministic, benchmark off, TF32 off"


def f32_parity() -> None:
    """Keep convolutions and matrix products in full float32 on the card,
    and cuDNN on its deterministic algorithms: cuDNN convolutions default
    to TF32 (~3 decimal digits), which would break parity with the JAX
    package's float32 math, and its default algorithms sum with atomics,
    so two runs of one step part (the JAX package's repeat bit for bit;
    its exact-resume contract relies on that). No flag turns this off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def init_train_state(model: nn.Module, optim_cfg: OptimConfig,
                     device: torch.device,
                     generator: Optional[torch.Generator] = None,
                     layout=None) -> TrainState:
    """Initialize ``model``'s parameters from ``generator`` (on the CPU,
    so a seed gives the same weights on every device), move the model to
    ``device`` and build the optimizer state there. The state's params
    are the module's own ``nn.Parameter`` objects.

    Under a ``layout`` the sharded entries are allocated as this rank's
    shards from the start; under fsdp the module keeps no whole copy of
    a split leaf (its parameter is emptied: the step hands the forward
    the gathered tensors) and ``params`` holds the shards. A model built
    on model ranks holds its slices already (its ``split``), which the
    state carries. A model with running stats (``has_state``) gets its
    buffers as ``model_state`` and, with ``ema_decay``, their copy as
    ``opt["ema_mstate"]``."""
    split = getattr(model, "split", None)
    if split is not None and optim_cfg.optimizer == "adafactor":
        what = "tensor" if split.over == "model" else "pipeline"
        raise NotImplementedError(
            f"adafactor under {what} parallelism is not ported: its "
            f"factored statistics are computed over the whole leaf; see "
            f"{tp.ROADMAP}")
    if layout is not None and layout.fsdp:
        for name, p in model.named_parameters():
            if tuple(p.shape) != layout.leaves[name].shape:
                p.data = torch.empty(layout.leaves[name].shape,
                                     dtype=p.dtype)
    model.reset_parameters(generator)
    stateful = getattr(model, "has_state", False)

    def with_model_state(state: TrainState) -> TrainState:
        state.model_state = dict(model.named_buffers())
        state.stateful = stateful
        if stateful and optim_cfg.ema_decay:
            state.opt["ema_mstate"] = {n: t.detach().clone() for n, t in
                                       state.model_state.items()}
        return state

    if layout is None:
        model.to(device)
        params = dict(model.named_parameters())
        return with_model_state(TrainState(
            params=params, opt=optim_lib.sgd_init(params, optim_cfg, device),
            split=split))
    full = {n: p.detach() for n, p in model.named_parameters()}
    opt = optim_lib.sgd_init(full, optim_cfg, device, layout=layout)
    flat: Dict[str, torch.Tensor] = {}
    if layout.fsdp:
        flat["params"], shards = layout.pack(full, device)
        for name, p in model.named_parameters():
            if layout.is_split(name):
                p.data = torch.empty(0, dtype=p.dtype)
    model.to(device)
    params = dict(model.named_parameters())
    if layout.fsdp:
        params = {n: shards[n] if layout.is_split(n) else p
                  for n, p in params.items()}
    return with_model_state(TrainState(params=params, opt=opt,
                                       layout=layout, flat=flat,
                                       split=split))


def _sum_grads(grads, mesh: Mesh):
    """Sum the gradients over the ranks that hold the same weights (the
    world without model ranks) in place, in one all-reduce of their
    concatenation."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    mesh.all_reduce_(flat, "replica")
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _same_replicated(grads, names, split) -> None:
    """Give every rank of the split's axis (the model ranks, or the
    pipeline's stages) its rank 0's gradients of the replicated leaves,
    in one broadcast of their concatenation. With deterministic kernels
    they are equal already; cuDNN's nondeterministic backward (atomics)
    would otherwise let the ranks' copies of those leaves drift apart
    step by step, and the Megatron layers take their input as the same
    on every model rank, as the stages take the embedding."""
    idx = [i for i, n in enumerate(names) if not split.is_split(n)]
    flat = torch.cat([grads[i].reshape(-1) for i in idx])
    split.mesh.broadcast_(flat, split.over)
    for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
        grads[i].copy_(part.view_as(grads[i]))


def _data_mean(values, mesh: Optional[Mesh]) -> torch.Tensor:
    """Stack scalar metrics and average them over the data group."""
    v = torch.stack([t.float() for t in values])
    if mesh is not None and mesh.data > 1:
        mesh.all_reduce_(v, "data").div_(mesh.data)
    return v


def _norms(tensors) -> torch.Tensor:
    """Each tensor's L2 norm, accumulated in float32 (JAX
    ``parallel/step.py:_global_norm`` casts to f32 first), in one
    multi-tensor launch; stacked."""
    return torch.stack(torch._foreach_norm(tensors, 2,
                                           dtype=torch.float32))


def _global_norm(names, tensors, layout, split=None) -> torch.Tensor:
    """The L2 norm over every leaf: of the tensors themselves, or under a
    ``layout`` or a model ``split`` of the whole leaves their shards are
    slices of."""
    if layout is None and split is None:
        return torch.linalg.vector_norm(_norms(tensors))
    return torch.sqrt(torch.sum(tp.sq_sums(names, tensors, layout, split)))


def _gathered_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """fsdp's parameters for the forward: every split leaf all-gathered
    whole from the ranks' shards (new tensors, leaves of the autograd
    graph), the whole leaves as they are."""
    layout = state.layout
    full = layout.gather(state.flat["params"])
    return {n: (full[n] if n in full else p).requires_grad_()
            for n, p in state.params.items()}


def forward(model: nn.Module, variables: Mapping[str, torch.Tensor],
            images: torch.Tensor, train: bool):
    """The model's output on ``variables`` (its parameters and buffers by
    name) in train or eval mode: a model with BatchNorm normalizes by
    the batch and updates the buffers given in place in train mode, and
    reads them in eval mode. The logits, or for a model with experts
    ``(logits, router stats)`` (:func:`split_aux`)."""
    if model.training != train:
        model.train(train)
    return functional_call(model, variables, (images,))


def split_aux(out) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """``(logits, router stats or None)`` of a model's output."""
    return (out[0], out[1]) if isinstance(out, tuple) else (out, None)


def moe_microbatches(model: nn.Module, accum: int,
                     mesh: Optional[Mesh]) -> Tuple[int, bool]:
    """``(microbatches a rank runs, routing over the data ranks)`` for
    ``grad_accum`` A. The JAX step splits the GLOBAL batch into A
    microbatches of contiguous rows, each routed as one batch. Without
    experts, or over one data rank, a rank splits its batch into A. With
    experts over D data ranks, each data rank holds A/D of JAX's
    microbatches whole (rank-major rows), which it routes alone, so it
    runs A/D of them; a microbatch that spans data ranks (D not dividing
    A) is not ported."""
    data = 1 if mesh is None else mesh.data
    if not getattr(model, "experts", 0) or data == 1 or accum == 1:
        return accum, True
    if accum % data:
        raise NotImplementedError(
            f"grad_accum={accum} over {data} data ranks with experts: the "
            f"JAX package routes each of its {accum} microbatches of the "
            f"global batch as one, and one that spans data ranks is not "
            f"ported (make grad_accum a multiple of the data ranks); see "
            f"ROADMAP.md Queue 1, the open sharding items")
    return accum // data, False


def make_train_step(model: nn.Module, optim_cfg: OptimConfig,
                    mesh: Optional[Mesh] = None,
                    health_metrics: bool = False
                    ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                  Tuple[TrainState, dict]]:
    """``(state, images, labels) -> (state, {"loss", "accuracy"})``; the
    state is updated in place and returned. Over a mesh, ``images`` are
    this data rank's slice of the global batch and the metrics are the
    global batch's.

    ``health_metrics`` adds JAX ``_health_stats``' three scalars to the
    metrics, device tensors like the loss: ``health_grad_norm`` (the
    global norm of the gradients the update takes: after accumulation and
    the sum over the ranks, before clipping, which the update does),
    ``health_param_norm`` (of the parameters before the update) and
    ``health_update_ratio`` (``‖Δθ‖ / (‖θ‖ + 1e-12)``). The update works
    in place, so the step first copies the parameters into buffers of
    its own (inside a captured chunk, the graph's), in one multi-tensor
    launch; the norms take about a dozen small kernels a step.

    A state with a ``layout`` (``parallel/zero.py``, over ``mesh``'s data
    ranks) has its update sharded: zero1 reduce-scatters the gradients,
    copies this rank's slices of the parameters into a flat buffer,
    updates it (K1/K2, one launch) with the moment shards, and all-gathers
    the new parameters back into the whole ones; fsdp all-gathers the
    parameters before the forward, reduce-scatters the gradients and
    updates the stored shards. Leaves the layout keeps whole are
    all-reduced and updated whole. The health norms sum the shards'
    partial squares over the data ranks.

    A model with running stats (the ResNet) runs in train mode on the
    state's ``model_state`` buffers and updates them in place, each
    microbatch after the one before (JAX's accumulation scan); over
    several data ranks its batch statistics are the global batch's
    (cross-replica BN, ``ops/layers.py``). ``opt["ema_mstate"]`` follows
    the new stats after the update."""
    f32_parity()
    if (optim_cfg.async_staleness >= 2 and mesh is not None
            and mesh.pipe > 1):
        # JAX parallel/step.py:496-503: the pipe rule would shard the
        # snapshot ring's leading axis.
        raise ValueError(
            "async_staleness does not compose with pipeline parallelism "
            "(the pipe sharding rule would claim the snapshot ring's "
            "leading axis)")
    replicas = 1 if mesh is None else mesh.replicas
    accum, over_data = moe_microbatches(
        model, max(1, optim_cfg.grad_accum), mesh)
    staleness = max(0, optim_cfg.async_staleness)
    experts = getattr(model, "experts", 0)
    aux_coef = model.cfg.moe_aux_coef if experts else 0.0

    def grads_and_metrics(params, names, images, labels):
        if experts:
            model.route_over_data = over_data
        try:
            logits, aux = split_aux(forward(model, params, images,
                                            train=True))
            loss = loss_lib.softmax_cross_entropy(
                logits, labels, optim_cfg.label_smoothing)
            if aux is not None:
                # JAX parallel/step.py:182-193: the load-balance term
                # joins the loss; the router stats join the metrics.
                loss = loss + aux_coef * aux["aux_loss"]
            # The update kernels take contiguous leaves; a kernel that
            # reaches its layer through a permute (the ViT's HWIO patch
            # embed) gets its gradient back as a permuted view.
            grads = [g.contiguous() for g in torch.autograd.grad(
                loss / replicas if replicas > 1 else loss,
                [params[n] for n in names])]
        finally:
            if experts:
                model.route_over_data = True
        stats = {} if aux is None else {
            "moe_" + k: v.detach() for k, v in aux.items()}
        return grads, loss.detach(), metrics_lib.batch_accuracy(
            logits, labels), stats

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        names = list(state.params)
        layout, split = state.layout, state.split
        if staleness >= 2:
            slot = (state.opt["step"] % staleness).long().reshape(1)
            fwd = {n: torch.index_select(state.opt["stale"][n], 0, slot)[0]
                   .requires_grad_() for n in names}
        elif layout is not None and layout.fsdp:
            fwd = _gathered_params(state)
        else:
            fwd = state.params
        if state.model_state:
            fwd = {**fwd, **state.model_state}
        with torch.profiler.record_function("fwd_bwd"), \
                torch.enable_grad():
            if accum == 1:
                grads, loss, acc, stats = grads_and_metrics(
                    fwd, names, images, labels)
            else:
                b = images.shape[0]
                if b % accum:
                    raise ValueError(
                        f"batch {b} not divisible by grad_accum {accum}")
                grads = loss = acc = stats = None
                for ims, lbs in zip(images.split(b // accum),
                                    labels.split(b // accum)):
                    g, l, a, st = grads_and_metrics(fwd, names, ims, lbs)
                    if grads is None:
                        grads, loss, acc, stats = g, l, a, st
                    else:
                        grads = [x + y for x, y in zip(grads, g)]
                        loss, acc = loss + l, acc + a
                        stats = {k: v + st[k] for k, v in stats.items()}
                grads = [g / accum for g in grads]
                loss, acc = loss / accum, acc / accum
                stats = {k: v / accum for k, v in stats.items()}
            with torch.no_grad():
                if split is not None:
                    _same_replicated(grads, names, split)
                if layout is not None:
                    grads = layout.reduce_scatter(dict(zip(names, grads)))
                elif replicas > 1:
                    _sum_grads(grads, mesh)
        if layout is None:
            grads = dict(zip(names, grads))
        with torch.no_grad():
            # The tensors the update takes: this rank's shards (zero1:
            # copied from the whole parameters) and the whole leaves.
            update = state.params
            if layout is not None and not layout.fsdp:
                shards, update = layout.pack(state.params)
            loss_m, acc = _data_mean([loss, acc], mesh)
            if stats and not over_data:
                # Each data rank routed its own microbatches: the stats
                # are the mean over every rank's (global routing gives
                # every rank the global batch's already).
                stats = {k: _data_mean([v], mesh)[0]
                         for k, v in stats.items()}
            if health_metrics:
                before = torch._foreach_mul(
                    [update[n].detach() for n in names], 1.0)
                grad_norm = _global_norm(names, [grads[n] for n in names],
                                         layout, split)
                param_norm = _global_norm(names, before, layout, split)
        with torch.profiler.record_function("optimizer"), torch.no_grad():
            optim_lib.sgd_update(grads, state.opt, update, optim_cfg,
                                 layout=layout, split=split)
            if layout is not None and not layout.fsdp:
                layout.gather(shards, into={n: state.params[n].detach()
                                            for n in names})
            if staleness >= 2:
                # The slot just consumed receives the updated params (the
                # worker pushes its apply and fetches again).
                for n in names:
                    state.opt["stale"][n].index_copy_(
                        0, slot, state.params[n].detach()[None])
            if "ema_mstate" in state.opt:
                # Toward the new running stats at the decay of the update
                # just counted (JAX parallel/step.py:397-401).
                d = optim_lib.ema_decay_at(optim_cfg, state.opt["step"])
                for name, e in state.opt["ema_mstate"].items():
                    e.copy_(d * e + (1 - d) * state.model_state[name])
        metrics = {"loss": loss_m, "accuracy": acc, **stats}
        if health_metrics:
            with torch.no_grad():
                delta = torch._foreach_sub(
                    [update[n].detach() for n in names], before)
                metrics.update(
                    health_grad_norm=grad_norm,
                    health_param_norm=param_norm,
                    health_update_ratio=_global_norm(names, delta, layout,
                                                     split)
                    / (param_norm + 1e-12))
        return state, metrics

    return step


def eval_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """The weights eval scores with: the parameter EMA when the optimizer
    keeps one, else the parameters; whole, gathered over the data ranks
    (a collective) where the state's layout keeps them as shards. With
    them, by buffer name, the running stats eval normalizes by: the
    average ``ema_mstate`` when kept, else ``model_state`` (JAX
    ``parallel/step.py:830-831``)."""
    if "ema" in state.opt:
        params = zero.whole(state, "ema", state.opt["ema"])
    else:
        params = zero.whole(state, "params", state.params)
    mstate = state.opt.get("ema_mstate", state.model_state)
    return {**params, **mstate} if mstate else params


def make_eval_step(model: nn.Module, mesh: Optional[Mesh] = None
                   ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                 dict]:
    """``(state, images, labels) -> {"accuracy", "correct"}`` — single-batch
    accuracy for faithful eval (``cifar10cnn.py:237-241``) and the
    summable correct count for the full-test-set sweep, both over the
    data group's batches. Uses the parameter EMA when the optimizer keeps
    one (:func:`eval_params`; the call may pass those weights already
    gathered as ``params``)."""
    f32_parity()

    @torch.no_grad()
    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
             params: Optional[Dict[str, torch.Tensor]] = None):
        if params is None:
            params = eval_params(state)
        logits, _ = split_aux(forward(model, params, images, train=False))
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


def _data_rank(mesh: Optional[Mesh]) -> int:
    return 0 if mesh is None else mesh.data_rank


def global_rows(idx: np.ndarray, mesh: Optional[Mesh]) -> np.ndarray:
    """Rows of a data rank's strided shard (``records[data_rank::data]``,
    ``data/pipeline.py``) as rows of the whole split: ``shard + idx ·
    num_shards`` (JAX ``train/loop.py:476-479``)."""
    if mesh is None or mesh.data == 1:
        return idx
    return mesh.data_rank + idx * mesh.data


def chunk_is_graphed(mesh: Optional[Mesh]) -> bool:
    """Whether a chunk whose state is on the card runs as one CUDA graph:
    yes, unless its collectives stage through host memory (gloo on the
    card), which a graph cannot hold; then the K steps run eagerly."""
    return mesh is None or mesh.world == 1 or mesh.backend != "gloo"


def _chunk_body(model: nn.Module, optim_cfg: OptimConfig,
                data_cfg: Optional[DataConfig], mesh: Optional[Mesh] = None,
                health_metrics: bool = False):
    """``(state, images [K, b, ...], labels [K, b]) -> (state, metrics of
    the LAST step)``: the K-step math shared by every ``make_train_chunk*``,
    over ``mesh`` on this data rank's ``b`` columns of the global batch.

    With ``data_cfg`` the images are RAW uint8 and the decode runs first,
    over the whole chunk at once (``[K, b]`` rows draw their augmentation
    at ``state.step + k`` and at their column of the global batch), or one
    batch a step past ``_DECODE_IN_LOOP_BYTES``; either way each batch
    decodes exactly as it would alone. With ``health_metrics`` the last
    step's health scalars come with its loss (:func:`make_train_step`)."""
    one_step = make_train_step(model, optim_cfg, mesh, health_metrics)

    def run(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        decode_in_loop = False
        col0 = _data_rank(mesh) * images.shape[1]
        if data_cfg is not None:
            k, b, h, w = images.shape[:4]
            decoded = (k * b * max(h, data_cfg.crop_height)
                       * max(w, data_cfg.crop_width)
                       * data_cfg.num_channels * 4)
            decode_in_loop = decoded > _DECODE_IN_LOOP_BYTES
            if not decode_in_loop:
                images = device_preprocess(images, data_cfg, state.step,
                                           col0)
        metrics = None
        for i in range(images.shape[0]):
            imgs = images[i]
            if decode_in_loop:
                imgs = device_preprocess(imgs, data_cfg, state.step, col0)
            state, metrics = one_step(state, imgs, labels[i])
        return state, metrics

    return run


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor of the state (params, the optimizer state and the
    model state, at any depth of nesting), in a fixed order."""
    out: List[torch.Tensor] = []

    def walk(value) -> None:
        if isinstance(value, torch.Tensor):
            out.append(value)
        elif isinstance(value, Mapping):
            for v in value.values():
                walk(v)

    for tree in (state.params, state.opt, state.model_state):
        walk(tree)
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
    workspaces, the kernels' libraries load, and over NCCL every
    communicator the body uses is set up, on every rank, by the
    collectives themselves), puts every tensor of the state back as it
    was, captures the body once on the caller's state and static input
    buffers, and replays it. Every call is one replay. The ranks of a mesh
    warm up, capture and replay in lockstep: each runs the same calls in
    the same order. The kernel launch counters count the caller's steps:
    each replay adds the launches its capture recorded; the warm-up's,
    whose results are thrown away, are kept apart in
    :attr:`warmup_launches`. The metrics returned are the graph's own
    output buffers, overwritten by the next replay.

    ``prepare(step)``, when given, runs on the host before the warm-up and
    before every replay with the chunk's first global step, which the
    wrapper tracks on the host (read from ``state.step`` once, at
    capture, then advanced by ``k`` a call): the device index stream's
    table refresh (``data/device_stream.py:EpochRows``).

    With :attr:`learn_update` set before the first call (a profile window
    will read the replays), the warm-up runs under torch.profiler, unless
    a profiler is already running, and :attr:`update_signature` keeps
    which of its device events the update launched
    (``utils/devprof.py:update_signature``).
    """

    def __init__(self, body: Callable, prepare: Optional[Callable] = None,
                 k: int = 0, mesh: Optional[Mesh] = None):
        self._body, self._prepare, self._k = body, prepare, k
        self._mesh = mesh
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._tensors: List[torch.Tensor] = []
        self._inputs: List[torch.Tensor] = []
        self._metrics: Optional[dict] = None
        self._captured: List[Dict[str, int]] = []
        self._step = 0
        #: Replays run, and the launches of the warm-up before capture.
        self.replays = 0
        self.warmup_launches: Dict[str, int] = {}
        self.learn_update = False
        self.update_signature: Optional[Dict[str, Tuple[int, ...]]] = None

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

    def release(self) -> None:
        """Free the graph and its memory pool; the next call captures
        anew. Over NCCL a graph holds resources of the communicators it
        captured, so it must go before they are destroyed."""
        if self._graph is not None:
            self._graph.reset()
            self._graph, self._metrics = None, None

    def _warm_up(self, state: TrainState) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._body(state, *self._inputs)
        torch.cuda.current_stream().wait_stream(side)

    def _profiled_warm_up(self, state: TrainState) -> None:
        """The warm-up under torch.profiler; keeps the update's events."""
        import json
        import os
        import tempfile

        from torch.profiler import ProfilerActivity, profile

        from dml_cnn_cifar10_tpu_torch.utils import devprof

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            self._warm_up(state)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "warmup.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.update_signature = devprof.update_signature(json.load(f))

    def _capture(self, state: TrainState, inputs) -> None:
        self._tensors = _state_tensors(state)
        self._inputs = [t.clone() for t in inputs]
        self._step = int(state.step)            # the one host read
        before = _counts()
        saved = [t.detach().clone() for t in self._tensors]
        if self._prepare is not None:
            self._prepare(self._step)
        if self.learn_update and not torch._C._autograd._profiler_enabled():
            self._profiled_warm_up(state)
        else:
            self._warm_up(state)
        with torch.no_grad():
            for t, s in zip(self._tensors, saved):
                t.copy_(s)
        del saved
        warm = _delta(before)
        self.warmup_launches = {k: n for d in warm for k, n in d.items()}
        _set_counts(before)
        # Over several ranks, ProcessGroupNCCL's watchdog thread queries
        # the CUDA events of the warm-up's collectives while this thread
        # captures. Under the default "global" mode any such call from
        # another thread invalidates the capture; "thread_local" checks
        # this thread's calls only. Wait for the warm-up first, so the
        # watchdog has no work in flight left to query.
        mode = "global"
        if self._mesh is not None and self._mesh.world > 1:
            torch.cuda.synchronize()
            mode = "thread_local"
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode=mode):
            _, metrics = self._body(state, *self._inputs)
        self._captured = _delta(before)
        _set_counts(before)
        self._graph, self._metrics = graph, metrics


def _dispatch(eager: Callable, graphed: Optional[_GraphedChunk],
              mesh: Optional[Mesh] = None) -> Callable:
    """What ``make_train_chunk*`` return: ``eager`` for a state on the
    CPU, the graph for a state on the card (never the other way round),
    or ``eager`` on the card where :func:`chunk_is_graphed` says no."""
    graph_on_card = chunk_is_graphed(mesh)
    if not graph_on_card:
        graphed = None

    def chunk(state: TrainState, *inputs: torch.Tensor):
        if not state.step.is_cuda or not graph_on_card:
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
                     data_cfg: Optional[DataConfig] = None,
                     mesh: Optional[Mesh] = None,
                     health_metrics: bool = False
                     ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                   Tuple[TrainState, dict]]:
    """K training steps a call: ``(state, images [K, b, ...], labels
    [K, b]) -> (state, metrics of the LAST step)``, the state updated in
    place; over ``mesh`` the images are this data rank's ``b`` columns of
    the global batch. With ``data_cfg`` the images are RAW uint8
    full-size ``[K, b, H, W, C]`` and the decode runs on the device. On
    the card the K steps are one CUDA graph replay (but see
    :func:`chunk_is_graphed`); the inputs are copied into its static
    buffers, so they must keep the shapes of the first call."""
    body = _chunk_body(model, optim_cfg, data_cfg, mesh, health_metrics)
    return _dispatch(body, _GraphedChunk(body, mesh=mesh), mesh)


def make_train_chunk_resident(
    model: nn.Module,
    optim_cfg: OptimConfig,
    dataset_images: torch.Tensor,
    dataset_labels: torch.Tensor,
    data_cfg: Optional[DataConfig] = None,
    index_stream: Optional[Tuple[int, int, int]] = None,
    mesh: Optional[Mesh] = None,
    health_metrics: bool = False,
) -> Callable:
    """Chunked training against a device-resident split: ``(state, idx
    [K, b]) -> (state, metrics of the LAST step)``. ``dataset_images``
    ``[N, H, W, C]`` uint8 and ``dataset_labels`` ``[N]`` (the whole
    split, on every rank of a mesh) live on the state's device; the
    gather, the decode and the K steps run there, the host ships only the
    indices, rows of the whole split (:func:`global_rows`), this data
    rank's ``b`` columns of the global batch. Same math as
    :func:`make_train_chunk` on the same rows.

    ``index_stream=(seed, global_batch, K)`` generates the indices on the
    device too (``data/device_stream.py``, keyed on ``state.step``): the
    global ``[K, B]`` rows, of which this data rank takes its columns, and
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
    body = _chunk_body(model, optim_cfg, data_cfg, mesh, health_metrics)

    if index_stream is None:
        def chunk_idx(state: TrainState, idx: torch.Tensor):
            return body(state, dataset_images[idx], dataset_labels[idx])

        return _dispatch(chunk_idx, _GraphedChunk(chunk_idx, mesh=mesh),
                         mesh)

    seed, global_batch, k = index_stream
    n = dataset_images.shape[0]
    b = global_batch // (1 if mesh is None else mesh.data)
    cols = slice(_data_rank(mesh) * b, (_data_rank(mesh) + 1) * b)

    def chunk_exact(state: TrainState):
        idx = device_stream.chunk_shuffle_indices(
            seed, state.step, global_batch, k, n)[:, cols]
        return body(state, dataset_images[idx], dataset_labels[idx])

    if not dataset_images.is_cuda or not chunk_is_graphed(mesh):
        return _dispatch(chunk_exact, None, mesh)
    rows = device_stream.EpochRows(seed, global_batch, k, n,
                                   dataset_images.device)

    def chunk_table(state: TrainState):
        idx = rows.lookup(state.step)[:, cols]
        return body(state, dataset_images[idx], dataset_labels[idx])

    fn = _dispatch(chunk_exact, _GraphedChunk(chunk_table, rows.prepare, k,
                                              mesh), mesh)
    fn.rows = rows
    fn.check = rows.check
    return fn


def _eval_data_cfg(data_cfg: DataConfig) -> DataConfig:
    """Eval-time decode config: deterministic (all augmentation off)."""
    return data_cfg.without_augmentation()


def make_eval_resident(model: nn.Module, images_u8: np.ndarray,
                       labels: np.ndarray, data_cfg: DataConfig,
                       device: torch.device, batch_size: int = 128,
                       expected_batches: Optional[int] = None,
                       mesh: Optional[Mesh] = None,
                       total_records: Optional[int] = None):
    """Full-split eval against a device-resident split: returns ``(fn,
    total)`` with ``fn(state) -> correct count`` (a device scalar) over
    all ``total`` records. The split is padded on the host to whole
    batches (pad labels -1 count 0, as ``full_sweep_padded``), placed on
    ``device`` once as ``[M, B, ...]`` uint8, and each call decodes and
    scores the M batches with one read at the end.

    Over a mesh with several data ranks, ``images_u8`` and ``labels`` are
    this data rank's strided shard of a split of ``total_records`` and
    ``batch_size`` its share of the eval batch: every rank pads to the
    batches of the largest shard, ``M = ceil(ceil(total / data) / B)``,
    and the count is summed over the data ranks (JAX ``train/
    loop.py:517-532``)."""
    shards = 1 if mesh is None else mesh.data
    n = images_u8.shape[0]
    if shards > 1 and total_records is None:
        # M from the local shard would differ between ranks (strided
        # shards differ by one record): unequal sweeps hang the sum.
        raise ValueError("make_eval_resident over several data ranks needs "
                         "total_records (the split's size before sharding)")
    total = n if total_records is None else int(total_records)
    largest_shard = -(-total // shards)
    m = -(-largest_shard // batch_size)
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
    # The model's own collectives (a seq rank's tokens) run inside the
    # step; the count is summed once, after the sweep.
    eval_step = make_eval_step(model)
    eval_cfg = _eval_data_cfg(data_cfg)

    def fn(state: TrainState) -> torch.Tensor:
        count = torch.zeros((), dtype=torch.int64, device=device)
        params = eval_params(state)    # gathered once a sweep
        for i in range(m):
            count += eval_step(state, device_preprocess(ims[i], eval_cfg),
                               lbs[i], params)["correct"]
        if shards > 1:
            mesh.all_reduce_(count, "data")
        return count

    return fn, total


def make_batch_eval_resident(model: nn.Module, dataset_images: torch.Tensor,
                             dataset_labels: torch.Tensor,
                             data_cfg: DataConfig,
                             mesh: Optional[Mesh] = None):
    """Single-batch accuracy against a device-resident split: ``fn(state,
    idx [b]) -> accuracy`` (device scalar), the index-fed mirror of
    :func:`make_eval_step` for the boundary metrics; over a mesh ``idx``
    is this data rank's slice of the batch, in rows of the whole split,
    and the accuracy the data ranks' mean."""
    eval_step = make_eval_step(model, mesh)
    eval_cfg = _eval_data_cfg(data_cfg)

    def fn(state: TrainState, idx: torch.Tensor) -> torch.Tensor:
        images = device_preprocess(dataset_images[idx], eval_cfg)
        return eval_step(state, images, dataset_labels[idx])["accuracy"]

    return fn
