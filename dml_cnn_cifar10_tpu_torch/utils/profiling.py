"""Profiling hooks: the drain-anchored throughput meter, the FLOP count of
one training step, and a torch.profiler trace.

Port of ``dml_cnn_cifar10_tpu/utils/profiling.py``. :class:`DrainMeter` is
a copy. The JAX package reads a step's FLOPs from XLA's cost analysis
(``compiled_flops``) and repairs what it miscounts (a scanned layer stack
counted once, Pallas kernels counted as 0: ``correct_stack_flops``). The
port counts them instead: :func:`step_flops` runs one step's forward and
backward at batch 1 on the ``meta`` device under
``torch.utils.flop_counter.FlopCounterMode``, so no kernel runs and the
count takes milliseconds even at 8,100 tokens. The flash kernels reach
the dispatcher as registered operators whose FLOP formulas give the
dense-equivalent count (``ops/flash_attention.py``), and the remat
recompute runs and counts as it does in training. Every counted FLOP is
linear in the batch, so the batch-1 count times the rank's batch is the
rank's step. The optimizer update, which every rank runs whole, is added
by :func:`update_flops`, counted per parameter from the update's own
expressions (``train/optim.py``): FlopCounterMode counts no elementwise
work, and the update's ctypes kernels do not run on ``meta``. It is a
few FLOPs a parameter (K1: 2, K2 with weight decay: 6, AdamW: 16),
against thousands in the CNN's forward and backward.

The label :func:`step_flops` returns with the count says what it means,
and the ``train`` records carry it once as ``flops_stack``:

- ``exact``: the whole step of this rank, counted as it runs;
- ``seq_share_x{n}``: under sequence parallelism over ``n`` seq ranks,
  the full sequence's forward and backward of this rank's data row,
  divided by ``n``, and the whole update.
  Exact per rank for Ulysses (each rank runs 1/n of the heads over the
  whole sequence, and 1/n of the tokens elsewhere) and for the ring
  without a causal mask or a window (each rank attends its 1/n of the
  queries to every key);
- ``seq_mean_share_x{n}``: the same division for the ring with a causal
  mask or a window, whose ranks skip different numbers of blocks: the
  mean over the ranks, not each rank's own;
- ``convs_gemms``: the ResNet's whole step as counted: its convolutions
  and its head's matrix product, forward and backward, and the update;
  its BatchNorm, ReLUs, pooling and residual adds (elementwise and
  reduction work, as everywhere here) are not counted;
- ``model_share_x{m}``: under tensor parallelism over ``m`` model ranks,
  this rank's own step, counted exactly on a model built with the local
  widths of model rank 0 (every rank's are equal): the Megatron layers'
  ``1/m`` slices, the convolutions and the other replicated layers in
  full, as XLA's per-device count does in the JAX package. The mesh's
  collectives pass ``meta`` tensors through and call nothing.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Mapping, Optional, Sequence, Tuple

import torch
from torch.func import functional_call


class DrainMeter:
    """Drain-anchored throughput meter.

    Dispatches are async: host loop intervals measure ENQUEUE rate, not
    execution. Every device fetch is a true drain, so the exact training
    rate is (steps between drains) / (wall time between drains) —
    provided the window holds only training dispatches. Protocol: call
    :meth:`rate` right after a boundary's metric fetch, and :meth:`mark`
    at the END of any iteration that drained (metrics fetch, eval sweep,
    checkpoint fetch), so eval/checkpoint work never pollutes the next
    window.
    """

    def __init__(self, images_per_step: float):
        self.images_per_step = images_per_step
        self._mark: Optional[tuple] = None

    def rate(self, step: int) -> float:
        """images/sec since the previous mark; 0.0 before the first."""
        if self._mark is None:
            return 0.0
        prev_step, prev_t = self._mark
        dt = time.perf_counter() - prev_t
        if dt <= 0 or step <= prev_step:
            return 0.0
        return (step - prev_step) * self.images_per_step / dt

    def mark(self, step: int) -> None:
        self._mark = (step, time.perf_counter())


def update_flops(optim_cfg, shapes: Mapping[str, Sequence[int]]) -> int:
    """FLOPs of one optimizer update of ``optim_cfg`` (an ``OptimConfig``)
    over leaves of ``shapes`` (``{name: port-layout shape}``), as
    ``train/optim.py`` and the K1/K2 kernels compute it: one FLOP for each
    element of each add, multiply, divide, square, square root or
    reciprocal square root on a tensor of a leaf's size (or of its rows'
    or columns'), and one for each element a reduction sums; the work on
    0-d values (the LR schedule, bias corrections, the square roots of
    norms, trust ratios, clip scales) is left out. Per parameter:

    - SGD: ``p - lr·g`` 2, weight decay ``g + wd·p`` 2, momentum
      ``mu·m + g`` 2 (K1 2; K2 with weight decay 6);
    - AdamW 16 (``mu`` 3, ``nu`` 4, the step ``r`` 7, ``p - lr·r`` 2);
      LAMB 20 (the two norms of its trust ratio, 2 each);
    - LARS 6 (``g + wd·p``, momentum, ``p - lr·m``), and 5 more on leaves
      of two or more dims (two norms and the local-LR product);
    - Adafactor, on the JAX-layout view: 15 on a factored leaf (2 or more
      dims; plus 7 a row, 5 a column and 1 a leading index: the factored
      moments, their means and rsqrts), 16 on another;
    - clipping 3 (the global norm's square and sum, the scale),
      accumulation over A microbatches A (A − 1 sums, the division), the
      EMA 3.
    """
    from dml_cnn_cifar10_tpu_torch import convert

    o = optim_cfg
    sizes = {n: math.prod(s) for n, s in shapes.items()}
    n = sum(sizes.values())
    per = 3 * (o.grad_clip_norm is not None) + 3 * bool(o.ema_decay)
    if o.grad_accum > 1:
        per += o.grad_accum
    if o.optimizer in ("adamw", "lamb"):
        return (per + 16 + 4 * (o.optimizer == "lamb")) * n
    if o.optimizer == "lars":
        return (per + 6) * n + 5 * sum(sizes[k] for k, s in shapes.items()
                                       if len(s) > 1)
    if o.optimizer == "adafactor":
        total = per * n
        for name, shape in shapes.items():
            s = convert.jax_shape(name, shape)
            if len(s) < 2:
                total += 16 * sizes[name]
                continue
            lead = math.prod(s[:-2])
            total += (15 * sizes[name] + 7 * lead * s[-2]
                      + 5 * lead * s[-1] + lead)
        return total
    return (per + 2 + 2 * bool(o.weight_decay) + 2 * bool(o.momentum)) * n


def _meta_model(cfg, model_ranks: int = 1):
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh

    # Model rank 0 of a mesh that holds no process group: the model takes
    # its local widths, and its collectives see only meta tensors.
    mesh = Mesh(world=model_ranks, model=model_ranks) \
        if model_ranks > 1 else None
    with torch.device("meta"):
        return get_model(cfg.model.name)(cfg.model, cfg.data, mesh=mesh)


def _image_flops(cfg, model) -> int:
    """FLOPs of one training image's forward and backward for ``cfg``
    (a ``TrainConfig``) through ``model`` on the ``meta`` device, over the
    whole sequence (no mesh)."""
    from torch.utils.flop_counter import FlopCounterMode

    from dml_cnn_cifar10_tpu_torch.train import loss as loss_lib

    d = cfg.data
    params = {n: p.detach().requires_grad_()
              for n, p in model.named_parameters()}
    images = torch.empty((1, d.crop_height, d.crop_width, d.num_channels),
                         device="meta")
    labels = torch.zeros((1,), dtype=torch.int64, device="meta")
    with FlopCounterMode(display=False) as counter, torch.enable_grad():
        logits = functional_call(model, params, (images,))
        loss = loss_lib.softmax_cross_entropy(logits, labels,
                                              cfg.optim.label_smoothing)
        torch.autograd.grad(loss, list(params.values()))
    return int(counter.get_total_flops())


def step_flops(cfg, data: int = 1, seq: int = 1, model: int = 1
               ) -> Tuple[float, str]:
    """``(FLOPs of one training step on one rank, label)`` for ``cfg`` (a
    ``TrainConfig``) on a ``data x model x seq`` mesh: the forward and
    backward of this rank's ``batch_size / data`` images (all
    ``grad_accum`` microbatches) at its local widths, its ``1/seq`` share
    under sequence parallelism, and the update of its leaves
    (:func:`update_flops`). The labels are the module docstring's."""
    net = _meta_model(cfg, model)
    flops = _image_flops(cfg, net) * (cfg.batch_size // data)
    update = update_flops(cfg.optim, {n: tuple(p.shape) for n, p
                                      in net.named_parameters()})
    if model > 1:
        return float(flops + update), f"model_share_x{model}"
    if getattr(net, "has_state", False):
        return float(flops + update), "convs_gemms"
    if seq <= 1:
        return float(flops + update), "exact"
    m = cfg.model
    even = m.sp_mode == "ulysses" or (not m.attn_causal
                                      and m.attn_window is None)
    label = f"seq_share_x{seq}" if even else f"seq_mean_share_x{seq}"
    return flops / seq + update, label


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Capture a torch.profiler trace (host and, when there is a card,
    device activity) into ``log_dir/trace.json`` when set."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
