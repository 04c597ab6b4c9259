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
rank's step. The optimizer update is not counted: its ctypes kernels do
not run on ``meta``, and it is a few FLOPs a parameter (K1: 2, K2 with
weight decay: 6), against thousands of a parameter in the forward and
backward.

The label :func:`step_flops` returns with the count says what it means,
and the ``train`` records carry it once as ``flops_stack``:

- ``exact``: the whole step of this rank, counted as it runs;
- ``seq_share_x{n}``: under sequence parallelism over ``n`` seq ranks,
  the full sequence's step of this rank's data row, divided by ``n``.
  Exact per rank for Ulysses (each rank runs 1/n of the heads over the
  whole sequence, and 1/n of the tokens elsewhere) and for the ring
  without a causal mask or a window (each rank attends its 1/n of the
  queries to every key);
- ``seq_mean_share_x{n}``: the same division for the ring with a causal
  mask or a window, whose ranks skip different numbers of blocks: the
  mean over the ranks, not each rank's own.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional, Tuple

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


def _image_flops(cfg) -> int:
    """FLOPs of one training image's forward and backward for ``cfg``
    (a ``TrainConfig``), counted on the ``meta`` device over the whole
    sequence (no mesh)."""
    from torch.utils.flop_counter import FlopCounterMode

    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    from dml_cnn_cifar10_tpu_torch.train import loss as loss_lib

    d = cfg.data
    with torch.device("meta"):
        model = get_model(cfg.model.name)(cfg.model, d)
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


def step_flops(cfg, data: int = 1, seq: int = 1) -> Tuple[float, str]:
    """``(FLOPs of one training step on one rank, label)`` for ``cfg`` (a
    ``TrainConfig``) on a ``data x seq`` mesh: the forward and backward
    of this rank's ``batch_size / data`` images (all ``grad_accum``
    microbatches), its ``1/seq`` share under sequence parallelism. The
    labels are the module docstring's."""
    flops = _image_flops(cfg) * (cfg.batch_size // data)
    if seq <= 1:
        return float(flops), "exact"
    m = cfg.model
    even = m.sp_mode == "ulysses" or (not m.attn_causal
                                      and m.attn_window is None)
    label = f"seq_share_x{seq}" if even else f"seq_mean_share_x{seq}"
    return flops / seq, label


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
