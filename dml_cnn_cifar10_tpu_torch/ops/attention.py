"""Multi-head attention ops.

Port of ``dml_cnn_cifar10_tpu/ops/attention.py``. Two implementations with
one contract::

    attention(q, k, v) -> out          # [B, S, H, D] each

- :func:`xla_attention` — the dense reference path: one softmax(QKᵀ·scale)V
  in f32 (the JAX package's fused XLA path, hence the name). Short
  sequences (ViT on CIFAR is 37 tokens) take it.
- :func:`~dml_cnn_cifar10_tpu_torch.ops.flash_attention.flash_attention`
  — the hand-written CUDA flash kernels for long sequences, where the S×S
  score matrix must never reach device memory.

:func:`dispatch_attention` picks one per call, with the JAX package's
``seq >= 128`` cut.
"""

from __future__ import annotations

from typing import Optional

import torch

from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa

NEG_INF = fa.NEG_INF  # finite: exp(-inf - -inf) would NaN a masked row
FLASH_MIN_TOKENS = 128   # the JAX package's cut: flash from here up


def mask_scores(scores: torch.Tensor, q_len: int, kv_len: int,
                causal: bool = False, segment_ids=None,
                window: Optional[int] = None,
                kv_start: int = 0) -> torch.Tensor:
    """The shared attention-validity mask on dense ``[..., Sq, Sk]`` scores
    (the flash kernels' ``score_live``): causal keeps col ≤ row; a window
    keeps ``|row − col| < window`` (with causal only the lower half);
    ``segment_ids`` ``[B, S]`` (or a ``(q_seg, kv_seg)`` pair) keep
    same-segment pairs only, and ``scores`` must then be
    ``[B, H, Sq, Sk]``. ``kv_start`` offsets the columns' global
    coordinates. The mask is the plain flash version's own."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    live = fa._live(q_len, kv_len, scores.device, causal, window, kv_start,
                    *fa._norm_segments(segment_ids))
    if segment_ids is None:
        live = live[0, 0]
    return torch.where(live, scores, NEG_INF)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None, causal: bool = False,
                  segment_ids=None,
                  window: Optional[int] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v over ``[B, S, H, D]`` tensors, in f32
    whatever the input dtype; the output is cast back to q's dtype. Rows
    with no live key emit exact zeros, as the flash kernels do. It is the
    flash kernels' plain version, differentiated by autograd."""
    return fa.flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                    segment_ids=segment_ids,
                                    window=window)[0]


def dispatch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: Optional[float] = None, causal: bool = False,
                       segment_ids=None,
                       window: Optional[int] = None) -> torch.Tensor:
    """The flash kernels from 128 tokens up, where they gain; the dense
    path below. Both differentiate and honor every mask."""
    if q.shape[1] >= FLASH_MIN_TOKENS:
        return fa.flash_attention(q, k, v, scale=scale, causal=causal,
                                  segment_ids=segment_ids, window=window)
    return xla_attention(q, k, v, scale=scale, causal=causal,
                         segment_ids=segment_ids, window=window)
