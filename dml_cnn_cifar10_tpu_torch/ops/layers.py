"""Core layer primitives: init schemes + conv/pool/dense.

The public functions take the JAX package's layouts (NHWC activations,
HWIO conv kernels, ``[in, out]`` dense kernels) so tests compare like
with like against ``dml_cnn_cifar10_tpu/ops/layers.py``. The model calls
the ``*_nchw`` forms, which keep activations in PyTorch's NCHW layout
for cuDNN. Convolutions, pools and matrix products stay on cuDNN/cuBLAS,
as the JAX package left them to XLA.

Parity notes (``cifar10cnn.py``):
- ``truncated_normal_`` == ``tf.truncated_normal_initializer(stddev=0.05)``
  (``:97-98``): normal samples truncated to ±2σ, not rescaled. The draws
  differ from ``jax.random.truncated_normal``; tests load JAX's params.
- ``conv2d`` == ``tf.nn.conv2d(..., padding='SAME')`` (``:107,118``).
- ``max_pool`` == ``tf.nn.max_pool(ksize 3, stride 2, 'SAME')``
  (``:113,123``): TF pads SAME windows with the odd pixel AFTER (0 before,
  1 after for 24→12 and 12→6), with -inf. ``nn.MaxPool2d`` pads
  symmetrically, so the pad is explicit here.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def truncated_normal_(t: torch.Tensor, stddev: float = 0.05,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
    """In-place truncated-normal (±2σ) init, TF-compatible (no rescaling)."""
    return torch.nn.init.trunc_normal_(t, mean=0.0, std=stddev,
                                       a=-2.0 * stddev, b=2.0 * stddev,
                                       generator=generator)


def _same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """TF "SAME" padding (before, after) along one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def conv2d_nchw(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None = None, stride: int = 1
                ) -> torch.Tensor:
    """NCHW conv with an OIHW kernel, TF "SAME" padding."""
    ph = _same_pads(x.shape[2], weight.shape[2], stride)
    pw = _same_pads(x.shape[3], weight.shape[3], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, weight, bias, stride=stride,
                        padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), weight, bias,
                    stride=stride)


def max_pool_nchw(x: torch.Tensor, window: int = 3, stride: int = 2
                  ) -> torch.Tensor:
    """NCHW max pool with TF "SAME" padding by -inf."""
    ph = _same_pads(x.shape[2], window, stride)
    pw = _same_pads(x.shape[3], window, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def conv2d(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1
           ) -> torch.Tensor:
    """NHWC conv with an HWIO kernel → NHWC out (the JAX package's
    layout), TF "SAME" padding."""
    y = conv2d_nchw(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                    stride=stride)
    return y.permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2
             ) -> torch.Tensor:
    """NHWC max pool, TF "SAME" padding."""
    y = max_pool_nchw(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` with ``w`` in the JAX package's ``[in, out]`` layout."""
    return torch.addmm(b, x, w)


def pooled_hw(h: int, w: int, n_pools: int, stride: int = 2
              ) -> Tuple[int, int]:
    """Spatial dims after ``n_pools`` SAME-padded stride-2 pools."""
    for _ in range(n_pools):
        h = -(-h // stride)
        w = -(-w // stride)
    return h, w
