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
- ``conv2d`` == ``tf.nn.conv2d(..., padding='SAME')`` (``:107,118``);
  ``padding="VALID"`` is the ViT's stride-``patch`` patch embed.
- ``he_normal_`` == the JAX package's ``he_normal_init`` (ViT kernels).
- ``max_pool`` == ``tf.nn.max_pool(ksize 3, stride 2, 'SAME')``
  (``:113,123``): TF pads SAME windows with the odd pixel AFTER (0 before,
  1 after for 24→12 and 12→6), with -inf. ``nn.MaxPool2d`` pads
  symmetrically, so the pad is explicit here.
- ``batch_norm`` is the JAX package's ``batch_norm`` (``ops/layers.py:
  75-140`` there), written out in plain torch ops rather than
  ``nn.BatchNorm2d``/``nn.SyncBatchNorm``, whose semantics differ: they
  keep the *unbiased* batch variance in the running stats, take
  ``momentum`` as the weight of the NEW value, and compute the variance in
  two passes. Here the batch statistics are E[x] and E[x²] in float32
  over N, H, W, the variance ``max(E[x²] − E[x]², 0)`` (biased), the
  running stats ``m·old + (1 − m)·batch``, and the normalize runs in the
  input dtype: ``(x − mean)·(rsqrt(var + eps)·scale) + offset``. Over
  several data ranks (``mesh``) the two statistics are averaged over the
  data group (JAX's ``lax.pmean``) by a differentiable all-reduce whose
  backward averages the cotangents the same way (the transpose of
  ``pmean``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib


def truncated_normal_(t: torch.Tensor, stddev: float = 0.05,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
    """In-place truncated-normal (±2σ) init, TF-compatible (no rescaling)."""
    return torch.nn.init.trunc_normal_(t, mean=0.0, std=stddev,
                                       a=-2.0 * stddev, b=2.0 * stddev,
                                       generator=generator)


def he_normal_(t: torch.Tensor, generator: torch.Generator | None = None
               ) -> torch.Tensor:
    """In-place He/Kaiming fan-in normal init of a conv (HWIO) or dense
    (``[in, out]``) kernel in the JAX layout: ``N(0, 2 / fan_in)`` with
    ``fan_in = prod(shape[:-1])`` (the JAX package's ``he_normal_init``;
    the draws differ, tests load JAX's params)."""
    fan_in = math.prod(t.shape[:-1])
    with torch.no_grad():
        return t.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


def bn_init(width: int, dtype=torch.float32):
    """One BatchNorm layer's params, ``{"scale": 1, "offset": 0}`` (the
    JAX package's ``bn_init``); its running stats start at mean 0, var 1
    (``resnet.init_state`` there), always float32."""
    return {"scale": torch.ones(width, dtype=dtype),
            "offset": torch.zeros(width, dtype=dtype)}


def batch_norm_nchw(x: torch.Tensor, scale: torch.Tensor,
                    offset: torch.Tensor, mean: torch.Tensor,
                    var: torch.Tensor, train: bool, momentum: float = 0.9,
                    eps: float = 1e-5, mesh=None):
    """BatchNorm over NCHW (statistics over N, H, W). Returns ``(y,
    new_mean, new_var)``: in train the batch statistics normalize and the
    new running stats are ``momentum·old + (1 − momentum)·batch`` (no
    gradient); in eval the running stats normalize and come back as they
    are. ``mesh`` with several data ranks makes the batch statistics
    global (cross-replica BN). Nothing is written in place."""
    if train:
        xf = x.float()
        stats = torch.stack([xf.mean((0, 2, 3)), xf.square().mean((0, 2, 3))])
        if mesh is not None and mesh.data > 1:
            stats = mesh_lib.all_reduce_sum(stats, mesh, "data") / mesh.data
        m, m_sq = stats[0], stats[1]
        # E[x²]−E[x]² can go slightly negative from f32 cancellation.
        v = torch.clamp_min(m_sq - m.square(), 0.0)
        with torch.no_grad():
            new_mean = momentum * mean + (1.0 - momentum) * m.detach()
            new_var = momentum * var + (1.0 - momentum) * v.detach()
    else:
        m, v, new_mean, new_var = mean, var, mean, var
    inv = torch.rsqrt(v + eps) * scale.float()
    cdt = x.dtype
    y = (x - m.to(cdt)[:, None, None]) * inv.to(cdt)[:, None, None] \
        + offset.to(cdt)[:, None, None]
    return y, new_mean, new_var


def batch_norm(x: torch.Tensor, params, state, train: bool,
               momentum: float = 0.9, eps: float = 1e-5, mesh=None):
    """The JAX package's signature over NHWC: ``(y, new_state)`` with
    ``params`` ``{"scale", "offset"}`` and ``state`` ``{"mean", "var"}``
    (``new_state`` is ``state`` in eval)."""
    y, mean, var = batch_norm_nchw(
        x.permute(0, 3, 1, 2), params["scale"], params["offset"],
        state["mean"], state["var"], train, momentum, eps, mesh)
    return (y.permute(0, 2, 3, 1),
            {"mean": mean, "var": var} if train else state)


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


def conv2d(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """NHWC conv with an HWIO kernel → NHWC out (the JAX package's
    layout), TF "SAME" or "VALID" padding. VALID with ``stride`` equal to
    the kernel size is the ViT's patch embed."""
    x = x.permute(0, 3, 1, 2).contiguous()
    w = kernel.permute(3, 2, 0, 1).contiguous()
    if padding == "SAME":
        y = conv2d_nchw(x, w, stride=stride)
    elif padding == "VALID":
        y = F.conv2d(x, w, stride=stride)
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    return y.permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2
             ) -> torch.Tensor:
    """NHWC max pool, TF "SAME" padding."""
    y = max_pool_nchw(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ w + b`` with ``w`` in the JAX package's ``[in, out]`` layout,
    over any leading dims of ``x``; ``b`` None adds no bias (a
    row-parallel layer's partial product)."""
    x2 = x.reshape(-1, x.shape[-1])
    y = torch.mm(x2, w) if b is None else torch.addmm(b, x2, w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def pooled_hw(h: int, w: int, n_pools: int, stride: int = 2
              ) -> Tuple[int, int]:
    """Spatial dims after ``n_pools`` SAME-padded stride-2 pools."""
    for _ in range(n_pools):
        h = -(-h // stride)
        w = -(-w // stride)
    return h, w
