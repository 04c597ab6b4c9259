"""Fused single-pass SGD(+momentum, +weight-decay) update.

Port of ``dml_cnn_cifar10_tpu/ops/optimizer.py``. The whole update of a
leaf runs in ONE pass over its bytes:

- **CUDA kernels** (``csrc/sgd_update.cu``, built for ``sm_90a``):
  ``sgd_update_plain`` replaces the Pallas kernel ``_sgd_kernel_plain``
  (K1, the reference's plain SGD) and ``sgd_update_momentum`` replaces
  ``_sgd_kernel`` (K2). Each launch updates one f32 leaf in place, reads
  the LR from a device pointer, and rounds every operation on its own in
  the JAX expression's order (no FMA contraction).
- **Plain version** (:func:`fused_sgd_update_plain`): the identical
  expression in PyTorch. The wrapper takes it for tensors on the CPU, and
  for non-f32 leaves on either device (as the JAX package's kernel takes
  only f32 leaves, ``ops/optimizer.py:173``). On the card it is only the
  reference that ``chip_smoke.py`` holds the kernels against.

On a CUDA f32 leaf :func:`fused_sgd_update` launches its kernel or raises;
there is no fallback. Every launch adds one to ``LAUNCHES[kernel name]``.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Tuple

import torch

from dml_cnn_cifar10_tpu_torch.ops import _build

#: Kernel launches since the last :func:`reset_launches`, by kernel name.
LAUNCHES = {"sgd_update_plain": 0, "sgd_update_momentum": 0}

_c_void_p, _c_int64, _c_float = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        lib = _build.load("sgd_update")
        lib.sgd_update_plain.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_int64, _c_float, _c_void_p]
        lib.sgd_update_plain.restype = ctypes.c_int
        lib.sgd_update_momentum.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int64, _c_float,
            _c_float, _c_void_p]
        lib.sgd_update_momentum.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def fused_sgd_update_plain(p: torch.Tensor, g: torch.Tensor,
                           m: Optional[torch.Tensor], lr, momentum: float,
                           weight_decay: float
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One leaf, plain form: ``(new_p, new_m)`` — the expression (and
    order) of the JAX package's ``_xla_leaf`` and of the kernels."""
    if weight_decay:
        g = g + weight_decay * p
    if m is not None:
        m = momentum * m + g
        g = m
    return p - lr * g.to(p.dtype), m


def _launch(p: torch.Tensor, g: torch.Tensor, m: Optional[torch.Tensor],
            lr: torch.Tensor, momentum: float, weight_decay: float) -> None:
    tensors = [t for t in (p, g, m, lr) if t is not None]
    for t in tensors:
        if not t.is_cuda or t.device != p.device:
            raise ValueError(
                f"fused_sgd_update: every tensor must be on {p.device} "
                f"(got {t.device})")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "fused_sgd_update: the CUDA kernel takes contiguous float32 "
                f"tensors (got {t.dtype}, contiguous={t.is_contiguous()})")
    if lr.numel() != 1:
        raise ValueError(f"lr must hold one value, got shape {tuple(lr.shape)}")
    if p.shape != g.shape or (m is not None and m.shape != p.shape):
        raise ValueError("param, grad and momentum shapes differ")
    if p.numel() == 0:
        return
    lib = _lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        if m is None:
            rc = lib.sgd_update_plain(lr.data_ptr(), p.data_ptr(),
                                      g.data_ptr(), p.numel(), weight_decay,
                                      stream)
            name = "sgd_update_plain"
        else:
            rc = lib.sgd_update_momentum(lr.data_ptr(), p.data_ptr(),
                                         g.data_ptr(), m.data_ptr(),
                                         p.numel(), momentum, weight_decay,
                                         stream)
            name = "sgd_update_momentum"
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


@torch.no_grad()
def fused_sgd_update(params: Mapping[str, torch.Tensor],
                     grads: Mapping[str, torch.Tensor],
                     momentum: Optional[Mapping[str, torch.Tensor]],
                     lr: torch.Tensor, mu: float, wd: float) -> None:
    """The whole SGD update, one pass per leaf, IN PLACE: ``params[k]``
    (and ``momentum[k]``) are overwritten with the new values, which
    keeps the parameters' identity and allocates nothing. ``momentum=None``
    is plain SGD (K1); otherwise K2. ``lr`` is a 0-d float32 tensor on the
    params' device."""
    for name, p in params.items():
        g = grads[name]
        m = momentum[name] if momentum is not None else None
        if p.is_cuda and all(t.dtype == torch.float32
                             for t in (p, g, m) if t is not None):
            _launch(p, g, m, lr, mu, wd)
            continue
        # CPU tensors, or a non-f32 leaf on either device.
        new_p, new_m = fused_sgd_update_plain(p, g, m, lr, mu, wd)
        p.copy_(new_p)
        if m is not None:
            m.copy_(new_m)
