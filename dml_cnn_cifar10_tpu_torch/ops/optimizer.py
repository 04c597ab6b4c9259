"""Fused single-pass SGD(+momentum, +weight-decay) update.

Port of ``dml_cnn_cifar10_tpu/ops/optimizer.py``. The whole update of a
leaf runs in ONE pass over its bytes:

- **CUDA kernels** (``csrc/sgd_update.cu``, built for ``sm_90a``):
  ``sgd_update_plain`` replaces the Pallas kernel ``_sgd_kernel_plain``
  (K1, the reference's plain SGD) and ``sgd_update_momentum`` replaces
  ``_sgd_kernel`` (K2). They update f32 leaves in place, read the LR from
  a device pointer, and round every operation on its own in the JAX
  expression's order (no FMA contraction). Both take every f32 leaf of a
  step in one launch (up to :data:`MAX_LEAVES` a launch), through one
  kernel body.
- **Plain version** (:func:`fused_sgd_update_plain`): the identical
  expression in PyTorch. The wrapper takes it for tensors on the CPU, and
  for non-f32 leaves on either device (as the JAX package's kernel takes
  only f32 leaves, ``ops/optimizer.py:173``). On the card it is only the
  reference that ``chip_smoke.py`` holds the kernels against.

On CUDA f32 leaves :func:`fused_sgd_update` launches its kernels or
raises; there is no fallback. Every launch adds one to
``LAUNCHES[kernel name]``: one a step for either kernel.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Tuple

import torch

from dml_cnn_cifar10_tpu_torch.ops import _build

#: Kernel launches since the last :func:`reset_launches`, by kernel name.
LAUNCHES = {"sgd_update_plain": 0, "sgd_update_momentum": 0}
#: Leaves one K1 or K2 launch takes (``kMaxLeaves`` in
#: ``csrc/sgd_update.cu``).
MAX_LEAVES = 64

_c_void_p, _c_int64, _c_float = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
_LIB: Optional[ctypes.CDLL] = None
# The kernels' leaf table, filled anew every step (the gradients are new
# tensors); _M_PTRS is K2's.
_P_PTRS = (_c_void_p * MAX_LEAVES)()
_G_PTRS = (_c_void_p * MAX_LEAVES)()
_M_PTRS = (_c_void_p * MAX_LEAVES)()
_SIZES = (_c_int64 * MAX_LEAVES)()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        lib = _build.load("sgd_update")
        lib.sgd_update_plain.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, ctypes.c_int,
            _c_float, _c_void_p]
        lib.sgd_update_plain.restype = ctypes.c_int
        lib.sgd_update_momentum.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
            ctypes.c_int, _c_float, _c_float, _c_void_p]
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


def _check(p: torch.Tensor, g: torch.Tensor, m: Optional[torch.Tensor],
           lr: torch.Tensor) -> None:
    """Raise unless the kernels can take this leaf: every tensor a
    contiguous float32 one on ``p``'s card, a one-element ``lr``, and
    matching shapes."""
    for t in (p, g, m, lr):
        if t is None:
            continue
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


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _launch_multi(ps, gs, ms, lr: torch.Tensor, momentum: float,
                  weight_decay: float) -> None:
    """The f32 leaves ``ps`` on the card (with gradients ``gs``) through
    K1, or through K2 with momentum buffers ``ms`` (None for K1): one
    launch for every :data:`MAX_LEAVES` non-empty leaves, their pointers
    written into the preallocated table. Every leaf is checked before the
    first launch, by the cheap form of :func:`_check`, which then names
    what is wrong. This runs every step, so its host work is kept to a
    few attribute reads a leaf and one ctypes call a launch."""
    dev = ps[0].device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch_multi(ps, gs, ms, lr, momentum, weight_decay)
    plain = ms is None
    name = "sgd_update_plain" if plain else "sgd_update_momentum"
    if plain:
        ms = (None,) * len(ps)
    if not (lr.device == dev and lr.dtype == torch.float32
            and lr.numel() == 1):
        _check(ps[0], gs[0], ms[0], lr)

    def ok(p, g, m):
        return (p.device == dev and g.device == dev and p.is_contiguous()
                and g.is_contiguous() and p.shape == g.shape
                and (m is None or (m.device == dev and m.is_contiguous()
                                   and m.shape == p.shape)))

    leaves = list(zip(ps, gs, ms))
    if len(leaves) > MAX_LEAVES:   # more than one launch: check them all
        for p, g, m in leaves:
            if not ok(p, g, m):
                _check(p, g, m, lr)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    k, last = 0, len(leaves) - 1
    for i, (p, g, m) in enumerate(leaves):
        if not ok(p, g, m):
            _check(p, g, m, lr)
        n = p.numel()
        if n:
            _P_PTRS[k] = p.data_ptr()
            _G_PTRS[k] = g.data_ptr()
            if not plain:
                _M_PTRS[k] = m.data_ptr()
            _SIZES[k] = n
            k += 1
        if k == MAX_LEAVES or (k and i == last):
            if plain:
                rc = lib.sgd_update_plain(lr.data_ptr(), _P_PTRS, _G_PTRS,
                                          _SIZES, k, weight_decay, stream)
            else:
                rc = lib.sgd_update_momentum(
                    lr.data_ptr(), _P_PTRS, _G_PTRS, _M_PTRS, _SIZES, k,
                    momentum, weight_decay, stream)
            _raise_on(rc, name)
            LAUNCHES[name] += 1
            k = 0


@torch.no_grad()
def fused_sgd_update(params: Mapping[str, torch.Tensor],
                     grads: Mapping[str, torch.Tensor],
                     momentum: Optional[Mapping[str, torch.Tensor]],
                     lr: torch.Tensor, mu: float, wd: float) -> None:
    """The whole SGD update, one pass per leaf, IN PLACE: ``params[k]``
    (and ``momentum[k]``) are overwritten with the new values, which
    keeps the parameters' identity and allocates nothing. The CUDA f32
    leaves go through one launch a step: K1 for plain SGD
    (``momentum=None``), K2 otherwise. ``lr`` is a 0-d float32 tensor on
    the params' device."""
    f32 = torch.float32
    ps, gs, ms = [], [], []   # the kernel's leaves
    for name, p in params.items():
        g = grads[name]
        m = momentum[name] if momentum is not None else None
        if (p.is_cuda and p.dtype == f32 and g.dtype == f32
                and (m is None or m.dtype == f32)):
            ps.append(p)
            gs.append(g)
            ms.append(m)
            continue
        # CPU tensors, or a non-f32 leaf on either device.
        new_p, new_m = fused_sgd_update_plain(p, g, m, lr, mu, wd)
        p.copy_(new_p)
        if m is not None:
            m.copy_(new_m)
    if ps:
        _launch_multi(ps, gs, None if momentum is None else ms, lr, mu, wd)
