"""Fused single-pass SGD(+momentum, +weight-decay) update.

Port of ``dml_cnn_cifar10_tpu/ops/optimizer.py``. The whole update of a
leaf runs in ONE pass over its bytes:

- **CUDA kernels** (``csrc/sgd_update.cu``, built for ``sm_90a``):
  ``sgd_update_plain`` replaces the Pallas kernel ``_sgd_kernel_plain``
  (K1, the reference's plain SGD) and ``sgd_update_momentum`` replaces
  ``_sgd_kernel`` (K2). They update f32 leaves in place, read the LR from
  a device pointer, and round every operation on its own in the JAX
  expression's order (no FMA contraction). K1 takes every f32 leaf of a
  step in one launch (up to :data:`MAX_LEAVES` a launch); K2 one leaf a
  launch.
- **Plain version** (:func:`fused_sgd_update_plain`): the identical
  expression in PyTorch. The wrapper takes it for tensors on the CPU, and
  for non-f32 leaves on either device (as the JAX package's kernel takes
  only f32 leaves, ``ops/optimizer.py:173``). On the card it is only the
  reference that ``chip_smoke.py`` holds the kernels against.

On CUDA f32 leaves :func:`fused_sgd_update` launches its kernels or
raises; there is no fallback. Every launch adds one to
``LAUNCHES[kernel name]``: for plain SGD that is one a step.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Tuple

import torch

from dml_cnn_cifar10_tpu_torch.ops import _build

#: Kernel launches since the last :func:`reset_launches`, by kernel name.
LAUNCHES = {"sgd_update_plain": 0, "sgd_update_momentum": 0}
#: Leaves one K1 launch takes (``kMaxLeaves`` in ``csrc/sgd_update.cu``).
MAX_LEAVES = 64

_c_void_p, _c_int64, _c_float = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
_LIB: Optional[ctypes.CDLL] = None
# K1's leaf table, filled anew every step (the gradients are new tensors).
_P_PTRS = (_c_void_p * MAX_LEAVES)()
_G_PTRS = (_c_void_p * MAX_LEAVES)()
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


def _launch_plain(ps, gs, lr: torch.Tensor, weight_decay: float) -> None:
    """K1 over the f32 leaves ``ps`` on the card (with gradients ``gs``):
    one launch for every :data:`MAX_LEAVES` non-empty leaves, their
    pointers written into the preallocated table. Every leaf is checked
    before the first launch, by the cheap form of :func:`_check`, which
    then names what is wrong. This runs every step, so its host work is
    kept to a few attribute reads a leaf and one ctypes call a launch."""
    dev = ps[0].device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch_plain(ps, gs, lr, weight_decay)
    if not (lr.device == dev and lr.dtype == torch.float32
            and lr.numel() == 1):
        _check(ps[0], gs[0], None, lr)

    def ok(p, g):
        return (p.device == dev and g.device == dev and p.is_contiguous()
                and g.is_contiguous() and p.shape == g.shape)

    if len(ps) > MAX_LEAVES:   # more than one launch: check them all first
        for p, g in zip(ps, gs):
            if not ok(p, g):
                _check(p, g, None, lr)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    k, last = 0, len(ps) - 1
    for i, (p, g) in enumerate(zip(ps, gs)):
        if not ok(p, g):
            _check(p, g, None, lr)
        n = p.numel()
        if n:
            _P_PTRS[k] = p.data_ptr()
            _G_PTRS[k] = g.data_ptr()
            _SIZES[k] = n
            k += 1
        if k == MAX_LEAVES or (k and i == last):
            _raise_on(lib.sgd_update_plain(
                lr.data_ptr(), _P_PTRS, _G_PTRS, _SIZES, k, weight_decay,
                stream), "sgd_update_plain")
            LAUNCHES["sgd_update_plain"] += 1
            k = 0


def _launch_momentum(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                     lr: torch.Tensor, momentum: float,
                     weight_decay: float) -> None:
    """K2 over one leaf."""
    _check(p, g, m, lr)
    if p.numel() == 0:
        return
    with torch.cuda.device(p.device):
        rc = _lib().sgd_update_momentum(
            lr.data_ptr(), p.data_ptr(), g.data_ptr(), m.data_ptr(),
            p.numel(), momentum, weight_decay,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "sgd_update_momentum")
    LAUNCHES["sgd_update_momentum"] += 1


@torch.no_grad()
def fused_sgd_update(params: Mapping[str, torch.Tensor],
                     grads: Mapping[str, torch.Tensor],
                     momentum: Optional[Mapping[str, torch.Tensor]],
                     lr: torch.Tensor, mu: float, wd: float) -> None:
    """The whole SGD update, one pass per leaf, IN PLACE: ``params[k]``
    (and ``momentum[k]``) are overwritten with the new values, which
    keeps the parameters' identity and allocates nothing. ``momentum=None``
    is plain SGD: K1, one launch for all the CUDA f32 leaves; otherwise
    K2, one launch a leaf. ``lr`` is a 0-d float32 tensor on the params'
    device."""
    f32 = torch.float32
    ps, gs = [], []   # K1's leaves
    for name, p in params.items():
        g = grads[name]
        m = momentum[name] if momentum is not None else None
        if (p.is_cuda and p.dtype == f32 and g.dtype == f32
                and (m is None or m.dtype == f32)):
            if m is None:
                ps.append(p)
                gs.append(g)
            else:
                _launch_momentum(p, g, m, lr, mu, wd)
            continue
        # CPU tensors, or a non-f32 leaf on either device.
        new_p, new_m = fused_sgd_update_plain(p, g, m, lr, mu, wd)
        p.copy_(new_p)
        if m is not None:
            m.copy_(new_m)
    if ps:
        _launch_plain(ps, gs, lr, wd)
