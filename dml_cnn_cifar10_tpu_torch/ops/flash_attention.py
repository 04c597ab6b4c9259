"""Blocked online-softmax attention: the hand-written CUDA kernels, forward
AND backward.

Port of ``dml_cnn_cifar10_tpu/ops/flash_attention.py``. The S×S score
matrix never reaches device memory in either direction:

- forward: :func:`flash_attention_fwd_lse` (kernel K4) emits the output and
  the row logsumexp ``lse = m + log l``; the output-only forward (K3) runs
  when no gradient is wanted; :func:`flash_attention_stats` (K5) emits the
  raw partial-softmax state ``(acc, m, l)`` that ring attention merges
  across K/V shards (``parallel/ring_attention.py``);
- backward (the FlashAttention-2 recompute form):
  :func:`flash_attention_bwd` rebuilds each score block from Q/K and the
  saved ``lse`` and uses ``D = rowsum(dO ∘ O)`` (:func:`attention_delta`)
  for the softmax Jacobian — K6 accumulates dQ, K7 dK and dV.

:func:`flash_attention` is a ``torch.autograd.Function`` wiring them
together: with grad mode on and an input that requires grad it launches K4
and saves ``(q, k, v, out, lse)``; otherwise it calls the registered
operator ``dml_torch::flash_attention_out`` (:func:`flash_attention_out`),
whose CUDA kernel is K3 and whose CPU kernel the plain version, so that
``torch.export`` keeps it as one node and an exported program launches K3
on the card (``export.py``); its backward computes ``delta`` in plain torch
and launches K6 and K7.

- **CUDA kernels** (``csrc/flash_attention.cu``, built for ``sm_90a``):
  ``flash_out_kernel`` (K3) replaces the Pallas ``_flash_kernel``,
  ``flash_lse_kernel`` (K4) ``_flash_fwd_kernel``, ``flash_stats_kernel``
  (K5) ``_flash_stats_kernel``, ``flash_dq_kernel`` (K6)
  ``_flash_bwd_dq_kernel`` and ``flash_dkv_kernel`` (K7)
  ``_flash_bwd_dkv_kernel``. They read ``[B, S, H, D]`` tensors through
  their B/S/H strides (the head dim must be contiguous), take f32 or bf16
  with head dim 32, 64 or 128, and write lse as ``[B, S, H]`` f32. Every
  flash attention FLOP is matrix products, which the card runs 15× faster
  on its tensor cores (bf16, 989 TFLOP/s) than as f32 FMAs (67). So every
  kernel runs every product as ``mma.sync`` bf16 → f32, with the softmax
  on the accumulators in registers, and splits an f32 operand into three
  bf16 terms to keep the f32 pins; K3, K4 and K5 are one forward body that
  differs only in what it stores. They copy their tiles with 16-byte
  ``cp.async`` copies: their wrappers hand them tensors whose base and
  B/S/H strides are 16-byte multiples, copying one that is not.
- **Plain versions** (:func:`flash_attention_plain`,
  :func:`flash_attention_stats_plain`, :func:`flash_attention_bwd_plain`): dense masked f32 softmax and its
  dense FA-2 backward, with the same dead-row rule. The wrappers take them
  only for tensors on the CPU; on the card they are only the reference
  that ``chip_smoke.py`` holds the kernels against.

On a CUDA tensor every public function launches its kernel or raises (a
dtype, head dim or layout the kernels do not take); there is no fallback.
Every launch adds one to ``LAUNCHES[name]``.

Masking is the JAX package's ``_score_mask``: padding, ``causal``
(col ≤ row), ``window`` (band ``|row − col| < window``; with causal only
the lower half), ``segment_ids`` (a ``[B, S]`` tensor or a ``(q_seg,
kv_seg)`` pair; same-segment pairs only) and ``kv_start`` (the global
column of key 0, seen by the causal/window comparisons only). Masked
scores are ``NEG_INF = -1e30``. A row with no live key outputs exactly 0
and publishes ``lse = 1e30``, so the backward's ``p`` is exactly 0 there;
its K5 state is ``m = -1e30``, ``l = 0``, ``acc = 0`` exactly (the Pallas
stats kernel leaves ``l``/``acc`` undefined on such rows, so a comparison
with it looks at ``m`` only).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dml_cnn_cifar10_tpu_torch.ops import _build

NEG_INF = -1e30   # not -inf: exp(-inf - -inf) would NaN a fully-masked row
DEAD_LSE = 1e30   # lse of a row with no live key
HEAD_DIMS = (32, 64, 128)   # head dims the kernels are built for

#: Kernel launches since the last :func:`reset_launches`, by kernel:
#: ``flash_fwd`` K3, ``flash_fwd_lse`` K4, ``flash_fwd_stats`` K5,
#: ``flash_bwd_dq`` K6, ``flash_bwd_dkv`` K7.
LAUNCHES = {"flash_fwd": 0, "flash_fwd_lse": 0, "flash_fwd_stats": 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        shape = [i, i, i, i, i, p, f, i, i, i, p]   # B H Sq Skv D strides
        #                                             scale causal window
        #                                             kv_start stream
        lib.flash_fwd_out.argtypes = [p, p, p, p, p, p, i] + shape
        lib.flash_fwd_lse.argtypes = [p, p, p, p, p, p, p, i] + shape
        lib.flash_fwd_stats.argtypes = [p] * 8 + [i] + shape
        lib.flash_bwd_dq.argtypes = [p] * 9 + [i, i] + shape
        lib.flash_bwd_dkv.argtypes = [p] * 10 + [i, i, i] + shape
        for fn in (lib.flash_fwd_out, lib.flash_fwd_lse, lib.flash_fwd_stats,
                   lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _resolve(q: torch.Tensor, scale: Optional[float],
             window: Optional[int]) -> float:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


def _norm_segments(segment_ids):
    """``None`` | ``[B, S]`` | ``(q_seg, kv_seg)`` → ``(q_seg, kv_seg)``
    int32 or ``(None, None)``."""
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, (tuple, list)):
        q_seg, kv_seg = segment_ids
        return q_seg.to(torch.int32), kv_seg.to(torch.int32)
    seg = segment_ids.to(torch.int32)
    return seg, seg


# ---------------------------------------------------------------------------
# Plain versions (dense, f32): the CPU path and the card's reference.
# ---------------------------------------------------------------------------


def _live(sq: int, skv: int, device, causal: bool, window: Optional[int],
          kv_start: int, q_seg, kv_seg) -> torch.Tensor:
    """Validity mask ``[B or 1, 1, Sq, Skv]`` of ``_score_mask``."""
    row = torch.arange(sq, device=device)[:, None]
    col = kv_start + torch.arange(skv, device=device)[None, :]
    live = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        live &= col <= row
    if window is not None:
        live &= col > row - window
        if not causal:
            live &= col < row + window
    live = live[None, None]
    if q_seg is not None:
        live = live & (q_seg[:, :, None] == kv_seg[:, None, :])[:, None]
    return live


def _dense_partial(q, k, v, scale, causal, window, kv_start, q_seg,
                   kv_seg):
    """Dense masked f32 partial softmax: ``(acc [B,H,Sq,D] unnormalized,
    m, l [B,H,Sq,1], dead [B,H,Sq,1])``; masked scores get ``p = 0``
    outright, so a dead row keeps ``l = 0`` and ``acc = 0``."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    live = _live(q.shape[1], k.shape[1], q.device, causal, window, kv_start,
                 q_seg, kv_seg)
    s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    acc = torch.einsum("bhqk,bkhd->bhqd", p, vf)
    return acc, m, p.sum(dim=-1, keepdim=True), m <= NEG_INF * 0.5


def flash_attention_plain(q, k, v, scale=None, causal: bool = False,
                          segment_ids=None, window: Optional[int] = None,
                          kv_start: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B,Sq,H,D] in q's dtype, lse [B,Sq,H] f32)`` by a dense
    masked softmax in f32, with the kernels' dead-row rule."""
    scale = _resolve(q, scale, window)
    acc, m, l, dead = _dense_partial(q, k, v, scale, causal, window,
                                     kv_start, *_norm_segments(segment_ids))
    l = l.clamp_min(1e-30)
    out = torch.where(dead, 0.0, acc / l).permute(0, 2, 1, 3)
    lse = torch.where(dead, DEAD_LSE, m + torch.log(l))[..., 0]
    return out.to(q.dtype).contiguous(), lse.permute(0, 2, 1).contiguous()


def flash_attention_stats_plain(q, k, v, scale=None, causal: bool = False,
                                segment_ids=None,
                                window: Optional[int] = None,
                                kv_start: int = 0):
    """``(acc [B,Sq,H,D], m [B,Sq,H], l [B,Sq,H])``, all f32, by a dense
    masked softmax: K5's partial state, dead rows at ``m = -1e30``,
    ``l = 0``, ``acc = 0``."""
    scale = _resolve(q, scale, window)
    acc, m, l, dead = _dense_partial(q, k, v, scale, causal, window,
                                     kv_start, *_norm_segments(segment_ids))
    acc = torch.where(dead, 0.0, acc).permute(0, 2, 1, 3).contiguous()
    m = torch.where(dead, NEG_INF, m)[..., 0].permute(0, 2, 1).contiguous()
    l = torch.where(dead, 0.0, l)[..., 0].permute(0, 2, 1).contiguous()
    return acc, m, l


def flash_attention_bwd_plain(q, k, v, do, lse, delta, scale=None,
                              causal: bool = False, out_dtype=None,
                              segment_ids=None,
                              window: Optional[int] = None,
                              kv_start: int = 0):
    """``(dq, dk, dv)`` by the dense FA-2 recompute:
    ``p = exp(s − lse)``, ``dS = p ∘ (dO·Vᵀ − delta)·scale``."""
    scale = _resolve(q, scale, window)
    q_seg, kv_seg = _norm_segments(segment_ids)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    live = _live(q.shape[1], k.shape[1], q.device, causal, window, kv_start,
                 q_seg, kv_seg)
    lse_t = lse.float().permute(0, 2, 1)[..., None]        # [B,H,Sq,1]
    delta_t = delta.float().permute(0, 2, 1)[..., None]
    p = torch.where(live, torch.exp(torch.where(live, s, NEG_INF) - lse_t),
                    0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta_t) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return tuple(g.to(t.dtype if out_dtype is None else out_dtype)
                 .contiguous() for g, t in ((dq, q), (dk, k), (dv, v)))


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``D = rowsum(dO ∘ O)`` [B, S, H] f32 — the softmax-Jacobian row
    term. Plain torch, as the JAX package left it to XLA."""
    return torch.sum(do.float() * o.float(), dim=-1)


# ---------------------------------------------------------------------------
# Kernel launches.
# ---------------------------------------------------------------------------


def _check(tensors, shapes, what: str) -> None:
    """Every tensor on the first one's card, f32/bf16 of one dtype, of the
    given shape, with a contiguous head dim the kernels were built for."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if dt not in _DTYPES:
        raise ValueError(f"{what}: the CUDA kernels take float32 or "
                         f"bfloat16, got {dt}")
    for t, shape in zip(tensors, shapes):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: every tensor must be on {dev} "
                             f"(got {t.device})")
        if t.dtype != dt:
            raise ValueError(f"{what}: mixed dtypes {dt} and {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: shape {tuple(t.shape)}, want "
                             f"{tuple(shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: the kernels read the head dim "
                             "contiguously (stride 1); got strides "
                             f"{t.stride()}")
    d = tensors[0].shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} is not one the kernels are "
                         f"built for {HEAD_DIMS}")


def _seg_args(q_seg, kv_seg, q, k):
    if q_seg is None:
        return None, None, 0, 0
    b = q.shape[0]
    for seg, n in ((q_seg, q.shape[1]), (kv_seg, k.shape[1])):
        if tuple(seg.shape) != (b, n) or seg.device != q.device:
            raise ValueError(f"segment ids must be [{b}, {n}] on "
                             f"{q.device}, got {tuple(seg.shape)} on "
                             f"{seg.device}")
    q_seg, kv_seg = q_seg.contiguous(), kv_seg.contiguous()
    return q_seg, kv_seg, q_seg.data_ptr(), kv_seg.data_ptr()


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_int64 * len(vals))(*vals)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


# mode -> (C function, LAUNCHES key, per-row f32 outputs besides ``out``)
_FWD = {"out": ("flash_fwd_out", "flash_fwd", 0),
        "lse": ("flash_fwd_lse", "flash_fwd_lse", 1),
        "stats": ("flash_fwd_stats", "flash_fwd_stats", 2)}


def _fwd_launch(q, k, v, scale, causal, window, kv_start, q_seg, kv_seg,
                mode: str):
    """K3 (``out``), K4 (``lse``: out, lse) or K5 (``stats``: f32 acc, m,
    l). Returns the tuple of outputs."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    _check([q, k, v], [q.shape, (b, skv, h, d), (b, skv, h, d)],
           "flash_attention")
    q, k, v = (_aligned16(t) for t in (q, k, v))   # 16-byte cp.async
    fn_name, name, n_rows = _FWD[mode]
    out = torch.empty((b, sq, h, d), device=q.device,
                      dtype=torch.float32 if mode == "stats" else q.dtype)
    rows = [torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
            for _ in range(n_rows)]
    if out.numel() == 0:
        if mode == "lse":
            rows[0].fill_(DEAD_LSE)
        elif mode == "stats":
            rows[0].fill_(NEG_INF)
            rows[1].zero_()
        return (out, *rows)
    q_seg, kv_seg, qs, ks = _seg_args(q_seg, kv_seg, q, k)
    fn = getattr(_lib(), fn_name)
    shape = (_DTYPES[q.dtype], b, h, sq, skv, d, _strides(q, k, v), scale,
             int(causal), int(window or 0), int(kv_start))
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qs, ks,
                out.data_ptr(), *(t.data_ptr() for t in rows), *shape,
                torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return (out, *rows)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels' 16-byte ``cp.async`` copies can read
    its rows: a base pointer and B/S/H strides that are multiples of 16
    bytes (the ViT's q/k/v views of one fused qkv are). Otherwise a
    contiguous copy of it, made here once per launch, which always is."""
    size = t.element_size()
    if t.data_ptr() % 16 == 0 and all(s * size % 16 == 0
                                      for s in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _bwd_prepare(q, k, v, do, lse, delta, out_dtype, q_seg, kv_seg):
    """Check the backward's inputs; returns the kernels' common arguments,
    the tensors they point into, the three gradient dtypes and the
    q/k/v/dO strides."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    _check([q, k, v, do], [q.shape, (b, skv, h, d), (b, skv, h, d), q.shape],
           "flash_attention_bwd")
    q, k, v, do = (_aligned16(t) for t in (q, k, v, do))
    dts = [t.dtype if out_dtype is None else out_dtype for t in (q, k, v)]
    for dt in dts:
        if dt not in _DTYPES:
            raise ValueError(f"flash_attention_bwd: gradient dtype {dt}; "
                             "the kernels write float32 or bfloat16")
    # lse/delta are per-row f32 stats, as the JAX wrapper casts them.
    lse = lse.to(device=q.device, dtype=torch.float32).contiguous()
    delta = delta.to(device=q.device, dtype=torch.float32).contiguous()
    for stat in (lse, delta):
        if tuple(stat.shape) != (b, sq, h):
            raise ValueError(f"lse/delta must be [{b}, {sq}, {h}], got "
                             f"{tuple(stat.shape)}")
    q_seg, kv_seg, qs, ks = _seg_args(q_seg, kv_seg, q, k)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), qs, ks)
    # Every tensor behind ``ins`` stays referenced until the launches.
    return (ins, (q, k, v, do, lse, delta, q_seg, kv_seg), dts,
            _strides(q, k, v, do))


def _dq_launch(q, k, v, do, lse, delta, scale, causal, out_dtype, window,
               kv_start, q_seg, kv_seg) -> torch.Tensor:
    """K6: dQ."""
    b, sq, h, d = q.shape
    ins, keep, dts, strides = _bwd_prepare(q, k, v, do, lse, delta,
                                           out_dtype, q_seg, kv_seg)
    dq = torch.empty((b, sq, h, d), dtype=dts[0], device=q.device)
    if dq.numel() == 0 or k.shape[1] == 0:
        return dq.zero_()
    shape = (b, h, sq, k.shape[1], d, strides, scale, int(causal),
             int(window or 0), int(kv_start))
    with torch.cuda.device(q.device):
        rc = _lib().flash_bwd_dq(*ins, dq.data_ptr(), _DTYPES[q.dtype],
                                 _DTYPES[dts[0]], *shape,
                                 torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _dkv_launch(q, k, v, do, lse, delta, scale, causal, out_dtype, window,
                kv_start, q_seg, kv_seg) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: dK and dV."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    ins, keep, dts, strides = _bwd_prepare(q, k, v, do, lse, delta,
                                           out_dtype, q_seg, kv_seg)
    dk = torch.empty((b, skv, h, d), dtype=dts[1], device=q.device)
    dv = torch.empty((b, skv, h, d), dtype=dts[2], device=q.device)
    if dk.numel() == 0 or sq == 0:
        return dk.zero_(), dv.zero_()
    shape = (b, h, sq, skv, d, strides, scale, int(causal),
             int(window or 0), int(kv_start))
    with torch.cuda.device(q.device):
        rc = _lib().flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(),
                                  _DTYPES[q.dtype], _DTYPES[dts[1]],
                                  _DTYPES[dts[2]], *shape,
                                  torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def _forward_lse(q, k, v, scale, causal, window, kv_start, q_seg, kv_seg):
    """Dispatch by device: K4 for CUDA tensors, the plain version for CPU
    tensors. Returns ``(out, lse)``."""
    if not q.is_cuda:
        seg = None if q_seg is None else (q_seg, kv_seg)
        return flash_attention_plain(q, k, v, scale, causal, seg, window,
                                     kv_start)
    return _fwd_launch(q, k, v, scale, causal, window, kv_start, q_seg,
                       kv_seg, "lse")


def _backward(q, k, v, do, lse, delta, scale, causal, out_dtype, window,
              kv_start, q_seg, kv_seg):
    if not q.is_cuda:
        seg = None if q_seg is None else (q_seg, kv_seg)
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, scale,
                                         causal, out_dtype, seg, window,
                                         kv_start)
    args = (q, k, v, do, lse, delta, scale, causal, out_dtype, window,
            kv_start, q_seg, kv_seg)
    return (_dq_launch(*args), *_dkv_launch(*args))


# K3 as a registered operator: an exported program (``export.py``) keeps
# it as one opaque node and launches the kernel wherever it runs, where a
# trace of a device dispatch in Python would take one branch at trace time.
@torch.library.custom_op("dml_torch::flash_attention_out", mutates_args=())
def flash_attention_out(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_seg: Optional[torch.Tensor],
                        kv_seg: Optional[torch.Tensor], scale: float,
                        causal: bool, window: Optional[int]) -> torch.Tensor:
    """The output-only forward ``[B, Sq, H, D]`` in q's dtype: the plain
    version here (CPU tensors), K3 on a CUDA tensor (below)."""
    seg = None if q_seg is None else (q_seg, kv_seg)
    return flash_attention_plain(q, k, v, scale, causal, seg, window)[0]


@flash_attention_out.register_kernel("cuda")
def _flash_attention_out_cuda(q, k, v, q_seg, kv_seg, scale, causal,
                              window):
    return _fwd_launch(q, k, v, scale, causal, window, 0, q_seg, kv_seg,
                       "out")[0]


@flash_attention_out.register_fake
def _flash_attention_out_fake(q, k, v, q_seg, kv_seg, scale, causal,
                              window):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


class _Flash(torch.autograd.Function):
    """K4 forward saving ``(q, k, v, out, lse)``; K6 + K7 backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, scale, causal, window):
        out, lse = _forward_lse(q, k, v, scale, causal, window, 0, q_seg,
                                kv_seg)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.segments = (q_seg, kv_seg)
        ctx.config = (scale, causal, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, window = ctx.config
        q_seg, kv_seg = ctx.segments
        do = do.contiguous()
        delta = attention_delta(out, do)
        dq, dk, dv = _backward(q, k, v, do, lse, delta, scale, causal, None,
                               window, 0, q_seg, kv_seg)
        return dq, dk, dv, None, None, None, None, None


# ---------------------------------------------------------------------------
# Public API (the JAX package's names and arguments, minus the TPU-only
# ``interpret``, ``block_q`` and ``block_k``).
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, causal: bool = False,
                    segment_ids=None,
                    window: Optional[int] = None) -> torch.Tensor:
    """FlashAttention over ``[B, S, H, D]`` tensors → ``[B, Sq, H, D]`` in
    q's dtype; differentiable (K4 forward + K6/K7 backward) when grad mode
    is on and an input requires grad, else the output-only K3."""
    scale = _resolve(q, scale, window)
    q_seg, kv_seg = _norm_segments(segment_ids)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, q_seg, kv_seg, scale, causal, window)
    return flash_attention_out(q, k, v, q_seg, kv_seg, scale, causal, window)


@torch.no_grad()
def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: Optional[float] = None,
                            causal: bool = False, segment_ids=None,
                            window: Optional[int] = None,
                            kv_start: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward with residual: ``(out [B,Sq,H,D], lse [B,Sq,H] f32)`` (K4),
    for callers that keep their own residuals for
    :func:`flash_attention_bwd`."""
    scale = _resolve(q, scale, window)
    q_seg, kv_seg = _norm_segments(segment_ids)
    return _forward_lse(q, k, v, scale, causal, window, int(kv_start),
                        q_seg, kv_seg)


@torch.no_grad()
def flash_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          causal: bool = False, segment_ids=None,
                          window: Optional[int] = None, kv_start: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """FlashAttention's raw partial-softmax state (K5): ``(acc [B,Sq,H,D]
    f32 UNNORMALIZED, m [B,Sq,H] f32 row max, l [B,Sq,H] f32
    normalizer)``; the output is ``acc / l``. Partials over different K/V
    shards merge with the flash rule in f32 — the ring-attention
    interface. A row with no live key gives ``m = -1e30``, ``l = 0``,
    ``acc = 0``."""
    scale = _resolve(q, scale, window)
    q_seg, kv_seg = _norm_segments(segment_ids)
    if not q.is_cuda:
        seg = None if q_seg is None else (q_seg, kv_seg)
        return flash_attention_stats_plain(q, k, v, scale, causal, seg,
                                           window, int(kv_start))
    return _fwd_launch(q, k, v, scale, causal, window, int(kv_start), q_seg,
                       kv_seg, "stats")


@torch.no_grad()
def flash_attention_bwd(q, k, v, do, lse, delta,
                        scale: Optional[float] = None, causal: bool = False,
                        out_dtype=None, segment_ids=None,
                        window: Optional[int] = None, kv_start: int = 0):
    """The flash backward as a standalone op: ``(dq, dk, dv)`` from saved
    forward state (K6 then K7). ``lse``/``delta`` are ``[B, Sq, H]`` f32;
    ``out_dtype`` overrides the gradients' dtype (default: each input's)."""
    scale = _resolve(q, scale, window)
    q_seg, kv_seg = _norm_segments(segment_ids)
    return _backward(q, k, v, do, lse, delta, scale, causal, out_dtype,
                     window, int(kv_start), q_seg, kv_seg)
