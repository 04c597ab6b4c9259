"""Ring attention — sequence parallelism over the mesh's ``seq`` ranks.

Port of ``dml_cnn_cifar10_tpu/parallel/ring_attention.py``. Q, K and V are
split on the sequence over the seq ranks of one data row. Each rank keeps
its Q shard and walks the ring: it computes blockwise attention of its Q
against the K/V shard it holds, folds the result into the running
FlashAttention state ``(m, l, acc)``, and passes the K/V shard to the next
rank (``Mesh.start_ring_hop``, in flight while the block computes). After
``seq`` steps every Q shard has attended to the whole sequence while
holding 1/seq of K/V.

Each step's partial comes from K5 (``flash_attention_stats``, the
unnormalized f32 ``acc`` with ``m`` and ``l``) once the local shard has
128 tokens, the flash kernels' cut (``ring_attention.py:387``); shorter
shards take the dense plain version. Partials merge in f32 whatever the
input dtype.

**The backward is a second ring**, not autograd through the forward: the
forward saves only ``(q, k, v, out, lse)`` — ``lse`` the GLOBAL row
logsumexp from the merge, dead rows at 1e30 — and the backward rotates
``(k, v, dk, dv)``. With the global ``lse`` each step rebuilds its block's
exact probabilities and runs the FlashAttention-2 block backward
(``flash_attention_bwd`` with ``out_dtype=float32`` and ``kv_start``: K6
and K7; the dense plain version below 128 local tokens). The dK/dV
partials travel with the visiting shard and arrive home after the last hop.

Causality: shards are equal and aligned, so a (Q shard i, K/V shard j)
step is fully below the diagonal (full attention), on it (j == i, the local
causal mask) or fully above (skipped: no FLOPs, but the rank still takes
part in the hop). A window ``W <= S_local`` reaches only the adjacent
shards, at ``kv_start = -S_local`` (left) or ``+S_local`` (right).

Every seq rank issues its hops in the same order: the step schedule
depends on the ring position only through which block math runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh

NEG_INF = fa.NEG_INF
DEAD_LSE = fa.DEAD_LSE
FLASH_MIN_TOKENS = 128   # local shards from this length run K5/K6/K7


def _merge(a1, m1, l1, a2, m2, l2):
    """Fold two online-softmax partials ``(acc, m, l)`` (K5's order) into
    one (the flash merge rule)."""
    m = torch.maximum(m1, m2)
    w1 = torch.exp(m1 - m)
    w2 = torch.exp(m2 - m)
    return a1 * w1[..., None] + a2 * w2[..., None], m, l1 * w1 + l2 * w2


def _zero_partials(b, sq, h, d, device):
    return (torch.zeros((b, sq, h, d), device=device),
            torch.full((b, sq, h), NEG_INF, device=device),
            torch.zeros((b, sq, h), device=device))


def _causal_switch(src, my, full, diag, skip):
    """The causal ring-step dispatch: a held shard from home ``src`` <
    ``my`` lies fully below the diagonal (full attention), == ``my`` is
    the diagonal block (local causal mask), > ``my`` fully above
    (skipped)."""
    if src < my:
        return full()
    return diag() if src == my else skip()


def _window_switch(src, my, causal, diag, left, right, skip):
    """The sliding-window dispatch for ``W <= S_local``: the diagonal
    block, the left neighbour (``kv_start = -S_local``), the right one
    (bidirectional windows only, ``+S_local``), or out of band
    (skipped). Shards do not wrap around the sequence's ends."""
    delta = my - src
    if delta == 0:
        return diag()
    if delta == 1:
        return left()
    if delta == -1 and not causal:
        return right()
    return skip()


def _step(src, my, sq, causal, window, block):
    """Run ``block(causal_local, kv_start)`` for the held shard from home
    ``src``, or return None for a skipped step."""
    if window is not None:
        return _window_switch(
            src, my, causal, lambda: block(causal, 0),
            lambda: block(False, -sq), lambda: block(False, sq),
            lambda: None)
    if causal:
        return _causal_switch(src, my, lambda: block(False, 0),
                              lambda: block(True, 0), lambda: None)
    return block(False, 0)


def _ring_fwd(q, k, v, seg, mesh: Mesh, scale, causal, window):
    """The forward ring → ``(out [B,Sq,H,D] in q's dtype, lse [B,Sq,H]
    f32)``; a row with no live key on any step gets 0 and lse 1e30."""
    n, my = mesh.seq, mesh.seq_rank
    b, sq, h, d = q.shape
    stats = (fa.flash_attention_stats if sq >= FLASH_MIN_TOKENS
             else fa.flash_attention_stats_plain)
    acc, m, l = _zero_partials(b, sq, h, d, q.device)
    # Segment ids are sharded like Q; a visiting K/V shard brings its own.
    held = [k, v] if seg is None else [k, v, seg]
    for t in range(n):
        src = (my - t) % n               # home of the held shard
        hop = mesh.start_ring_hop(held) if t < n - 1 else None
        pair = None if seg is None else (seg, held[2])
        part = _step(src, my, sq, causal, window,
                     lambda c, ks: stats(q, held[0], held[1], scale,
                                         causal=c, segment_ids=pair,
                                         window=window, kv_start=ks))
        if part is not None:
            acc, m, l = _merge(acc, m, l, *part)
        if hop is not None:
            held = hop.wait()
    live = m > NEG_INF * 0.5
    l = l.clamp_min(1e-30)
    out = torch.where(live[..., None], acc / l[..., None], 0.0).to(q.dtype)
    lse = torch.where(live, m + torch.log(l), DEAD_LSE)
    return out, lse


def _ring_bwd(q, k, v, seg, out, lse, do, mesh: Mesh, scale, causal,
              window):
    """The backward ring → ``(dq, dk, dv)`` in the inputs' dtypes; every
    step's partial is f32 and accumulates in f32."""
    n, my = mesh.seq, mesh.seq_rank
    sq = q.shape[1]
    do = do.contiguous()
    delta = fa.attention_delta(out, do)
    bwd = (fa.flash_attention_bwd if sq >= FLASH_MIN_TOKENS
           else fa.flash_attention_bwd_plain)
    dq = torch.zeros(q.shape, device=q.device)
    dk = torch.zeros(k.shape, device=q.device)
    dv = torch.zeros(v.shape, device=q.device)
    held = [k, v] if seg is None else [k, v, seg]
    for t in range(n):
        src = (my - t) % n
        pair = None if seg is None else (seg, held[2])
        part = _step(src, my, sq, causal, window,
                     lambda c, ks: bwd(q, held[0], held[1], do, lse, delta,
                                       scale=scale, causal=c,
                                       out_dtype=torch.float32,
                                       segment_ids=pair, window=window,
                                       kv_start=ks))
        if part is not None:
            dq += part[0]
            dk += part[1]
            dv += part[2]
        # dK/dV travel with the shard they belong to; the last hop brings
        # them home (K/V need not travel again).
        if t < n - 1:
            *held, dk, dv = mesh.start_ring_hop([*held, dk, dv]).wait()
        else:
            dk, dv = mesh.start_ring_hop([dk, dv]).wait()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Ring(torch.autograd.Function):
    """Forward ring saving ``(q, k, v, out, lse)``; backward ring."""

    @staticmethod
    def forward(ctx, q, k, v, seg, mesh, scale, causal, window):
        out, lse = _ring_fwd(q, k, v, seg, mesh, scale, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.seg = seg
        ctx.config = (mesh, scale, causal, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, ctx.seg, out, lse, do, *ctx.config)
        return dq, dk, dv, None, None, None, None, None


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mesh: Mesh, scale: Optional[float] = None,
                         causal: bool = False,
                         segment_ids: Optional[torch.Tensor] = None,
                         window: Optional[int] = None) -> torch.Tensor:
    """Per-rank body: this rank's ``[B, S_local, H, D]`` shards of Q, K and
    V → its shard of the output. Differentiable (the backward is the
    second ring) when grad mode is on and an input requires grad.
    ``segment_ids`` is this shard's ``[B, S_local]`` slice; ``window``
    is in global coordinates and must not exceed ``S_local``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if window is not None and window > q.shape[1]:
        raise ValueError(
            f"ring window {window} exceeds the local shard length "
            f"{q.shape[1]}; the ring dispatch only visits adjacent "
            f"shards. Use fewer seq ranks (longer shards) or a smaller "
            f"window.")
    seg = None if segment_ids is None else segment_ids.to(torch.int32)
    args = (q, k, v, seg, mesh, float(scale), bool(causal),
            None if window is None else int(window))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Ring.apply(*args)
    return _ring_fwd(*args)[0]


def seq_shard(x: torch.Tensor, mesh: Mesh, what: str = "sequence length"
              ) -> torch.Tensor:
    """This seq rank's slice of ``x`` along dim 1 (the layout rule every
    SP path shares: batch over ``data``, sequence over ``seq``). Raises on
    a length the seq ranks cannot split."""
    s = x.shape[1]
    if s % mesh.seq:
        raise ValueError(f"{what} {s} not divisible by seq axis {mesh.seq}")
    n = s // mesh.seq
    return x.narrow(1, mesh.seq_rank * n, n)

