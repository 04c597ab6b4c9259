"""Pipeline parallelism over the mesh's ``pipe`` ranks: 1F1B (the
default), 1F1B with a residual ring, and GPipe.

Port of ``dml_cnn_cifar10_tpu/parallel/pipeline.py``. The stacked layer
leaves' leading ``[depth]`` axis is cut over ``pipe`` (each stage holds
``depth / P`` contiguous blocks, ``parallel/tp.py:pipe_split``), and the
activations move stage to stage with neighbour transfers
(:meth:`Mesh.start_hop`, a ``batch_isend_irecv`` over NCCL or gloo) on a
static tick schedule. Where the JAX package runs one ``lax.scan`` over
ticks inside a ``shard_map`` with ``ppermute``, each rank here runs its
own stage's ticks eagerly in Python; every rank computes the same
schedule, so the two ends of every transfer ask for it on the same tick.
A transfer is made only where its value is read: the JAX package's
``ppermute`` also sends the last stage's output back to stage 0 (which
never reads it) and the bubbles' zeros.

Each rank's ``x`` is its data rank's batch (the same on every stage; only
stage 0 reads it), cut into ``M`` microbatches of contiguous rows (JAX's
``xl.reshape(m, bl // m, ...)``). The result is the last stage's output,
made the same on every stage by a broadcast from it (JAX's ``psum(where(
last, out, 0), "pipe")``), so the layers after the stack run, redundantly,
on every stage. The gradient of ``x`` is stage 0's, broadcast the same way
(JAX's ``psum(where(first, dx, 0), "pipe")``), so the layers before the
stack see the same gradient on every stage. The stage parameters'
gradients are this data rank's: the training step's all-reduce over the
``replica`` group (the ranks holding the same stage) sums them over the
data ranks, as it does every other leaf's; that is JAX's ``lax.psum(dpl,
"data")`` (``pipeline.py:310``), done once for all leaves.

Schedules (:data:`SCHEDULES`):

- ``"1f1b"`` (default): an autograd Function. Its forward runs the
  forward schedule with no graph kept: stage ``s`` runs microbatch ``t −
  s`` on tick ``t``, and skips the bubbles. It saves only ``x`` and the
  stage's parameters. Its backward runs the combined schedule of the
  virtual ``2P``-stage pipeline: on tick ``t`` stage ``s`` re-forwards
  microbatch ``t − s`` and stores the stage INPUT in a ring of ``2P``
  slots (slot ``t mod 2P``), and back-propagates microbatch ``t − (2P − 1
  − s)`` by replaying the stage under autograd from the input in slot
  ``(mbb + s) mod 2P``. Three forwards and one backward a microbatch, and
  at most ``2P`` stored inputs, whatever ``M``. The last stage's
  re-forward output goes nowhere (JAX sends it round the cyclic edge,
  unread), so it stores the input and does not compute the stage: two
  forwards and one backward there.
- ``"1f1b_ring"``: the same schedule, but the re-forward runs under
  autograd and its graph (input and output) is what the ring keeps, in
  the part of JAX's stored residuals; the backward tick applies it with
  no replay. Two forwards and one backward; ``2P`` live graphs, flat in
  ``M``.
- ``"gpipe"``: the stage runs on every one of the ``M + P − 1`` ticks
  (bubbles compute on zeros or on the clipped feed, as in the JAX
  package, and their results are never read), each tick's autograd graph
  kept; the backward walks the ticks in reverse through those graphs.
  ``M + P − 1`` live graphs.

All three are ordinary differentiable ops to the code around them, so a
step's gradient accumulation wraps them like any other layer, and each
stage's block may run under ``torch.utils.checkpoint`` (``--remat``).
:func:`sequential_blocks` is the plain version: the whole stack on one
process, which the tests hold the pipeline against.
"""

from __future__ import annotations

from typing import Callable, List, Mapping, Optional, Sequence

import torch

from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh

SCHEDULES = ("1f1b", "1f1b_ring", "gpipe")

StageFn = Callable[[torch.Tensor, Mapping[str, torch.Tensor]], torch.Tensor]


def microbatches(batch: int, mesh: Mesh,
                 num_microbatches: Optional[int] = None) -> int:
    """``M``, the microbatches a step's data-rank batch of ``batch`` rows
    is cut into (``P`` by default); raises ``ValueError`` with the JAX
    package's text when the global batch does not split over ``data *
    M``."""
    m = num_microbatches or mesh.pipe
    if batch % m:
        raise ValueError(
            f"global batch {batch * mesh.data} not divisible by data axis "
            f"* microbatches = {mesh.data}*{m}")
    return m


def sequential_blocks(x: torch.Tensor, stacked: Mapping[str, torch.Tensor],
                      block_fn: StageFn) -> torch.Tensor:
    """The plain version: ``block_fn`` over every row of the stacked
    leaves in order, on one process (JAX's sequential ``lax.scan``)."""
    depth = next(iter(stacked.values())).shape[0]
    for i in range(depth):
        x = block_fn(x, {n: t[i] for n, t in stacked.items()})
    return x


def pipeline_blocks(x: torch.Tensor, stage_params: Mapping[str,
                                                           torch.Tensor],
                    stage_fn: StageFn, mesh: Optional[Mesh],
                    num_microbatches: Optional[int] = None,
                    schedule: str = "1f1b") -> torch.Tensor:
    """Run this stage's blocks as one stage of the pipeline over ``pipe``.

    ``x``: this data rank's ``[b, ...]`` activations (the same on every
    stage). ``stage_params``: this stage's stacked leaves (its rows of
    every ``[depth, ...]`` leaf). ``stage_fn(h, stage_params)`` runs the
    stage's blocks on a microbatch ``h``. Returns the ``[b, ...]`` output
    of the whole stack, the same on every stage. Without pipe ranks it is
    ``stage_fn(x, stage_params)``."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}; "
                         f"have {SCHEDULES}")
    if mesh is None or mesh.pipe == 1:
        return stage_fn(x, stage_params)
    m = microbatches(x.shape[0], mesh, num_microbatches)
    names = list(stage_params)
    plan = _Plan(mesh, m, stage_fn, names, schedule)
    return _Pipeline.apply(x, plan, *[stage_params[n] for n in names])


class _Plan:
    """The static part of one pipelined call: the stage's place, the
    microbatch count, the stage function and the schedule."""

    def __init__(self, mesh: Mesh, m: int, stage_fn: StageFn,
                 names: Sequence[str], schedule: str):
        self.mesh, self.m, self.stage_fn = mesh, m, stage_fn
        self.names, self.schedule = list(names), schedule
        self.p, self.s = mesh.pipe, mesh.pipe_rank
        self.first, self.last = self.s == 0, self.s == self.p - 1

    def run(self, h: torch.Tensor, params: Sequence[torch.Tensor]
            ) -> torch.Tensor:
        return self.stage_fn(h, dict(zip(self.names, params)))

    def hop(self, to_next=None, to_prev=None, from_prev=None,
            from_next=None):
        """One tick's transfers (none asked: nothing is called)."""
        if to_next is None and to_prev is None and from_prev is None \
                and from_next is None:
            return None, None
        return self.mesh.start_hop("pipe", to_next, to_prev, from_prev,
                                   from_next).wait()

    def replicated(self, parts: Optional[List[torch.Tensor]],
                   like: torch.Tensor, src: int) -> torch.Tensor:
        """Stage ``src``'s ``cat(parts)`` on every stage (a broadcast over
        ``pipe``)."""
        out = torch.cat(parts) if self.s == src else torch.empty_like(like)
        return self.mesh.broadcast_(out.contiguous(), "pipe", src)


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, plan: _Plan, *params):
        ctx.plan = plan
        xs = x.split(x.shape[0] // plan.m)
        if plan.schedule == "gpipe":
            out, ctx.tape = _gpipe_forward(plan, x, xs, params, keep=any(
                ctx.needs_input_grad))
        else:
            out = _forward_schedule(plan, x, xs, params)
        ctx.save_for_backward(x, *params)
        return out

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        x, *params = ctx.saved_tensors
        gs = g.to(x.dtype).contiguous().split(x.shape[0] // plan.m)
        xs = x.split(x.shape[0] // plan.m)
        if plan.schedule == "gpipe":
            dxs, dparams = _gpipe_backward(plan, xs, gs, ctx.tape)
            ctx.tape = None
        else:
            dxs, dparams = _combined_schedule(
                plan, xs, gs, params, ring=plan.schedule == "1f1b_ring")
        dx = plan.replicated(dxs, x, 0)
        return (dx, None, *dparams)


def _forward_schedule(plan: _Plan, x, xs, params) -> torch.Tensor:
    """1F1B's forward: stage ``s`` runs microbatch ``t − s`` on tick ``t``
    (bubbles skipped), no graph kept; the last stage's outputs, on every
    stage."""
    p, s, m = plan.p, plan.s, plan.m
    outs: List[torch.Tensor] = [None] * m
    inflight = None
    for t in range(m + p - 1):
        mf = t - s
        h_out = None
        if 0 <= mf < m:
            h_in = xs[mf] if plan.first else inflight
            h_out = plan.run(h_in, params)
            if plan.last:
                outs[mf] = h_out
        recv = not plan.first and 0 <= t + 1 - s < m
        inflight, _ = plan.hop(
            to_next=None if plan.last else h_out,
            from_prev=xs[0] if recv else None)
    return plan.replicated(outs, x, p - 1)


def _add(acc, grads):
    return list(grads) if acc is None else [a + b for a, b in zip(acc, grads)]


def _combined_schedule(plan: _Plan, xs, gs, params, ring: bool):
    """1F1B's backward: the just-in-time re-forward and the backward on
    the virtual ``2P``-stage pipeline (module docstring). Returns ``(dx
    microbatches or None, stage parameter gradients)``."""
    p, s, m = plan.p, plan.s, plan.m
    nring = 2 * p
    slots: List = [None] * nring
    leaves = [t.detach().requires_grad_() for t in params]
    dparams = None
    dxs: List[torch.Tensor] = [None] * m
    f_in = b_in = None
    for t in range(m + 2 * p - 1):
        # Forward sub-tick: re-forward microbatch t - s.
        mf = t - s
        h_out = None
        if 0 <= mf < m:
            h_in = xs[mf] if plan.first else f_in
            if ring:
                with torch.enable_grad():
                    h = h_in.detach().requires_grad_()
                    o = plan.run(h, leaves)
                slots[t % nring] = (h, o)
                h_out = o.detach()
            else:
                # The slot is rewritten 2P ticks later; an input lives at
                # most 2P - 1 ticks, so its read always comes first.
                slots[t % nring] = h_in
                if not plan.last:
                    with torch.no_grad():
                        h_out = plan.run(h_in, leaves)
        # Backward sub-tick: microbatch t - (2P - 1 - s).
        mbb = t - (nring - 1 - s)
        dh = None
        if 0 <= mbb < m:
            g_in = gs[mbb] if plan.last else b_in
            slot = (mbb + s) % nring
            if ring:
                h, o = slots[slot]
            else:
                with torch.enable_grad():
                    h = slots[slot].detach().requires_grad_()
                    o = plan.run(h, leaves)
            slots[slot] = None
            dh, *dp = torch.autograd.grad(o, [h, *leaves], g_in)
            dparams = _add(dparams, dp)
            if plan.first:
                dxs[mbb] = dh
        recv_f = not plan.first and 0 <= t + 1 - s < m
        recv_b = not plan.last and 0 <= t + 1 - (nring - 1 - s) < m
        f_in, b_in = plan.hop(
            to_next=None if plan.last else h_out,
            to_prev=None if plan.first else dh,
            from_prev=xs[0] if recv_f else None,
            from_next=xs[0] if recv_b else None)
    return (dxs if plan.first else None), dparams


def _gpipe_forward(plan: _Plan, x, xs, params, keep: bool):
    """GPipe: the stage runs on all ``M + P − 1`` ticks (stage 0 on the
    feed clipped to the last microbatch, the others on what came in,
    zeros at tick 0), the last stage writing tick ``t``'s output at
    microbatch ``clip(t − (P − 1))``; with ``keep`` each tick's autograd
    graph is kept for the backward. Returns ``(output on every stage,
    tape)``."""
    p, m = plan.p, plan.m
    ticks = m + p - 1
    leaves = [t.detach().requires_grad_() for t in params] if keep \
        else list(params)
    outs: List[torch.Tensor] = [None] * m
    tape = []
    inflight = torch.zeros_like(xs[0])
    for t in range(ticks):
        h_in = xs[min(t, m - 1)] if plan.first else inflight
        if keep:
            with torch.enable_grad():
                h = h_in.detach().requires_grad_()
                o = plan.run(h, leaves)
            tape.append((h, o))
            h_out = o.detach()
        else:
            h_out = plan.run(h_in, leaves)
        if plan.last:
            outs[min(max(t - (p - 1), 0), m - 1)] = h_out
        more = t + 1 < ticks
        inflight, _ = plan.hop(
            to_next=h_out if more and not plan.last else None,
            from_prev=xs[0] if more and not plan.first else None)
    return plan.replicated(outs, x, p - 1), (tape, leaves)


def _gpipe_backward(plan: _Plan, xs, gs, tape):
    """GPipe's backward: the ticks in reverse through their kept graphs;
    a tick's output cotangent is the output gradient where the last stage
    wrote it last, plus what the next stage's input gradient sends back
    (zero for the bubbles' results, which nothing reads)."""
    p, m = plan.p, plan.m
    graphs, leaves = tape
    ticks = m + p - 1
    dparams = None
    dxs = [torch.zeros_like(xs[0]) for _ in range(m)] if plan.first \
        else None
    from_next = None
    for t in reversed(range(ticks)):
        h, o = graphs[t]
        cot = gs[t - (p - 1)] if plan.last and t >= p - 1 \
            else torch.zeros_like(o)
        if from_next is not None:
            cot = cot + from_next
        dh, *dp = torch.autograd.grad(o, [h, *leaves], cot)
        graphs[t] = None
        dparams = _add(dparams, dp)
        if plan.first:
            dxs[min(t, m - 1)] += dh
        _, from_next = plan.hop(
            to_prev=dh if t > 0 and not plan.first else None,
            from_next=xs[0] if t > 0 and not plan.last else None)
    return dxs, dparams
