"""The process mesh and the collectives the training step needs.

Port of ``dml_cnn_cifar10_tpu/parallel/mesh.py`` onto ``torch.distributed``.
The JAX mesh is ``(data, model, seq, pipe)`` devices in one SPMD program;
the port's is ``data x seq`` processes, one per GPU, in the same rank
order: ``reshape(data, model, seq, pipe)`` puts ``seq`` fastest, so
``rank = data_rank * seq + seq_rank``.

- ``data``: the batch is split over the data ranks, and the gradients are
  summed over the world (the all-reduce that stands in for ``psum``).
- ``seq``: a ViT's tokens are split over the seq ranks of one data row,
  whose K/V shards walk the ring (``parallel/ring_attention.py``) or are
  re-partitioned from tokens to heads by an all-to-all
  (``parallel/ulysses.py``).

Every rank holds one process group per data row (its ring, ``"seq"``) and
per seq column (its metric average, ``"data"``) — ``new_group`` is called
by every rank for every group, in one order. The collectives here take
one of those names or ``"world"``.

On the ``gloo`` backend a CUDA tensor goes through host memory explicitly
(gloo's send/recv and all-to-all take no CUDA tensors); that is how
several ranks share one card, which NCCL refuses. On ``nccl`` the
collectives run on the cards.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from dml_cnn_cifar10_tpu_torch.config import ParallelConfig

GROUPS = ("world", "data", "seq")


@dataclasses.dataclass
class Mesh:
    """This process's place in the ``data x seq`` world."""

    world: int = 1
    rank: int = 0
    data: int = 1
    seq: int = 1
    data_rank: int = 0
    seq_rank: int = 0
    backend: Optional[str] = None
    # "data" / "seq" -> this rank's process group (None in a 1-rank world)
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def chief(self) -> bool:
        return self.rank == 0

    def size(self, over: str) -> int:
        return {"world": self.world, "data": self.data, "seq": self.seq}[over]

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def all_reduce_(self, t: torch.Tensor, over: str) -> torch.Tensor:
        """Sum ``t`` in place over the ``over`` group; returns ``t``."""
        if over not in GROUPS:
            raise ValueError(f"unknown group {over!r}; have {GROUPS}")
        if self.size(over) == 1:
            return t
        group = None if over == "world" else self.groups[over]
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=group)
        return t

    def all_to_all(self, t: torch.Tensor, over: str, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """``lax.all_to_all(t, over, split_axis, concat_axis, tiled=True)``:
        ``t`` is cut into ``n`` equal chunks along ``split_axis``, chunk
        ``j`` goes to the group's rank ``j``, and the chunks received are
        concatenated along ``concat_axis`` in rank order. Returns a new
        contiguous tensor on ``t``'s device; not differentiable
        (:func:`all_to_all` is)."""
        n = self.size(over)
        if n == 1:
            return t
        shape = list(t.shape)
        if shape[split_axis] % n:
            raise ValueError(f"dim {split_axis} of size {shape[split_axis]} "
                             f"does not split over {n} ranks")
        # [..., n, size/n, ...] with the chunk index first: all_to_all_single
        # sends slice j of dim 0 to rank j.
        shape[split_axis:split_axis + 1] = [n, shape[split_axis] // n]
        x = t.reshape(shape).movedim(split_axis, 0).contiguous()
        group = None if over == "world" else self.groups[over]
        if self._staged(x):
            host = x.cpu()
            recv = torch.empty_like(host)
            dist.all_to_all_single(recv, host, group=group)
            recv = recv.to(t.device)
        else:
            recv = torch.empty_like(x)
            dist.all_to_all_single(recv, x, group=group)
        # recv[i] is rank i's chunk: put the rank index just before the
        # concat dim and merge the two, rank-major.
        rest = list(recv.shape[1:])
        rest[concat_axis] *= n
        return recv.movedim(0, concat_axis).reshape(rest).contiguous()

    def all_gather(self, t: torch.Tensor, over: str, dim: int
                   ) -> torch.Tensor:
        """The group's ``t`` concatenated along ``dim`` in rank order
        (``lax.all_gather(..., tiled=True)``); not differentiable."""
        n = self.size(over)
        if n == 1:
            return t
        group = None if over == "world" else self.groups[over]
        src = t.detach().cpu() if self._staged(t) else t.detach()
        src = src.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(t.device)

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()

    def start_ring_hop(self, tensors: Sequence[torch.Tensor]) -> "RingHop":
        """Send each tensor to the next seq rank of this data row and
        receive the previous one's, without waiting: the transfer runs
        while the caller computes. Every seq rank must call it with the
        same shapes in the same order."""
        return RingHop(self, tensors)


class RingHop:
    """One ring step in flight; :meth:`wait` returns the received
    tensors (fresh buffers on the senders' device)."""

    def __init__(self, mesh: Mesh, tensors: Sequence[torch.Tensor]):
        base = mesh.data_rank * mesh.seq
        nxt = base + (mesh.seq_rank + 1) % mesh.seq
        prev = base + (mesh.seq_rank - 1) % mesh.seq
        self._devices = [t.device for t in tensors]
        # Buffers on the wire must be contiguous (q/k/v are strided views
        # of the fused qkv) and, on gloo, on the host.
        sends = [t.detach().cpu() if mesh._staged(t) else t.detach()
                 for t in tensors]
        sends = [t.contiguous() for t in sends]
        self._recvs = [torch.empty_like(t) for t in sends]
        # One tag per tensor, so gloo matches each send with its receive.
        ops = [dist.P2POp(dist.isend, t, nxt, tag=i)
               for i, t in enumerate(sends)]
        ops += [dist.P2POp(dist.irecv, t, prev, tag=i)
                for i, t in enumerate(self._recvs)]
        self._sends = sends          # referenced until the sends complete
        self._reqs = dist.batch_isend_irecv(ops)

    def wait(self) -> List[torch.Tensor]:
        for req in self._reqs:
            req.wait()
        self._sends = None
        return [t.to(dev) for t, dev in zip(self._recvs, self._devices)]


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group forward; the gradient is summed the same way
    backward (every rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, t, mesh: Mesh, over: str):
        ctx.mesh, ctx.over = mesh, over
        return mesh.all_reduce_(t.clone(), over)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.contiguous().clone(),
                                    ctx.over), None, None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, over: str) -> torch.Tensor:
    """Differentiable sum of ``t`` over the ``over`` group."""
    if mesh.size(over) == 1:
        return t
    return _AllReduceSum.apply(t, mesh, over)


class _AllToAll(torch.autograd.Function):
    """All-to-all forward; the reverse all-to-all (concat and split axes
    swapped) backward, its transpose."""

    @staticmethod
    def forward(ctx, t, mesh: Mesh, over: str, split_axis: int,
                concat_axis: int):
        ctx.config = (mesh, over, split_axis, concat_axis)
        return mesh.all_to_all(t, over, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        mesh, over, split_axis, concat_axis = ctx.config
        return (mesh.all_to_all(grad, over, concat_axis, split_axis),
                None, None, None, None)


def all_to_all(t: torch.Tensor, mesh: Mesh, over: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Differentiable :meth:`Mesh.all_to_all`."""
    if mesh.size(over) == 1:
        return t
    return _AllToAll.apply(t, mesh, over, split_axis, concat_axis)


def build_mesh(cfg: Optional[ParallelConfig] = None) -> Mesh:
    """This process's :class:`Mesh` in the initialized process group (a
    one-rank mesh when there is none). Raises when the world does not
    split into ``seq_axis``-wide rows."""
    cfg = cfg or ParallelConfig()
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    else:
        world, rank, backend = 1, 0, None
    seq = max(1, cfg.seq_axis)
    if world % seq:
        raise ValueError(f"a world of {world} rank(s) does not split into "
                         f"seq_axis={seq} rows")
    data = world // seq
    mesh = Mesh(world=world, rank=rank, data=data, seq=seq,
                data_rank=rank // seq, seq_rank=rank % seq, backend=backend)
    if world > 1:
        for d in range(data):
            g = dist.new_group([d * seq + s for s in range(seq)])
            if d == mesh.data_rank:
                mesh.groups["seq"] = g
        for s in range(seq):
            g = dist.new_group([d * seq + s for d in range(data)])
            if s == mesh.seq_rank:
                mesh.groups["data"] = g
        mesh.barrier()
    return mesh
