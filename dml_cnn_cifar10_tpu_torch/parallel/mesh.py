"""The process mesh and the collectives the training step needs.

Port of ``dml_cnn_cifar10_tpu/parallel/mesh.py`` onto ``torch.distributed``.
The JAX mesh is ``(data, model, seq, pipe)`` devices in one SPMD program;
the port's is ``data x model x seq x pipe`` processes, one per GPU, in the
same rank order: ``reshape(data, model, seq, pipe)`` puts ``pipe``
fastest, so ``rank = ((data_rank * model + model_rank) * seq + seq_rank)
* pipe + pipe_rank``. At ``pipe`` 1 that is the ``data x model x seq``
order the port had before the pipe axis, rank for rank and group for
group.

- ``data``: the batch is split over the data ranks, and the gradients are
  summed over the ``replica`` group (the all-reduce that stands in for
  ``psum``): every rank that holds the same weights (the same model slice
  and the same pipeline stage), which is the world when ``model`` and
  ``pipe`` are 1.
- ``model``: tensor parallelism. The Megatron-paired layers of a model
  hold a 1/M slice of their weights on each model rank of a data row;
  :func:`copy_to_model` and :func:`reduce_from_model` are the pair's two
  collectives.
- ``seq``: a ViT's tokens are split over the seq ranks of one data row,
  whose K/V shards walk the ring (``parallel/ring_attention.py``) or are
  re-partitioned from tokens to heads by an all-to-all
  (``parallel/ulysses.py``); the CNN's image rows are split over them
  (``parallel/spatial.py``), with halo rows from the neighbours.
- ``pipe``: pipeline parallelism. A ViT's blocks are cut into ``pipe``
  stages of ``depth / pipe`` blocks (``parallel/pipeline.py``); the
  activations move between neighbouring stages (:meth:`Mesh.start_hop`).

Every rank holds one process group per ``(data, model, pipe)`` row (its
ring, ``"seq"``), per ``(model, seq, pipe)`` column (its metric average
and its ZeRO shards, ``"data"``), and, when ``model`` > 1, per ``(data,
seq, pipe)`` pair (``"model"``), when ``pipe`` > 1 per ``(data, model,
seq)`` cell (its stages, ``"pipe"``), and, when either is > 1, per
``(model, pipe)`` pair (the ranks holding the same weights,
``"replica"``) — ``new_group`` is called by every rank for every group,
in one order. The collectives here take one of those names or
``"world"``. A collective on a ``meta`` tensor (a step traced for its
FLOPs, ``utils/profiling.py``) returns it unchanged and calls nothing.

On the ``gloo`` backend a CUDA tensor goes through host memory explicitly
(gloo's send/recv and all-to-all take no CUDA tensors); that is how
several ranks share one card, which NCCL refuses. On ``nccl`` the
collectives run on the cards. The ZeRO layouts (``parallel/zero.py``)
add :meth:`Mesh.reduce_scatter_` and :meth:`Mesh.all_gather_` over
``data``: ``reduce_scatter_tensor`` and ``all_gather_into_tensor`` on
NCCL, names torch has had since 2.0; gloo does the same through host
memory with an all-reduce and an ``all_gather`` of a tensor list, which
every torch version's gloo takes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from dml_cnn_cifar10_tpu_torch.config import ParallelConfig

GROUPS = ("world", "data", "model", "seq", "pipe", "replica")


@dataclasses.dataclass
class Mesh:
    """This process's place in the ``data x model x seq x pipe`` world."""

    world: int = 1
    rank: int = 0
    data: int = 1
    seq: int = 1
    data_rank: int = 0
    seq_rank: int = 0
    backend: Optional[str] = None
    # group name -> this rank's process group (None: the whole world)
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    model: int = 1
    model_rank: int = 0
    pipe: int = 1
    pipe_rank: int = 0

    @property
    def chief(self) -> bool:
        return self.rank == 0

    @property
    def replicas(self) -> int:
        """Ranks holding the same weights (the same model slice and the
        same pipeline stage): the gradient sum's size."""
        return self.world // (self.model * self.pipe)

    def size(self, over: str) -> int:
        return {"world": self.world, "data": self.data, "seq": self.seq,
                "model": self.model, "pipe": self.pipe,
                "replica": self.replicas}[over]

    def stride(self, over: str) -> int:
        """How far apart in rank two neighbours on the axis ``over`` are
        (the rank order puts ``pipe`` fastest)."""
        return {"pipe": 1, "seq": self.pipe, "model": self.seq * self.pipe,
                "data": self.model * self.seq * self.pipe}[over]

    def _group(self, over: str):
        if over not in GROUPS:
            raise ValueError(f"unknown group {over!r}; have {GROUPS}")
        return None if over == "world" else self.groups[over]

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def all_reduce_(self, t: torch.Tensor, over: str) -> torch.Tensor:
        """Sum ``t`` in place over the ``over`` group; returns ``t``."""
        if self.size(over) == 1 or t.is_meta:
            return t
        group = self._group(over)
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=group)
        return t

    def broadcast_(self, t: torch.Tensor, over: str, src: int = 0
                   ) -> torch.Tensor:
        """Overwrite ``t`` in place with the copy of the ``over`` group's
        rank ``src``; returns ``t``."""
        if self.size(over) == 1 or t.is_meta:
            return t
        group = self._group(over)
        src = src if group is None else dist.get_global_rank(group, src)
        if self._staged(t):
            host = t.cpu()
            dist.broadcast(host, src, group=group)
            t.copy_(host)
        else:
            dist.broadcast(t, src, group=group)
        return t

    def _group_rank(self, over: str) -> int:
        return {"world": self.rank, "data": self.data_rank,
                "seq": self.seq_rank, "model": self.model_rank,
                "pipe": self.pipe_rank}[over]

    def reduce_scatter_(self, out: torch.Tensor, t: torch.Tensor,
                        over: str) -> torch.Tensor:
        """``out`` (``[S]``) = this rank's row of ``t`` (``[n * S]``, rank
        major) summed over the ``over`` group; returns ``out``. On NCCL one
        ``reduce_scatter_tensor`` (capturable in a CUDA graph); on gloo an
        all-reduce of ``t`` on the host, of which the rank keeps its row."""
        n = self.size(over)
        if n == 1:
            return out.copy_(t)
        group = self._group(over)
        if self.backend == "gloo":
            host = t.detach().cpu() if t.is_cuda else t.detach().clone()
            dist.all_reduce(host, group=group)
            return out.copy_(host.view(n, -1)[self._group_rank(over)])
        dist.reduce_scatter_tensor(out, t, group=group)
        return out

    def all_gather_(self, out: torch.Tensor, t: torch.Tensor,
                    over: str) -> torch.Tensor:
        """``out`` (``[n * S]``) = the group's ``t`` (``[S]``) concatenated
        in rank order; returns ``out``. On NCCL one
        ``all_gather_into_tensor`` (capturable in a CUDA graph); on gloo
        through host memory."""
        n = self.size(over)
        if n == 1:
            return out.copy_(t)
        group = self._group(over)
        if self.backend == "gloo":
            src = t.detach().cpu().contiguous()
            host = torch.empty((n,) + tuple(src.shape), dtype=src.dtype)
            dist.all_gather(list(host.unbind(0)), src, group=group)
            return out.copy_(host.view(-1))
        dist.all_gather_into_tensor(out, t, group=group)
        return out

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
        group = self._group(over)
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
        if t.is_meta:
            shape = list(t.shape)
            shape[dim] *= n
            return t.new_empty(shape)
        group = self._group(over)
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

    def start_hop(self, over: str,
                  to_next: Optional[torch.Tensor] = None,
                  to_prev: Optional[torch.Tensor] = None,
                  from_prev: Optional[torch.Tensor] = None,
                  from_next: Optional[torch.Tensor] = None) -> "Hop":
        """Neighbour transfers on the axis ``over``, without a wrap: send
        ``to_next`` to the next rank of the axis and ``to_prev`` to the
        previous one, and receive into buffers shaped like ``from_prev``
        and ``from_next`` (their values are not read), each where given.
        The pipeline's stages and the spatial split's halo rows move so
        (JAX's ``ppermute`` to the neighbour; its cyclic edge, which no
        one reads, is not sent). Both ends of each transfer must ask for
        it, with the same shape, in the same call."""
        return Hop(self, over, to_next, to_prev, from_prev, from_next)


class Hop:
    """The transfers of one :meth:`Mesh.start_hop` in flight;
    :meth:`wait` returns ``(from_prev, from_next)``, each a fresh tensor
    on its template's device, or None where none was asked for. One
    ``batch_isend_irecv`` with one tag per direction, so gloo matches
    each send with its receive; on gloo a CUDA tensor goes through host
    memory."""

    _TAG_FORWARD, _TAG_BACKWARD = 0, 1

    def __init__(self, mesh: Mesh, over: str, to_next, to_prev, from_prev,
                 from_next):
        stride, pos, n = mesh.stride(over), mesh._group_rank(over), \
            mesh.size(over)
        if (to_next is not None or from_next is not None) and pos == n - 1:
            raise ValueError(f"the last rank of {over!r} has no next rank")
        if (to_prev is not None or from_prev is not None) and pos == 0:
            raise ValueError(f"the first rank of {over!r} has no previous "
                             f"rank")
        nxt, prev = mesh.rank + stride, mesh.rank - stride
        self._devices, self._recvs, self._sends, ops = [], [], [], []
        for t, peer, tag in ((to_next, nxt, self._TAG_FORWARD),
                             (to_prev, prev, self._TAG_BACKWARD)):
            if t is not None:
                t = t.detach().cpu() if mesh._staged(t) else t.detach()
                t = t.contiguous()
                self._sends.append(t)     # referenced until the send ends
                ops.append(dist.P2POp(dist.isend, t, peer, tag=tag))
        # A receive from prev carries what prev sent to its next (the
        # forward tag), one from next what next sent to its prev.
        for like, peer, tag in ((from_prev, prev, self._TAG_FORWARD),
                                (from_next, nxt, self._TAG_BACKWARD)):
            if like is None:
                self._recvs.append(None)
                self._devices.append(None)
                continue
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if mesh._staged(like)
                              else like.device)
            self._recvs.append(buf)
            self._devices.append(like.device)
            ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
        self._reqs = dist.batch_isend_irecv(ops) if ops else []

    def wait(self) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        for req in self._reqs:
            req.wait()
        self._sends = None
        out = [None if t is None else t.to(dev)
               for t, dev in zip(self._recvs, self._devices)]
        return out[0], out[1]


class RingHop:
    """One ring step in flight; :meth:`wait` returns the received
    tensors (fresh buffers on the senders' device)."""

    def __init__(self, mesh: Mesh, tensors: Sequence[torch.Tensor]):
        stride = mesh.stride("seq")
        base = mesh.rank - mesh.seq_rank * stride
        nxt = base + (mesh.seq_rank + 1) % mesh.seq * stride
        prev = base + (mesh.seq_rank - 1) % mesh.seq * stride
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


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward; the gradient summed over the
    model ranks backward (each rank's column slice contributes a part of
    the input's gradient)."""

    @staticmethod
    def forward(ctx, t, mesh: Mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.contiguous().clone(),
                                    "model"), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: the partial products summed over the model ranks
    forward; identity backward (every rank's part feeds the same sum)."""

    @staticmethod
    def forward(ctx, t, mesh: Mesh):
        return mesh.all_reduce_(t.contiguous().clone(), "model")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The input of a column-parallel layer: identity forward, gradient
    summed over ``"model"`` backward."""
    if mesh is None or mesh.model == 1:
        return t
    return _CopyToModel.apply(t, mesh)


def reduce_from_model(t: torch.Tensor, mesh: Optional[Mesh]
                      ) -> torch.Tensor:
    """The output of a row-parallel layer: summed over ``"model"``
    forward, identity backward."""
    if mesh is None or mesh.model == 1:
        return t
    return _ReduceFromModel.apply(t, mesh)


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
    factor as ``data x model_axis x seq_axis x pipe_axis``, with the JAX
    package's message."""
    cfg = cfg or ParallelConfig()
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    else:
        world, rank, backend = 1, 0, None
    seq = max(1, cfg.seq_axis)
    model = max(1, cfg.model_axis)
    pipe = max(1, cfg.pipe_axis)
    data = world // (model * seq * pipe)
    if data * model * seq * pipe != world:
        raise ValueError(
            f"mesh {data}x{model}x{seq}x{pipe} != {world} devices "
            f"(data_axis=-1, model_axis={model}, seq_axis={seq}, "
            f"pipe_axis={pipe}): a world of {world} rank(s) does not split "
            f"into seq_axis={seq} rows of model_axis={model} x "
            f"pipe_axis={pipe} (data x model x seq x pipe)")
    mesh = Mesh(world=world, rank=rank, data=data, seq=seq,
                data_rank=rank // (model * seq * pipe),
                seq_rank=rank // pipe % seq, backend=backend, model=model,
                model_rank=rank // (seq * pipe) % model, pipe=pipe,
                pipe_rank=rank % pipe)

    def at(d, m, s, p):
        return ((d * model + m) * seq + s) * pipe + p

    if world > 1:
        mine = (mesh.data_rank, mesh.model_rank, mesh.seq_rank,
                mesh.pipe_rank)
        cells = [(d, m, s, p) for d in range(data) for m in range(model)
                 for s in range(seq) for p in range(pipe)]

        def groups(name, key):
            # One group for each value of ``key`` (the coordinates the
            # group's ranks share), in the order of ``cells``.
            seen = {}
            for c in cells:
                seen.setdefault(key(c), []).append(at(*c))
            for k, ranks in seen.items():
                g = dist.new_group(ranks)
                if k == key(mine):
                    mesh.groups[name] = g

        groups("seq", lambda c: (c[0], c[1], c[3]))
        groups("data", lambda c: (c[1], c[2], c[3]))
        if model > 1:
            groups("model", lambda c: (c[0], c[2], c[3]))
        if model > 1 or pipe > 1:
            groups("replica", lambda c: (c[1], c[3]))
        else:
            mesh.groups["replica"] = None
        if pipe > 1:
            groups("pipe", lambda c: (c[0], c[1], c[2]))
        mesh.barrier()
    return mesh
