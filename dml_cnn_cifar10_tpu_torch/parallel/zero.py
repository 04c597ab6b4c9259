"""Sharded training state over the ``data`` group: ZeRO-1 and FSDP.

Port of the JAX package's state layouts (``parallel/shardings.py``
``state_pspecs`` and ``parallel/step.py:_zero1_update`` /
``_fsdp_gather_wrap``, arxiv 2004.13336), stated as explicit collectives:

- **zero1** (``--optimizer_sharding zero1``): the optimizer moments
  (``momentum``, ``mu``, ``nu``) and the EMA live 1/N per data rank; the
  parameters stay whole. A step reduce-scatters the gradients, updates
  this rank's shard, and all-gathers the new parameters.
- **fsdp** (``--fsdp``): the parameters too are stored 1/N per rank and
  all-gathered before the forward; the gradients are reduce-scattered and
  the update runs on the shards.

Which dim of a leaf is split comes from the rule engine
(``parallel/shardings.py``) on the leaf's JAX-layout shape, mapped into
the port's layout (``convert.port_dim``): the largest free dim ``|data|``
divides. A leaf with none stays whole on every rank (its gradient is
all-reduced and every rank applies its update), as the CNN's ``full1``
bias does (the rule table's ``model`` claims its only dim).

Each rank keeps its shards of one state entry in ONE contiguous flat
buffer, ``[S]`` elements, one contiguous view a leaf (the leaf's shape
with the split dim cut to ``1/N``): K1/K2 take contiguous leaves only, and
a dim-1 slice of a ``[out, in]`` kernel is not contiguous. The collectives
move whole flat buffers: the reduce-scatter takes ``[N, S]`` (row ``j``
every leaf's ``j``-th slice of the gradient, rank-major) and gives this
rank's row summed; the all-gather gives ``[N, S]`` back, which is
unpacked into whole leaves (one strided copy a leaf each way). One
reduce-scatter and one all-reduce (the whole leaves) a step, and one
all-gather (zero1 after the update, fsdp before the forward).

Under tensor parallelism (``parallel/tp.py``) the layout works inside
each model column: the model's parameters are already this model rank's
slices, so the offsets and split dims come from those local shapes, the
split dim is a free one (the rule's ``model`` dim is claimed), and the
``data`` group is the data ranks that hold the same slices. The norms
over shards (``tp.sq_sums``) sum over ``data`` and ``model``.

Scope: the ``data`` axis of a ``data`` or ``data x model`` mesh. Sharding
over ``seq`` (a ``data x seq`` mesh sums the gradients over ``seq`` too),
fsdp with ``async_staleness`` (its forward reads a snapshot that would be
sharded) and Adafactor (its factored statistics need the whole leaf)
raise ``NotImplementedError`` naming ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from dml_cnn_cifar10_tpu_torch import convert
from dml_cnn_cifar10_tpu_torch.config import OptimConfig, ParallelConfig
from dml_cnn_cifar10_tpu_torch.parallel import shardings
from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh

_ROADMAP = "ROADMAP.md Queue 1, the open sharding items"


def check_modes(optim_cfg: OptimConfig, par_cfg: ParallelConfig
                ) -> Optional[str]:
    """The configured layout (``"zero1"``, ``"fsdp"`` or None), after the
    JAX package's guards on invalid compositions."""
    mode = getattr(optim_cfg, "optimizer_sharding", "none")
    if mode not in ("none", "zero1"):
        raise ValueError(
            f"optimizer_sharding={mode!r} must be one of none | zero1")
    if mode == "zero1" and par_cfg.fsdp:
        raise ValueError(
            "optimizer_sharding=zero1 does not compose with --fsdp: "
            "ZeRO-3 already shards the optimizer moments (and the "
            "params) over the data axis")
    if mode == "zero1" and optim_cfg.async_staleness >= 2:
        raise ValueError(
            "optimizer_sharding=zero1 does not compose with "
            "async_staleness: the snapshot ring serves the forward "
            "pass and must stay whole, but zero1 shards the update "
            "state it is refreshed from")
    if par_cfg.fsdp:
        return "fsdp"
    return "zero1" if mode == "zero1" else None


@dataclasses.dataclass(frozen=True)
class Leaf:
    """Where one leaf lives: ``dim`` is the port-layout dim split over the
    data ranks (None: whole on every rank), ``jax_dim`` the same dim in the
    JAX layout; a split leaf's shard is ``numel`` elements at ``offset``
    of the rank's flat buffer, ``[pre, s, post]`` around the split dim."""

    name: str
    shape: Tuple[int, ...]
    dim: Optional[int] = None
    jax_dim: Optional[int] = None
    offset: int = 0
    numel: int = 0
    pre: int = 1
    s: int = 0
    post: int = 1

    @property
    def shard_shape(self) -> Tuple[int, ...]:
        shape = list(self.shape)
        shape[self.dim] = self.s
        return tuple(shape)


class Layout:
    """The state layout of one run: ``mode`` ``"zero1"`` or ``"fsdp"``
    over ``mesh``'s data group of ``n`` ranks, this rank ``rank``.

    ``leaves`` maps every parameter name to its :class:`Leaf`; ``split``
    lists the split ones in the flat buffers' order, ``size`` is the
    elements of one rank's flat buffer. ``keys`` are the state entries
    kept as shards: ``params`` under fsdp, and the moments and the EMA
    (``shardings.ZERO1_KEYS``) under both."""

    def __init__(self, mode: str, mesh: Mesh, leaves: Sequence[Leaf],
                 dtype: torch.dtype):
        self.mode, self.mesh = mode, mesh
        self.n, self.rank = mesh.data, mesh.data_rank
        self.leaves = {leaf.name: leaf for leaf in leaves}
        self.split = [leaf for leaf in leaves if leaf.dim is not None]
        self.size = sum(leaf.numel for leaf in self.split)
        self.dtype = dtype
        self.keys = (("params",) if mode == "fsdp" else ()) \
            + shardings.ZERO1_KEYS

    @property
    def fsdp(self) -> bool:
        return self.mode == "fsdp"

    def is_split(self, name: str) -> bool:
        return self.leaves[name].dim is not None

    # -- flat buffers and their views ------------------------------------

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``{name: contiguous view}`` of every split leaf's shard in
        ``flat``."""
        return {leaf.name: flat[leaf.offset:leaf.offset + leaf.numel]
                .view(leaf.shard_shape) for leaf in self.split}

    def _rows(self, flat: torch.Tensor, leaf: Leaf) -> torch.Tensor:
        """``[pre, s, post]`` view of ``leaf``'s shard in ``flat``."""
        return flat[leaf.offset:leaf.offset + leaf.numel].view(
            leaf.pre, leaf.s, leaf.post)

    def shard_of(self, full: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's slice of the whole leaf ``full`` (a strided view,
        shaped as the shard)."""
        leaf = self.leaves[name]
        return full.narrow(leaf.dim, self.rank * leaf.s, leaf.s)

    def zeros(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """A zero state entry: ``{name: shard view}`` of one new flat
        buffer for the split leaves, a whole zero tensor for the others."""
        views = self.views(torch.zeros(self.size, dtype=self.dtype,
                                       device=device))
        return {name: views[name] if leaf.dim is not None
                else torch.zeros(leaf.shape, dtype=self.dtype, device=device)
                for name, leaf in self.leaves.items()}

    # -- the collectives -------------------------------------------------

    def reduce_scatter(self, grads: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """The gradients summed over the data ranks: ``{name: this rank's
        shard}`` of a split leaf (views of a new flat buffer), the
        all-reduced whole gradient of the others (summed in place)."""
        g0 = next(iter(grads.values()))
        send = torch.empty((self.n, self.size), dtype=self.dtype,
                           device=g0.device)
        for leaf in self.split:
            send[:, leaf.offset:leaf.offset + leaf.numel].view(
                self.n, leaf.pre, leaf.s, leaf.post).copy_(
                grads[leaf.name].reshape(
                    leaf.pre, self.n, leaf.s, leaf.post).transpose(0, 1))
        flat = torch.empty(self.size, dtype=self.dtype, device=g0.device)
        self.mesh.reduce_scatter_(flat, send.view(-1), "data")
        out = dict(grads)
        whole = [grads[n] for n, leaf in self.leaves.items()
                 if leaf.dim is None]
        if whole:
            cat = torch.cat([g.reshape(-1) for g in whole])
            self.mesh.all_reduce_(cat, "data")
            for g, part in zip(whole, cat.split([g.numel() for g in whole])):
                g.copy_(part.view_as(g))
        out.update(self.views(flat))
        return out

    def gather(self, flat: torch.Tensor,
               into: Optional[Mapping[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
        """All-gather ``flat`` (this rank's shards) over the data ranks and
        unpack every split leaf whole: into the tensors of ``into`` (in
        place), or into new ones. Returns ``{name: whole}`` of the split
        leaves."""
        recv = torch.empty(self.n * self.size, dtype=flat.dtype,
                           device=flat.device)
        self.mesh.all_gather_(recv, flat, "data")
        recv = recv.view(self.n, self.size)
        out = {}
        for leaf in self.split:
            rows = recv[:, leaf.offset:leaf.offset + leaf.numel].view(
                self.n, leaf.pre, leaf.s, leaf.post).transpose(0, 1)
            t = into[leaf.name] if into is not None else torch.empty(
                leaf.shape, dtype=flat.dtype, device=flat.device)
            t.view(leaf.pre, self.n, leaf.s, leaf.post).copy_(rows)
            out[leaf.name] = t
        return out

    def full(self, values: Mapping[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """``values`` (a sharded state entry) with every split leaf
        gathered whole: a collective, every data rank calls it."""
        flat = torch.cat([values[leaf.name].reshape(-1)
                          for leaf in self.split])
        out = dict(values)
        out.update(self.gather(flat))
        return out

    def pack(self, values: Mapping[str, torch.Tensor],
             device: Optional[torch.device] = None, copy: bool = False
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(flat, {name: tensor})``: this rank's shards of the whole
        tensors ``values`` in a new flat buffer (on ``device``, or on the
        values' own), a view of it for every split leaf; a leaf kept whole
        is the tensor itself (the zero1 update's parameters, updated in
        place), or with ``copy`` a copy of it on ``device``."""
        t0 = next(iter(values.values()))
        device = t0.device if device is None else device
        flat = torch.empty(self.size, dtype=self.dtype, device=device)
        for leaf in self.split:
            self._rows(flat, leaf).copy_(values[leaf.name].detach().reshape(
                leaf.pre, self.n, leaf.s, leaf.post)[:, self.rank])
        views = self.views(flat)
        return flat, {name: views[name] if leaf.dim is not None
                      else values[name].detach().to(device, copy=True)
                      if copy else values[name]
                      for name, leaf in self.leaves.items()}


def whole(state, key: str, values: Mapping[str, torch.Tensor]
          ) -> Mapping[str, torch.Tensor]:
    """``values``, the entry ``key`` of ``state`` (``"params"`` or an
    optimizer-state key), with every leaf whole: gathered over the data
    ranks (a collective: every rank calls it) where the state's layout
    keeps that entry as shards."""
    layout = state.layout
    if layout is not None and key in layout.keys:
        with torch.no_grad():
            return layout.full(values)
    return values


def build_layout(model: torch.nn.Module, model_name: str,
                 optim_cfg: OptimConfig, par_cfg: ParallelConfig,
                 mesh: Mesh) -> Optional[Layout]:
    """The run's :class:`Layout`, or None when the state stays whole
    (neither zero1 nor fsdp, or one data rank). The rule table
    (``--partition_rules``, strict or not) is matched on every run, so a
    bad table fails even where nothing is sharded."""
    mode = check_modes(optim_cfg, par_cfg)
    rules = shardings.parse_partition_rules(par_cfg.partition_rules)
    named = list(model.named_parameters())
    shapes = {name.replace(".", "/"): convert.jax_shape(name, p.shape)
              for name, p in named}
    pipe = mesh.pipe > 1
    base = shardings.param_pspecs(model_name, shapes, pipe=pipe,
                                  rules=rules,
                                  strict=par_cfg.partition_rules_strict)
    shardings.check_axes(
        base, {"data": mesh.data, "seq": mesh.seq, "model": mesh.model,
               "pipe": mesh.pipe},
        megatron=shardings.param_pspecs(model_name, shapes),
        pipeline=shardings.param_pspecs(model_name, shapes, pipe=True)
        if pipe else None)
    if pipe and mode is not None:
        raise NotImplementedError(
            f"{mode} under pipeline parallelism (pipe_axis={mesh.pipe}) "
            f"is not ported: a stage's leaves would be sharded over its "
            f"data ranks too; see {_ROADMAP}")
    if pipe and optim_cfg.optimizer == "adafactor":
        raise NotImplementedError(
            f"adafactor under pipeline parallelism is not ported: its "
            f"factored statistics are computed over the whole leaf; see "
            f"{_ROADMAP}")
    if mesh.model > 1 and optim_cfg.optimizer == "adafactor":
        raise NotImplementedError(
            f"adafactor under tensor parallelism is not ported: its "
            f"factored statistics are computed over the whole leaf; see "
            f"{shardings.TP_ROADMAP}")
    if mode is None or mesh.data == 1:
        return None
    if mesh.seq > 1:
        raise NotImplementedError(
            f"{mode} on a data x seq mesh (seq_axis={mesh.seq}) is not "
            f"ported: the gradient sum runs over seq too; see {_ROADMAP}")
    if mode == "fsdp" and optim_cfg.async_staleness >= 2:
        raise NotImplementedError(
            "fsdp with async_staleness is not ported: the forward reads a "
            f"snapshot that would be sharded; see {_ROADMAP}")
    if optim_cfg.optimizer == "adafactor":
        raise NotImplementedError(
            f"adafactor under {mode} is not ported: its factored "
            f"statistics are computed over the whole leaf; see {_ROADMAP}")
    dtypes = {p.dtype for _, p in named}
    if len(dtypes) != 1:
        raise NotImplementedError(
            f"{mode} keeps each state entry in one flat buffer of one "
            f"dtype; the model's leaves have {sorted(map(str, dtypes))}")
    specs = shardings.param_pspecs(model_name, shapes, rules=rules,
                                   fsdp_data=mesh.data)
    n, leaves, offset = mesh.data, [], 0
    for name, p in named:
        spec = specs[name.replace(".", "/")]
        jd = next((i for i, e in enumerate(spec) if e == "data"), None)
        shape = tuple(p.shape)
        if jd is None:
            leaves.append(Leaf(name, shape))
            continue
        d = convert.port_dim(name, jd)
        s = shape[d] // n
        numel = p.numel() // n
        leaves.append(Leaf(name, shape, d, jd, offset, numel,
                           math.prod(shape[:d]), s, math.prod(shape[d + 1:])))
        offset += numel
    return Layout(mode, mesh, leaves, dtypes.pop())


def partition_report(model: torch.nn.Module, model_name: str,
                     par_cfg: ParallelConfig) -> str:
    """The JAX package's ``--partition_report`` text for the model's
    parameters (JAX paths and whole shapes, also where this rank holds a
    model slice)."""
    rules = shardings.parse_partition_rules(par_cfg.partition_rules)
    split = getattr(model, "split", None)
    table = rules if rules is not None else shardings.rule_for(
        model_name, pipe=getattr(split, "over", None) == "pipe")
    shapes = {name.replace(".", "/"): convert.jax_shape(
        name, p.shape if split is None else split.whole_shape(name, p.shape))
        for name, p in model.named_parameters()}
    return shardings.format_partition_report(
        shardings.explain_partition_rules(table, shapes))
