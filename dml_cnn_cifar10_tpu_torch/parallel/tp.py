"""Tensor parallelism over the mesh's ``model`` ranks (``--model_axis``).

Port of the ``model`` half of ``dml_cnn_cifar10_tpu/parallel/
shardings.py``'s rule tables, with explicit collectives where the JAX
package leaves GSPMD to insert them. The Megatron pairs of the default
tables (CNN ``full1``/``full2``; ViT ``qkv``/``proj`` and ``mlp1``/
``mlp2``) run as a column-parallel layer, whose input passes
:func:`mesh.copy_to_model`, then a row-parallel one, whose partial output
passes :func:`mesh.reduce_from_model` before its replicated bias is added
once (a ViT whose heads the ranks cut in two gathers the qkv activations
first, ``models/vit.py``); ``vit_moe``'s expert leaves split on their
expert dim (``ops/moe.py``). Each model rank holds a contiguous ``1/M``
of every split leaf as a tensor of its own (``shardings.model_slice``,
JAX's ``addressable_shards`` order), so the update kernels take it as
they take a whole leaf.

:func:`megatron_split` is called by a model built on a mesh with
``model`` > 1: it reads the model's whole parameter shapes, cuts the
split ones to this rank's slice, and returns the :class:`ModelSplit` the
model keeps and the training state carries. The model initialises the
whole leaf from the seed's generator and keeps its slice
(:func:`init_targets`, :func:`keep_slices`), so a run over ``M`` model
ranks starts from the replicated run's exact weights.

A step then sums the gradients over the ``replica`` group (the ranks that
hold the same slices) instead of the world; a norm over leaves sums a
split leaf's squares over ``model`` and counts a replicated leaf once
(:func:`sq_sums`, which also sums the ZeRO layout's shards over
``data``); a msgpack save all-gathers each split leaf whole
(:func:`whole`, a collective) and a restore slices it back.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from dml_cnn_cifar10_tpu_torch import convert
from dml_cnn_cifar10_tpu_torch.parallel import shardings
from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh

ROADMAP = shardings.TP_ROADMAP


class ModelSplit:
    """The leaves split over ``mesh``'s model ranks: ``slices`` maps each
    split leaf's name to this rank's :class:`shardings.ModelSlice`,
    ``shapes`` to its whole shape (port layout)."""

    def __init__(self, mesh: Mesh, slices: Mapping[str,
                                                   shardings.ModelSlice],
                 shapes: Mapping[str, Tuple[int, ...]]):
        self.mesh = mesh
        self.slices = dict(slices)
        self.shapes = dict(shapes)

    def is_split(self, name: str) -> bool:
        return name in self.slices

    def whole_shape(self, name: str, local: Sequence[int], lead: int = 0
                    ) -> Tuple[int, ...]:
        """The whole shape of a leaf whose local tensor is ``local``
        (``lead`` leading axes before the parameter's own)."""
        if name not in self.slices:
            return tuple(local)
        return tuple(local[:lead]) + self.shapes[name]

    def local(self, values: Mapping[str, torch.Tensor], lead: int = 0
              ) -> Dict[str, torch.Tensor]:
        """This rank's slices of whole tensors (views)."""
        return convert.model_local(values, self.slices, lead)

    @torch.no_grad()
    def whole(self, values: Mapping[str, torch.Tensor], lead: int = 0
              ) -> Dict[str, torch.Tensor]:
        """``values`` with every split leaf all-gathered whole over the
        model ranks: a collective, every rank calls it."""
        out = dict(values)
        for name, sl in self.slices.items():
            if name in values:
                out[name] = self.mesh.all_gather(values[name], "model",
                                                 sl.dim + lead)
        return out


def megatron_split(module: nn.Module, model_name: str, mesh: Mesh
                   ) -> ModelSplit:
    """Cut ``module``'s (whole-shaped) parameters that the model's default
    table places on ``model`` to this rank's slice (new, uninitialised
    storage on the same device) and return the :class:`ModelSplit`."""
    named = dict(module.named_parameters())
    shapes = {n.replace(".", "/"): convert.jax_shape(n, p.shape)
              for n, p in named.items()}
    specs = dict(shardings._flat_specs(shardings.param_pspecs(model_name,
                                                              shapes)))
    slices, whole = {}, {}
    for name, p in named.items():
        sl = shardings.model_slice(name, specs[name.replace(".", "/")],
                                   shapes[name.replace(".", "/")],
                                   mesh.model, mesh.model_rank)
        if sl is None:
            continue
        slices[name], whole[name] = sl, tuple(p.shape)
        local = list(p.shape)
        local[sl.dim] = sl.length
        p.data = p.data.new_empty(local)
    return ModelSplit(mesh, slices, whole)


def init_targets(module: nn.Module, split: Optional[ModelSplit]
                 ) -> Dict[str, torch.Tensor]:
    """``{name: tensor an initialiser writes}``: the parameter itself, or
    for a split leaf a whole-shaped scratch tensor (so the generator draws
    what the replicated model draws); :func:`keep_slices` then copies this
    rank's slice into the parameter."""
    out = {}
    for name, p in module.named_parameters():
        if split is not None and split.is_split(name):
            out[name] = p.new_empty(split.shapes[name])
        else:
            out[name] = p
    return out


@torch.no_grad()
def keep_slices(module: nn.Module, split: Optional[ModelSplit],
                targets: Mapping[str, torch.Tensor]) -> None:
    if split is None:
        return
    local = split.local(targets)
    for name, p in module.named_parameters():
        if split.is_split(name):
            p.copy_(local[name])


def sq_sums(names: Sequence[str], tensors: Sequence[torch.Tensor],
            layout=None, split: Optional[ModelSplit] = None
            ) -> torch.Tensor:
    """Each tensor's sum of squares (f32) over its whole leaf: partial
    sums of a leaf the ZeRO ``layout`` splits are summed over ``data``,
    of a leaf ``split`` splits over ``model``, each in one all-reduce for
    all such leaves (no host copy: capturable); other leaves count once."""
    sq = [torch.sum(torch.square(t.float())) for t in tensors]
    for over, parts in (("data", layout), ("model", split)):
        if parts is None:
            continue
        idx = [i for i, n in enumerate(names) if parts.is_split(n)]
        if idx:
            part = torch.stack([sq[i] for i in idx])
            parts.mesh.all_reduce_(part, over)
            for j, i in enumerate(idx):
                sq[i] = part[j]
    return torch.stack(sq)


def lead_axes(key: str) -> int:
    """The leading axes of the optimizer-state entry ``key`` before each
    leaf's own (the staleness ring's snapshot axis)."""
    kind = convert.OPT_LAYOUTS.get(key, "port")
    if kind == "jax":
        raise NotImplementedError(
            f"the state entry {key!r} (Adafactor's factored statistics) "
            f"under tensor parallelism is not ported; see {ROADMAP}")
    return 1 if kind == "stacked" else 0


def whole(state, key: str, values: Mapping[str, torch.Tensor]
          ) -> Mapping[str, torch.Tensor]:
    """``values``, the entry ``key`` of ``state`` (``"params"`` or an
    optimizer-state key) with whole leaves over the data ranks, gathered
    whole over the model ranks too where the state is split (a
    collective)."""
    if getattr(state, "split", None) is None:
        return values
    return state.split.whole(values, lead_axes(key))


def local(state, key: str, values: Mapping[str, torch.Tensor]
          ) -> Mapping[str, torch.Tensor]:
    """Whole tensors of the entry ``key`` cut to this model rank's
    slices where the state is split."""
    if getattr(state, "split", None) is None:
        return values
    return state.split.local(values, lead_axes(key))


def whole_shape(state, key: str, name: str, shape: Sequence[int]
                ) -> Tuple[int, ...]:
    """The whole shape of leaf ``name`` of entry ``key`` whose
    model-local shape is ``shape``."""
    if getattr(state, "split", None) is None:
        return tuple(shape)
    return state.split.whole_shape(name, shape, lead_axes(key))
