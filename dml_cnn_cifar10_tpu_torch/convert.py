"""Carry weights between the JAX package's pytrees and the port.

The JAX package keeps params as a nested dict of arrays in its layouts
(conv kernels HWIO, dense kernels ``[in, out]``). The port's CNN keeps the
same leaf names in PyTorch's layouts (conv kernels OIHW, dense kernels
``[out, in]``); the ViT keeps the JAX layouts themselves, its per-block
leaves stacked ``[depth, ...]``. The mapping is by leaf NAME, never by
rank: the ViT's stacked ``blocks.ln1.scale`` is 2-D and ``blocks.qkv.kernel``
3-D, and neither may be transposed. ``LAYOUTS`` names every leaf the port
holds in another layout; every other leaf passes through unchanged.

``params_from_jax(tree) -> {"conv1.kernel": tensor, ...}`` (CPU tensors,
the key order of ``module.named_parameters()`` is irrelevant: callers
look up by name) and ``params_to_jax(state) -> tree`` (numpy). Both are
exact: a round trip reproduces every bit.

The ResNet's trees hold lists (``params["stage1"][0]["conv1"]``): a list
index becomes a name (``stage1.0.conv1``), and ``params_to_jax`` writes
it back as a dict keyed ``"0"``, ``"1"``, ... (flax's state-dict form of a
list, the form its msgpack holds) or, with ``lists=True``, as the list
itself. Its conv kernels are bare leaves named ``conv``, ``conv<k>`` or
``proj`` (OIHW in the port, HWIO in JAX); ``fc.kernel`` keeps the JAX
layout. Its ``model_state`` (BatchNorm running stats) mirrors the params
tree with ``None`` at every leaf that is not a BN layer's (JAX
``resnet.init_state``): :func:`params_from_jax` drops the ``None``
leaves, :func:`state_to_jax` rebuilds them from the parameter names.

Under tensor parallelism a rank holds a slice of some leaves
(``parallel/tp.py``): :func:`model_local` cuts whole tensors to a rank's
slices (the gather back is ``ModelSplit.whole``, a collective).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Mapping

import numpy as np
import torch

# Leaf name -> (JAX layout -> port layout, port layout -> JAX layout), as
# axis permutations of the leaf's own (trailing) dims.
_CONV = ((3, 2, 0, 1),    # HWIO -> OIHW
         (2, 3, 1, 0))    # OIHW -> HWIO
_DENSE = ((1, 0), (1, 0))  # [in, out] <-> [out, in]
LAYOUTS = {
    # models/cnn.py
    "conv1.kernel": _CONV, "conv2.kernel": _CONV,
    "full1.kernel": _DENSE, "full2.kernel": _DENSE, "full3.kernel": _DENSE,
}

# The ResNet's conv kernels (models/resnet.py): bare leaves.
_RESNET_CONV = re.compile(r"(^|\.)(conv\d*|proj)$")


def _layout(name: str):
    if name in LAYOUTS:
        return LAYOUTS[name]
    return _CONV if _RESNET_CONV.search(name) else None


#: How an optimizer-state tree is laid out, by its key in the state: the
#: port's layout (the default, as the params), the JAX layout already
#: (Adafactor's factored moments, computed on the JAX-layout view), or
#: the port's layout under a leading snapshot axis (the staleness ring).
OPT_LAYOUTS = {"vr": "jax", "vc": "jax", "v": "jax", "stale": "stacked"}


def _perm(name: str, lead: int, direction: int):
    """The permutation of a leaf with ``lead`` leading axes, or None."""
    perms = _layout(name)
    if perms is None:
        return None
    return tuple(range(lead)) + tuple(lead + a for a in perms[direction])


def jax_shape(name: str, shape) -> tuple:
    """The JAX-layout shape of the port's leaf ``name`` of ``shape``."""
    perm = _perm(name, 0, 1)
    shape = tuple(shape)
    return shape if perm is None else tuple(shape[a] for a in perm)


def port_dim(name: str, jax_dim: int) -> int:
    """The dim of the port's leaf ``name`` that is dim ``jax_dim`` of its
    JAX layout."""
    perm = _perm(name, 0, 0)
    return jax_dim if perm is None else perm.index(jax_dim)


def jax_view(name: str, t: torch.Tensor) -> torch.Tensor:
    """The port's leaf ``name`` seen in the JAX layout (a view: writes go
    through to ``t``)."""
    perm = _perm(name, 0, 1)
    return t if perm is None else t.permute(perm)


def params_from_jax(tree: Mapping[str, Any], prefix: str = "",
                    layout: str = "port") -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (JAX layout) → flat ``{dotted name: tensor}``
    in the port's layout (``layout="port"``), with a leading snapshot axis
    (``"stacked"``), or kept in the JAX layout (``"jax"``). A list's
    index is a name; ``None`` leaves (a ``model_state``'s) are dropped."""
    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, (Mapping, list, tuple)):
            out.update(params_from_jax(value, prefix=name + ".",
                                       layout=layout))
        elif value is not None:
            a = np.asarray(value)
            perm = None if layout == "jax" else _perm(
                name, int(layout == "stacked"), 0)
            if perm is not None:
                a = a.transpose(perm)
            # A copy: arrays fetched from JAX are read-only.
            out[name] = torch.from_numpy(np.array(a, order="C"))
    return out


def to_jax_array(name: str, t: torch.Tensor, layout: str = "port"
                 ) -> np.ndarray:
    """The port's leaf ``name`` (see :func:`params_from_jax` for
    ``layout``) as a C-ordered numpy array in the JAX layout."""
    a = t.detach().to("cpu").numpy()
    perm = None if layout == "jax" else _perm(
        name, int(layout == "stacked"), 1)
    if perm is not None:
        a = a.transpose(perm)
    # np.array, not np.ascontiguousarray: that one makes a 0-d leaf
    # (Adafactor's placeholders) 1-d.
    return np.array(a, order="C")


def _nest(names: Iterable[str], leaf_of) -> Dict[str, Any]:
    """Nested dicts of ``leaf_of(name)`` by the dotted names, inserted in
    sorted name order (keys sorted at every level)."""
    tree: Dict[str, Any] = {}
    for name in sorted(names):
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = leaf_of(name)
    return tree


def _listify(node: Any) -> Any:
    """Dicts keyed ``"0"``..``"n-1"`` back into lists, at every level."""
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_listify(node[str(i)]) for i in range(len(node))]
    return {k: _listify(v) for k, v in node.items()}


def params_to_jax(state: Mapping[str, torch.Tensor],
                  layout: str = "port", lists: bool = False
                  ) -> Dict[str, Any]:
    """Flat ``{dotted name: tensor}`` (port layout; see
    :func:`params_from_jax` for ``layout``) → nested dict of numpy arrays
    in the JAX layout, keys sorted at every level (the order JAX's tree
    flattening gives, so serialized bytes match). A numeric name is a
    list index: kept as a ``"0"`` key (flax's msgpack form), or with
    ``lists`` made a list again (the JAX pytree)."""
    tree = _nest(state, lambda name: to_jax_array(name, state[name],
                                                  layout))
    return _listify(tree) if lists else tree


def state_to_jax(model_state: Mapping[str, torch.Tensor],
                 param_names: Iterable[str], lists: bool = False
                 ) -> Dict[str, Any]:
    """The JAX ``model_state`` tree of a ResNet: the params tree's shape
    (from ``param_names``) with ``{"mean", "var"}`` (numpy, from
    ``model_state``, the port's ``<bn>.mean``/``<bn>.var`` buffers) in
    place of every BN layer's ``{"scale", "offset"}`` and ``None`` at
    every other leaf (JAX ``resnet.init_state``). ``lists`` as in
    :func:`params_to_jax`."""
    tree = _nest(param_names, lambda name: None)

    def walk(node: Dict[str, Any], prefix: str) -> None:
        for key, value in node.items():
            if not isinstance(value, dict):
                continue
            if set(value) == {"scale", "offset"}:
                node[key] = {s: to_jax_array(f"{prefix}{key}.{s}",
                                             model_state[f"{prefix}{key}.{s}"])
                             for s in ("mean", "var")}
            else:
                walk(value, f"{prefix}{key}.")

    walk(tree, "")
    return _listify(tree) if lists else tree


def model_local(values: Mapping[str, Any], slices: Mapping[str, Any],
                lead: int = 0) -> Dict[str, Any]:
    """``values`` (whole tensors or arrays, port layout, ``lead`` leading
    axes) with every leaf of ``slices`` (name -> ``shardings.ModelSlice``)
    cut to its slice: views, or numpy views."""
    out = dict(values)
    for name, sl in slices.items():
        if name in values:
            v = values[name]
            idx = [slice(None)] * (sl.dim + lead) + [
                slice(sl.start, sl.start + sl.length)]
            out[name] = v[tuple(idx)]
    return out

