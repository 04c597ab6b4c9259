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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

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

#: How an optimizer-state tree is laid out, by its key in the state: the
#: port's layout (the default, as the params), the JAX layout already
#: (Adafactor's factored moments, computed on the JAX-layout view), or
#: the port's layout under a leading snapshot axis (the staleness ring).
OPT_LAYOUTS = {"vr": "jax", "vc": "jax", "v": "jax", "stale": "stacked"}


def _perm(name: str, lead: int, direction: int):
    """The permutation of a leaf with ``lead`` leading axes, or None."""
    if name not in LAYOUTS:
        return None
    return tuple(range(lead)) + tuple(lead + a
                                      for a in LAYOUTS[name][direction])


def jax_shape(name: str, shape) -> tuple:
    """The JAX-layout shape of the port's leaf ``name`` of ``shape``."""
    perm = _perm(name, 0, 1)
    shape = tuple(shape)
    return shape if perm is None else tuple(shape[a] for a in perm)


def jax_view(name: str, t: torch.Tensor) -> torch.Tensor:
    """The port's leaf ``name`` seen in the JAX layout (a view: writes go
    through to ``t``)."""
    perm = _perm(name, 0, 1)
    return t if perm is None else t.permute(perm)


def params_from_jax(tree: Mapping[str, Any], prefix: str = "",
                    layout: str = "port") -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (JAX layout) → flat ``{dotted name: tensor}``
    in the port's layout (``layout="port"``), with a leading snapshot axis
    (``"stacked"``), or kept in the JAX layout (``"jax"``)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(params_from_jax(value, prefix=name + ".",
                                       layout=layout))
        else:
            a = np.asarray(value)
            perm = None if layout == "jax" else _perm(
                name, int(layout == "stacked"), 0)
            if perm is not None:
                a = a.transpose(perm)
            # A copy: arrays fetched from JAX are read-only.
            out[name] = torch.from_numpy(np.array(a, order="C"))
    return out


def params_to_jax(state: Mapping[str, torch.Tensor],
                  layout: str = "port") -> Dict[str, Any]:
    """Flat ``{dotted name: tensor}`` (port layout; see
    :func:`params_from_jax` for ``layout``) → nested dict of numpy arrays
    in the JAX layout, keys sorted at every level (the order JAX's tree
    flattening gives, so serialized bytes match)."""
    tree: Dict[str, Any] = {}
    for name in sorted(state):
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        a = state[name].detach().to("cpu").numpy()
        perm = None if layout == "jax" else _perm(
            name, int(layout == "stacked"), 1)
        if perm is not None:
            a = a.transpose(perm)
        # np.array, not np.ascontiguousarray: that one makes a 0-d leaf
        # (Adafactor's placeholders) 1-d.
        node[leaf] = np.array(a, order="C")
    return tree
