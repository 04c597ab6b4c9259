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

# Leaf name -> (JAX layout -> port layout, port layout -> JAX layout).
_CONV = (lambda a: a.transpose(3, 2, 0, 1),    # HWIO -> OIHW
         lambda a: a.transpose(2, 3, 1, 0))    # OIHW -> HWIO
_DENSE = (lambda a: a.T, lambda a: a.T)        # [in, out] <-> [out, in]
LAYOUTS = {
    # models/cnn.py
    "conv1.kernel": _CONV, "conv2.kernel": _CONV,
    "full1.kernel": _DENSE, "full2.kernel": _DENSE, "full3.kernel": _DENSE,
}


def params_from_jax(tree: Mapping[str, Any], prefix: str = ""
                    ) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (JAX layout) → flat ``{dotted name: tensor}``
    in the port's layout."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(params_from_jax(value, prefix=name + "."))
        else:
            a = np.asarray(value)
            if name in LAYOUTS:
                a = LAYOUTS[name][0](a)
            # A copy: arrays fetched from JAX are read-only.
            out[name] = torch.from_numpy(np.array(a, order="C"))
    return out


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Flat ``{dotted name: tensor}`` (port layout) → nested dict of
    numpy arrays in the JAX layout, keys sorted at every level (the order
    JAX's tree flattening gives, so serialized bytes match)."""
    tree: Dict[str, Any] = {}
    for name in sorted(state):
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        a = state[name].detach().to("cpu").numpy()
        if name in LAYOUTS:
            a = LAYOUTS[name][1](a)
        node[leaf] = np.ascontiguousarray(a)
    return tree
