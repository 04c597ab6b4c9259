"""Carry weights between the JAX package's pytrees and the port.

The JAX package keeps params as a nested dict of arrays in its layouts
(conv kernels HWIO, dense kernels ``[in, out]``); the port's modules keep
the same leaf names in PyTorch's layouts (conv kernels OIHW, dense
kernels ``[out, in]``). A leaf's rank decides its mapping: 4-D kernels
permute, 2-D kernels transpose, vectors pass through.

``params_from_jax(tree) -> {"conv1.kernel": tensor, ...}`` (CPU tensors,
the key order of ``module.named_parameters()`` is irrelevant: callers
look up by name) and ``params_to_jax(state) -> tree`` (numpy). Both are
exact: a round trip reproduces every bit.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:   # HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:   # [in, out] -> [out, in]
        return a.T
    return a


def _to_jax_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:   # OIHW -> HWIO
        return a.transpose(2, 3, 1, 0)
    if a.ndim == 2:
        return a.T
    return a


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
            a = _to_torch_layout(np.asarray(value))
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
        node[leaf] = np.ascontiguousarray(_to_jax_layout(a))
    return tree
