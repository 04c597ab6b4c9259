"""Ulysses sequence parallelism — attention by a tokens-to-heads all-to-all.

Port of ``dml_cnn_cifar10_tpu/parallel/ulysses.py``, the second
long-context strategy beside the ring (``parallel/ring_attention.py``).
Between blocks the activations keep the ring's layout: each seq rank of a
data row holds its ``S/n`` token slice, ``[B, S/n, H, D]``, so the ViT's
``seq_shard`` and its pooled all-reduce serve both modes. At the attention
an all-to-all over the ``seq`` ranks re-partitions Q, K and V from
token-sharded to head-sharded ``[B, S, H/n, D]``; every rank then runs the
ordinary full-sequence attention on its head group
(``ops/attention.py:dispatch_attention``: the flash kernels from 128
tokens up, K4 forward and K6/K7 backward under grad, K3 without), and a
second all-to-all restores the token sharding.

Against the ring: Ulysses moves Q, K, V and O once each (``4·B·S·H·D/n``
elements a rank, in one collective each), while the ring moves K/V
``n − 1`` times; Ulysses needs ``heads % n == 0`` and runs one
full-sequence kernel per rank, where the ring runs ``n`` blockwise ones.
The causal flag and the window pass straight through: the local kernel
sees the whole sequence in its global coordinates.
"""

from __future__ import annotations

from typing import Optional

import torch

from dml_cnn_cifar10_tpu_torch.ops import attention as attn
from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib


def check_heads(heads: int, n: int) -> None:
    """Raise the JAX package's error when ``n`` seq ranks cannot split
    ``heads`` attention heads."""
    if heads % n:
        raise ValueError(
            f"{heads} per-device heads not divisible by seq axis {n}; use "
            f"ring attention for head counts the axis can't split")


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mesh: mesh_lib.Mesh,
                            scale: Optional[float] = None,
                            causal: bool = False,
                            segment_ids: Optional[torch.Tensor] = None,
                            window: Optional[int] = None) -> torch.Tensor:
    """Per-rank body: this rank's ``[B, S/n, H, D]`` shards of Q, K and V
    → its ``[B, S/n, H, D]`` shard of the output. Differentiable (the
    all-to-alls transpose to each other). ``segment_ids`` is this shard's
    ``[B, S/n]`` slice; the ids are all-gathered over the seq ranks so
    the full-sequence kernel masks exactly."""
    n = mesh.seq
    if n == 1:
        return attn.dispatch_attention(q, k, v, scale=scale, causal=causal,
                                       segment_ids=segment_ids,
                                       window=window)
    check_heads(q.shape[2], n)
    if segment_ids is not None:
        segment_ids = mesh.all_gather(segment_ids.to(torch.int32), "seq",
                                      dim=1)
    # [B, S/n, H, D] -> [B, S, H/n, D]: split the heads over the ranks,
    # concatenate the tokens.
    q, k, v = (mesh_lib.all_to_all(t, mesh, "seq", split_axis=2,
                                   concat_axis=1) for t in (q, k, v))
    o = attn.dispatch_attention(q, k, v, scale=scale, causal=causal,
                                segment_ids=segment_ids, window=window)
    # [B, S, H/n, D] -> [B, S/n, H, D]
    return mesh_lib.all_to_all(o, mesh, "seq", split_axis=1, concat_axis=2)
