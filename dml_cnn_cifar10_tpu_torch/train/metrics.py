"""Metrics.

``batch_accuracy`` is parity with ``cifar10cnn.py:166-176``: argmax over
logits vs int labels, mean over the batch. Ties take the first maximal
index, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import torch


def batch_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    preds = torch.argmax(logits, dim=-1)
    return (preds == labels.long()).float().mean()


def correct_count(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Unnormalized correct count — summable across batches for the
    full-test-set eval (pad rows labeled -1 count 0)."""
    preds = torch.argmax(logits, dim=-1)
    return (preds == labels.long()).sum()
