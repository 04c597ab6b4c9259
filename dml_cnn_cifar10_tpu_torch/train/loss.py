"""Loss functions.

``softmax_cross_entropy`` is the parity loss: sparse softmax cross-entropy
averaged over the batch (``cifar_loss``, ``cifar10cnn.py:150-157``).
"""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean sparse softmax CE. logits [B, K] float, labels [B] int.

    ``label_smoothing`` ε mixes the one-hot target with uniform:
    ``(1-ε)·onehot + ε/K``.
    """
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    if label_smoothing:
        uniform = -logp.mean(dim=-1)  # ε/K on every class
        nll = (1.0 - label_smoothing) * nll + label_smoothing * uniform
    return nll.mean()
