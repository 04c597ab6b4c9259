"""Deterministic bounded exponential backoff.

A copy of ``dml_cnn_cifar10_tpu/utils/backoff.py``. One tiny pure
function shared by every retry loop of the port: the run supervisor
(``train/supervisor.py``), the rendezvous retry
(``parallel/multihost.py``) and the cluster layer's polls
(``parallel/cluster.py``) all wait ``base * 2^(attempt-1)`` capped at
``cap``. No jitter and no clock, so the sleeps of a retry budget are a
fixed list a test can pin exactly.
"""

from __future__ import annotations

from typing import List


def delay_s(base_s: float, cap_s: float, attempt: int) -> float:
    """Backoff before retry ``attempt`` (1-based): ``base * 2^(a-1)``,
    capped at ``cap_s``. ``attempt < 1`` is a contract violation."""
    if attempt < 1:
        raise ValueError(f"attempt must be >= 1, got {attempt}")
    return min(base_s * (2 ** (attempt - 1)), cap_s)


def schedule(base_s: float, cap_s: float, retries: int) -> List[float]:
    """The full deterministic sleep plan for a ``retries``-attempt
    budget: what a run WILL wait, computable before it waits it."""
    return [delay_s(base_s, cap_s, a) for a in range(1, retries + 1)]
