"""Device selection for the port's entry points.

The port runs on the card unless the caller asks for the CPU. A missing
card is an error, never a quiet fallback: a CPU run would report host
numbers under a device's name.
"""

from __future__ import annotations

from typing import Sequence

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``torch.device`` for ``name`` ("cuda", "cuda:N" or "cpu"); raises
    when a CUDA device is asked for and none is available."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass --device cpu (device='cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}; use cuda or cpu")
    return dev


def local_index(worker_hosts: Sequence[str], rank: int) -> int:
    """Rank ``rank``'s index among the ranks of its own host: the entries
    of ``worker_hosts`` (``host:port``, one a rank) before it that name
    the same host. Hosts may run unequal numbers of ranks, in any order.
    With no list every rank is on one host, and the index is ``rank``."""
    if not worker_hosts:
        return rank
    host = worker_hosts[rank].rpartition(":")[0]
    return sum(entry.rpartition(":")[0] == host
               for entry in worker_hosts[:rank])


def rank_device(name: str, rank: int,
                worker_hosts: Sequence[str] = ()) -> torch.device:
    """The device of process ``rank``: for a bare "cuda", card
    ``local_index(worker_hosts, rank) % device_count`` of its host
    (several ranks of a host share a card when it has more ranks than
    cards); ``name`` itself otherwise."""
    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_index(worker_hosts, rank)
                            % torch.cuda.device_count())
    return dev


def default_backend(device: torch.device) -> str:
    """``torch.distributed`` backend when the caller names none: NCCL for
    cards, gloo for the CPU. Several ranks on one card must ask for gloo
    themselves: NCCL refuses two ranks on one device."""
    return "nccl" if device.type == "cuda" else "gloo"
