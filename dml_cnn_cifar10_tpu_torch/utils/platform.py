"""Device selection for the port's entry points.

The port runs on the card unless the caller asks for the CPU. A missing
card is an error, never a quiet fallback: a CPU run would report host
numbers under a device's name.
"""

from __future__ import annotations

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
