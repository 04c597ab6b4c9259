"""Model registry: name → model class.

A model class takes ``(model_cfg, data_cfg)`` and builds an ``nn.Module``
with uninitialized parameters; its ``reset_parameters(generator)``
initializes them. The reference CNN and the dense ViT are ported. The
JAX package's other models raise ``NotImplementedError`` naming the
ROADMAP queue item that ports them.
"""

from __future__ import annotations

from typing import Callable

from torch import nn

from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
from dml_cnn_cifar10_tpu_torch.models.vit import ViT

MODELS = {"cnn": CNN, "vit_tiny": ViT}

# The JAX package's other models and where the port's queue takes them.
_QUEUED = {
    "resnet18": "ROADMAP.md Queue 1, item 12 (models/resnet.py)",
    "resnet50": "ROADMAP.md Queue 1, item 12 (models/resnet.py)",
    "vit_moe": "ROADMAP.md Queue 1, item 13 (ops/moe.py + models/vit.py)",
}


def get_model(name: str) -> Callable[..., nn.Module]:
    if name in MODELS:
        return MODELS[name]
    if name in _QUEUED:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet; see "
            f"{_QUEUED[name]}. Available today: {', '.join(sorted(MODELS))}")
    raise ValueError(f"unknown model {name!r}; have {sorted(MODELS)}")
