"""Model registry: name → model class.

A model class takes ``(model_cfg, data_cfg, mesh=None)`` and builds an
``nn.Module`` with uninitialized parameters (the ViT splits its tokens
over the mesh's seq ranks; both models hold this rank's slices of their
Megatron pairs when the mesh has model ranks, ``parallel/tp.py``); its
``reset_parameters(generator)`` initializes them. The reference CNN,
ResNet-18/50 (``models/resnet.py``, which keeps BatchNorm running
stats: ``has_state``) and the dense ViT are ported. The JAX package's
other models raise ``NotImplementedError`` naming the ROADMAP queue item
that ports them.
"""

from __future__ import annotations

from typing import Callable

from torch import nn

from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
from dml_cnn_cifar10_tpu_torch.models.resnet import ResNet
from dml_cnn_cifar10_tpu_torch.models.vit import ViT

# The ResNets read their depth from ModelConfig.name.
MODELS = {"cnn": CNN, "resnet18": ResNet, "resnet50": ResNet,
          "vit_tiny": ViT}

# The JAX package's other models and where the port's queue takes them.
_QUEUED = {
    "vit_moe": "ROADMAP.md Queue 1, the rest of the config ladder "
               "(ops/moe.py + models/vit.py)",
}


def get_model(name: str) -> Callable[..., nn.Module]:
    if name in MODELS:
        return MODELS[name]
    if name in _QUEUED:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet; see "
            f"{_QUEUED[name]}. Available today: {', '.join(sorted(MODELS))}")
    raise ValueError(f"unknown model {name!r}; have {sorted(MODELS)}")
