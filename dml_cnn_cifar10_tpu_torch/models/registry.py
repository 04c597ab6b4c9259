"""Model registry: name → model class.

A model class takes ``(model_cfg, data_cfg, mesh=None)`` and builds an
``nn.Module`` with uninitialized parameters (the ViT splits its tokens
over the mesh's seq ranks and holds its stage's blocks over its pipe
ranks, the CNN splits its image rows over the seq ranks; both hold this
rank's slices of their Megatron pairs when the mesh has model ranks,
``parallel/tp.py``); its
``reset_parameters(generator)`` initializes them. The reference CNN,
ResNet-18/50 (``models/resnet.py``, which keeps BatchNorm running
stats: ``has_state``), the dense ViT and the MoE ViT (``vit_moe``: the
same class with ``moe_experts`` >= 2, whose forward returns ``(logits,
aux)``) are ported. Every model of the JAX package's registry is.
"""

from __future__ import annotations

from typing import Callable

from torch import nn

from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
from dml_cnn_cifar10_tpu_torch.models.resnet import ResNet
from dml_cnn_cifar10_tpu_torch.models.vit import ViT

# The ResNets read their depth, the ViT its kind, from ModelConfig.name.
MODELS = {"cnn": CNN, "resnet18": ResNet, "resnet50": ResNet,
          "vit_tiny": ViT, "vit_moe": ViT}


def get_model(name: str) -> Callable[..., nn.Module]:
    if name in MODELS:
        return MODELS[name]
    raise ValueError(f"unknown model {name!r}; have {sorted(MODELS)}")
