"""The reference 5-layer CNN (2 conv + 3 FC) as an ``nn.Module``.

Architecture from ``create_cnn`` (``cifar10cnn.py:94-147``), as in
``dml_cnn_cifar10_tpu/models/cnn.py``:

  conv1 5×5×C→64 s1 SAME + bias + ReLU   (:105-110)
  maxpool 3×3 s2 SAME                    (:113)
  conv2 5×5×64→64 s1 SAME + bias + ReLU  (:116-121)
  maxpool 3×3 s2 SAME                    (:123)
  flatten                                (:126-127)
  FC →384 + ReLU                         (:130-133)
  FC 384→192 + ReLU                      (:136-139)
  FC 192→num_classes (+ReLU in faithful mode, ``:145``)

Parameters keep the JAX package's leaf names (``conv1.kernel``,
``conv1.bias``, ...) in PyTorch's layouts: conv kernels OIHW, dense
kernels ``[out, in]``. ``convert.py`` maps them to and from the JAX
layouts. The input is NHWC like the JAX model's; activations run NCHW and
are permuted back to NHWC before the flatten, because ``full1``'s rows
are in the JAX model's NHWC flatten order (``cnn.py:74``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
from dml_cnn_cifar10_tpu_torch.ops import layers as L


class _Layer(nn.Module):
    """One weight layer: ``kernel`` (PyTorch layout) + ``bias``."""

    def __init__(self, kernel_shape, width: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel_shape))
        self.bias = nn.Parameter(torch.empty(width))


class CNN(nn.Module):
    def __init__(self, cfg: ModelConfig, data: DataConfig):
        super().__init__()
        self.cfg = cfg
        h, w = L.pooled_hw(data.crop_height, data.crop_width, n_pools=2)
        self.conv1 = _Layer((64, data.num_channels, 5, 5), 64)
        self.conv2 = _Layer((64, 64, 5, 5), 64)
        self.full1 = _Layer((384, h * w * 64), 384)
        self.full2 = _Layer((192, 384), 192)
        self.full3 = _Layer((cfg.num_classes, 192), cfg.num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> None:
        """Truncated normal σ=init_stddev weights (``:97-98``), constant
        bias_init biases (``:100-101``)."""
        for layer in (self.conv1, self.conv2, self.full1, self.full2,
                      self.full3):
            L.truncated_normal_(layer.kernel, self.cfg.init_stddev,
                                generator=generator)
            layer.bias.fill_(self.cfg.bias_init)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images → logits [B, num_classes] (float32)."""
        # NHWC -> contiguous NCHW: a permuted view is channels_last in
        # memory, and the convolutions would hand back channels_last
        # (non-contiguous) kernel gradients.
        x = images.float().permute(0, 3, 1, 2).contiguous()
        x = F.relu(L.conv2d_nchw(x, self.conv1.kernel, self.conv1.bias))
        x = L.max_pool_nchw(x)
        x = F.relu(L.conv2d_nchw(x, self.conv2.kernel, self.conv2.bias))
        x = L.max_pool_nchw(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = F.relu(F.linear(x, self.full1.kernel, self.full1.bias))
        x = F.relu(F.linear(x, self.full2.kernel, self.full2.bias))
        logits = F.linear(x, self.full3.kernel, self.full3.bias)
        if self.cfg.logit_relu:  # faithful: reference ReLUs its logits (:145)
            logits = F.relu(logits)
        return logits
