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

Tensor parallelism (a mesh with ``model`` > 1, ``parallel/tp.py``):
``full1`` is column-parallel (each model rank holds ``384/M`` of its
output features: a ``[384/M, 2304]`` kernel and its bias slice; its input
passes ``copy_to_model``), ``full2`` row-parallel (a ``[192, 384/M]``
kernel whose partial product is summed by ``reduce_from_model``, then the
replicated bias is added once); the convs and ``full3`` stay replicated.
The whole model is initialised from the generator and each rank keeps its
slices.

Spatial partitioning (a mesh with ``seq`` > 1, ``parallel/spatial.py``;
the JAX package's ``spatial`` CNN, its image H sharded over ``seq``):
each seq rank of a data row keeps its ``1/S`` of the rows of the decoded
images its data rank reads, both convolutions take their halo rows from
the neighbouring seq ranks, both pools the rows their windows reach, and
the pooled map is gathered whole before the flatten, so the FCs run whole
on every seq rank. Gradient rule (as the ViT's sequence split): the
convolutions' and the FCs' gradients both arrive ``S`` times over — the
convolutions' as ``S`` times each rank's rows' share (the gather's
backward sums the cotangent over the seq ranks), to be summed over the
seq ranks; the FCs' whole on every seq rank — and the step's ``1 /
replicas`` (data x seq ranks) share with its all-reduce over them gives
each the mean over the global batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
from dml_cnn_cifar10_tpu_torch.ops import layers as L
from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
from dml_cnn_cifar10_tpu_torch.parallel import shardings, spatial, tp


class _Layer(nn.Module):
    """One weight layer: ``kernel`` (PyTorch layout) + ``bias``."""

    def __init__(self, kernel_shape, width: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel_shape))
        self.bias = nn.Parameter(torch.empty(width))


class CNN(nn.Module):
    def __init__(self, cfg: ModelConfig, data: DataConfig, mesh=None):
        super().__init__()
        if mesh is not None and mesh.pipe > 1:
            shardings.rule_for("cnn", pipe=True)   # raises: no pipe table
        self.cfg = cfg
        # The spatial split's mesh and each layer's rows over its seq
        # ranks (input, after the first pool, after the second), or None.
        self.spatial_mesh = mesh if mesh is not None and mesh.seq > 1 \
            else None
        if self.spatial_mesh is not None:
            rows = spatial.Split.even(data.crop_height, mesh.seq)
            self.rows = (rows, rows.pooled(), rows.pooled().pooled())
            for split in self.rows[:2]:
                spatial.check_rows(split, kernel=5, window=3, stride=2)
        h, w = L.pooled_hw(data.crop_height, data.crop_width, n_pools=2)
        self.conv1 = _Layer((64, data.num_channels, 5, 5), 64)
        self.conv2 = _Layer((64, 64, 5, 5), 64)
        self.full1 = _Layer((384, h * w * 64), 384)
        self.full2 = _Layer((192, 384), 192)
        self.full3 = _Layer((cfg.num_classes, 192), cfg.num_classes)
        # The model ranks' mesh and this rank's slices, or None.
        self.tp_mesh = mesh if mesh is not None and mesh.model > 1 else None
        self.split = None if self.tp_mesh is None else tp.megatron_split(
            self, "cnn", self.tp_mesh)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> None:
        """Truncated normal σ=init_stddev weights (``:97-98``), constant
        bias_init biases (``:100-101``); under tensor parallelism the
        whole leaves, of which this rank keeps its slices."""
        targets = tp.init_targets(self, self.split)
        for layer in ("conv1", "conv2", "full1", "full2", "full3"):
            L.truncated_normal_(targets[f"{layer}.kernel"],
                                self.cfg.init_stddev, generator=generator)
            targets[f"{layer}.bias"].fill_(self.cfg.bias_init)
        tp.keep_slices(self, self.split, targets)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images → logits [B, num_classes] (float32)."""
        # NHWC -> contiguous NCHW: a permuted view is channels_last in
        # memory, and the convolutions would hand back channels_last
        # (non-contiguous) kernel gradients.
        mesh = self.spatial_mesh
        if mesh is not None:
            # This seq rank's rows of the decoded images.
            images = spatial.own_rows(images, mesh, self.rows[0])
        x = images.float().permute(0, 3, 1, 2).contiguous()
        if mesh is None:
            x = F.relu(L.conv2d_nchw(x, self.conv1.kernel, self.conv1.bias))
            x = L.max_pool_nchw(x)
            x = F.relu(L.conv2d_nchw(x, self.conv2.kernel, self.conv2.bias))
            x = L.max_pool_nchw(x)
        else:
            r0, r1, r2 = self.rows
            x = F.relu(spatial.conv2d(x, self.conv1.kernel, self.conv1.bias,
                                      mesh, r0))
            x = spatial.max_pool(x, mesh, r0)
            x = F.relu(spatial.conv2d(x, self.conv2.kernel, self.conv2.bias,
                                      mesh, r1))
            x = spatial.gather(spatial.max_pool(x, mesh, r1), mesh, r2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        if self.tp_mesh is None:
            x = F.relu(F.linear(x, self.full1.kernel, self.full1.bias))
            x = F.relu(F.linear(x, self.full2.kernel, self.full2.bias))
        else:
            x = mesh_lib.copy_to_model(x, self.tp_mesh)
            x = F.relu(F.linear(x, self.full1.kernel, self.full1.bias))
            x = mesh_lib.reduce_from_model(F.linear(x, self.full2.kernel),
                                           self.tp_mesh)
            x = F.relu(x + self.full2.bias)
        logits = F.linear(x, self.full3.kernel, self.full3.bias)
        if self.cfg.logit_relu:  # faithful: reference ReLUs its logits (:145)
            logits = F.relu(logits)
        return logits
