"""ResNet-18/34/50 as an ``nn.Module`` — the deeper conv rungs of the ladder.

Port of ``dml_cnn_cifar10_tpu/models/resnet.py`` (the BASELINE.json ladder
configs "ResNet-18 on CIFAR-10 (deeper conv stack, BatchNorm psum)" and
"ResNet-50 on ImageNet-1k"):

- The stem follows the input size: crops of 64 px or less take the 3×3/s1
  stem with no pool, larger ones the 7×7/s2 stem and a 3×3/s2 max pool,
  both with TF "SAME" padding (asymmetric at stride 2: ``ops/layers.py``).
- Stages of widths 64/128/256/512, basic blocks (18, 34) or bottlenecks
  ×4 (50). The first block of stages 2-4 strides on ``conv1`` (basic) or
  ``conv2`` (bottleneck); a block whose shape changes has a ``proj`` 1×1
  conv and its BN on the shortcut. Convs carry no bias; the last BN of
  each residual branch starts at γ = 0, so every block starts as the
  identity.
- ``resnet_norm="nf"`` replaces every BN by scaled weight standardization
  (each output channel's fan-in standardized with the population
  variance, eps 1e-4, times a gain), a per-conv bias and a ``skip_gain``
  on the branch that starts at 0. It keeps no running stats.
- ``resnet_s2d`` (ImageNet stem only) folds the image 2×2 into channels in
  JAX's ``(a, b, c)`` order and runs a 4×4/1 conv with the explicit
  padding ``((1, 2), (1, 2))`` in place of the 7×7/2 one.
- ``remat`` recomputes each block in the backward pass
  (``torch.utils.checkpoint``). The block returns its new running stats,
  which are written after it returns, so the recompute, which throws its
  own away, never updates them a second time (``jax.checkpoint`` is pure).

Parameters keep the JAX package's leaf names with list indices as names
(``stage1.0.conv1``, ``stage1.0.bn1.scale``, ``stem.bn.offset``,
``fc.kernel``): conv kernels in PyTorch's OIHW layout (``convert.py`` maps
them to and from HWIO), the dense kernel in the JAX ``[in, out]`` layout.
The BN running stats are float32 buffers named the same way
(``stage1.0.bn1.mean``/``var``): the ``TrainState``'s ``model_state``.
The forward reads ``self.training``: in train mode each BN normalizes by
the batch statistics and writes ``m·old + (1 − m)·batch`` into its
buffers in place (so a CUDA graph that captured the step updates them on
every replay); in eval mode it normalizes by the buffers and leaves them
alone. Over several data ranks (a ``mesh``) the batch statistics are
global (``ops/layers.py:batch_norm_nchw``).

Like the JAX model every parameter is cast to ``compute_dtype`` before use
(the BN statistics stay float32) and the logits come back float32.
Activations run NCHW for cuDNN. Tensor parallelism and spatial
partitioning of the ResNet are not ported.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dml_cnn_cifar10_tpu_torch import convert
from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
from dml_cnn_cifar10_tpu_torch.ops import layers as L
from dml_cnn_cifar10_tpu_torch.parallel import shardings

# depth -> (blocks per stage, block kind)
STAGES = {
    18: ((2, 2, 2, 2), "basic"),
    34: ((3, 4, 6, 3), "basic"),
    50: ((3, 4, 6, 3), "bottleneck"),
}
STAGE_WIDTHS = (64, 128, 256, 512)
BOTTLENECK_EXPANSION = 4
NORMS = ("bn", "nf")
#: The ROADMAP item that takes the ResNet's other parallel layouts.
ROADMAP = ("ROADMAP.md Queue 1 item 4 (the ResNet under --model_axis and "
           "--seq_axis)")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_WS_EPS = 1e-4


class _BN(nn.Module):
    """One BatchNorm: ``scale``/``offset`` params, ``mean``/``var``
    float32 running-stat buffers."""

    def __init__(self, width: int, dtype: torch.dtype):
        super().__init__()
        for name, t in L.bn_init(width, dtype).items():
            self.register_parameter(name, nn.Parameter(t))
        self.register_buffer("mean", torch.zeros(width))
        self.register_buffer("var", torch.ones(width))


def _conv(cout: int, cin: int, k: int, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty((cout, cin, k, k), dtype=dtype))


class _Block(nn.Module):
    """A residual block's leaves, by the JAX package's names."""

    def __init__(self, kind: str, nf: bool, cin: int, width: int,
                 stride: int, dtype):
        super().__init__()
        self.kind, self.nf, self.stride = kind, nf, stride
        if kind == "bottleneck":
            cout = width * BOTTLENECK_EXPANSION
            convs = (("1", cin, width, 1), ("2", width, width, 3),
                     ("3", width, cout, 1))
        else:
            cout = width
            convs = (("1", cin, width, 3), ("2", width, width, 3))
        self.has_proj = stride != 1 or cin != cout
        if self.has_proj:
            convs += (("p", cin, cout, 1),)
        for tag, ci, co, k in convs:
            name = "proj" if tag == "p" else f"conv{tag}"
            setattr(self, name, _conv(co, ci, k, dtype))
            if nf:
                self.register_parameter(
                    f"g{tag}", nn.Parameter(torch.ones(co, dtype=dtype)))
                self.register_parameter(
                    f"c{tag}", nn.Parameter(torch.zeros(co, dtype=dtype)))
            else:
                setattr(self, "proj_bn" if tag == "p" else f"bn{tag}",
                        _BN(co, dtype))
        if nf:
            self.skip_gain = nn.Parameter(torch.zeros((), dtype=dtype))
        self.last = "3" if kind == "bottleneck" else "2"
        self.cout = cout


def _ws(w: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """Scaled weight standardization of an OIHW kernel over each output
    channel's fan-in (JAX ``resnet.py:_ws_conv``, population variance)."""
    var, mu = torch.var_mean(w, dim=(1, 2, 3), keepdim=True, correction=0)
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    return (w - mu) * torch.rsqrt(var * fan_in + _WS_EPS) \
        * gain[:, None, None, None]


def _chan(t: torch.Tensor) -> torch.Tensor:
    """A per-channel vector broadcast over NCHW."""
    return t[:, None, None]


class ResNet(nn.Module):
    #: The model keeps a ``model_state`` (the JAX ``ModelDef.has_state``).
    has_state = True

    def __init__(self, cfg: ModelConfig, data: DataConfig, mesh=None):
        super().__init__()
        depth = depth_of(cfg.name)
        if cfg.resnet_norm not in NORMS:
            raise ValueError(f"resnet_norm must be 'bn' or 'nf', got "
                             f"{cfg.resnet_norm!r}")
        if mesh is not None and mesh.pipe > 1:
            shardings.rule_for(cfg.name, pipe=True)   # raises: no pipe table
        if mesh is not None and mesh.model > 1:
            raise NotImplementedError(
                f"the ResNet under tensor parallelism (model_axis="
                f"{mesh.model}) is not ported; see {ROADMAP}")
        if mesh is not None and mesh.seq > 1:
            raise NotImplementedError(
                f"the ResNet's spatial partitioning (seq_axis={mesh.seq}) "
                f"is not ported; see {ROADMAP}")
        self.cfg = cfg
        self.depth = depth
        self.nf = cfg.resnet_norm == "nf"
        # Cross-replica BN over the data ranks.
        self.bn_mesh = mesh if (mesh is not None and mesh.data > 1
                                and not self.nf) else None
        dt = _DTYPES[cfg.dtype]
        self.imagenet_stem = min(data.crop_height, data.crop_width) > 64
        self.s2d = self.imagenet_stem and cfg.resnet_s2d
        c = data.num_channels
        self.stem = nn.Module()
        if self.s2d:
            self.stem.conv = _conv(64, 4 * c, 4, dt)
        else:
            self.stem.conv = _conv(64, c, 7 if self.imagenet_stem else 3, dt)
        if self.nf:
            self.stem.g = nn.Parameter(torch.ones(64, dtype=dt))
            self.stem.c = nn.Parameter(torch.zeros(64, dtype=dt))
        else:
            self.stem.bn = _BN(64, dt)
        blocks, kind = STAGES[depth]
        cin = 64
        for si, (n, width) in enumerate(zip(blocks, STAGE_WIDTHS)):
            stage = nn.ModuleList()
            for bi in range(n):
                stride = 2 if (bi == 0 and si > 0) else 1
                blk = _Block(kind, self.nf, cin, width, stride, dt)
                cin = blk.cout
                stage.append(blk)
            setattr(self, f"stage{si + 1}", stage)
        self.fc = nn.Module()
        self.fc.kernel = nn.Parameter(torch.empty((cin, cfg.num_classes),
                                                  dtype=dt))
        self.fc.bias = nn.Parameter(torch.zeros(cfg.num_classes, dtype=dt))
        self.split = None

    def stages(self):
        return [getattr(self, f"stage{i}") for i in range(1, 5)]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> None:
        """He-normal conv and dense kernels (fan-in of the JAX layout),
        BN scale 1 / offset 0 (the last BN of each branch 0), running
        stats 0 / 1, nf gains 1, biases and ``skip_gain`` 0."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "fc.kernel" or leaf.startswith("conv") \
                    or leaf == "proj":
                L.he_normal_(convert.jax_view(name, p), generator)
            elif leaf == "scale" or re.fullmatch(r"g[123p]?", leaf):
                p.fill_(1.0)
            else:
                p.zero_()
        for stage in self.stages():
            for blk in stage:
                if not self.nf:
                    getattr(blk, f"bn{blk.last}").scale.zero_()
        for name, b in self.named_buffers():
            b.fill_(0.0 if name.endswith(".mean") else 1.0)

    # --- forward ---

    def _bn(self, x, p, s, key: str, new: Dict[str, torch.Tensor]):
        y, mean, var = L.batch_norm_nchw(
            x, p[f"{key}.scale"], p[f"{key}.offset"], s[f"{key}.mean"],
            s[f"{key}.var"], self.training, self.cfg.bn_momentum,
            self.cfg.bn_eps, self.bn_mesh)
        new[f"{key}.mean"], new[f"{key}.var"] = mean, var
        return y

    def _block(self, x: torch.Tensor, p: Dict[str, torch.Tensor],
               s: Dict[str, torch.Tensor], blk: _Block
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One residual block on its (compute-dtype) leaves ``p`` and
        running stats ``s``: ``(out, new running stats)``."""
        new: Dict[str, torch.Tensor] = {}
        stride = blk.stride
        tags = ("1", "2", "3") if blk.kind == "bottleneck" else ("1", "2")
        # The striding conv: conv1 of a basic block, conv2 of a bottleneck.
        strided = "2" if blk.kind == "bottleneck" else "1"
        h = x
        for tag in tags:
            st = stride if tag == strided else 1
            if blk.nf:
                h = L.conv2d_nchw(h, _ws(p[f"conv{tag}"], p[f"g{tag}"]),
                                  stride=st) + _chan(p[f"c{tag}"])
            else:
                h = self._bn(L.conv2d_nchw(h, p[f"conv{tag}"], stride=st),
                             p, s, f"bn{tag}", new)
            if tag != blk.last:
                h = F.relu(h)
        if blk.has_proj:
            if blk.nf:
                x = L.conv2d_nchw(x, _ws(p["proj"], p["gp"]),
                                  stride=stride) + _chan(p["cp"])
            else:
                x = self._bn(L.conv2d_nchw(x, p["proj"], stride=stride),
                             p, s, "proj_bn", new)
        if blk.nf:
            h = p["skip_gain"] * h
        return F.relu(x + h), new

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images → logits [B, num_classes] (float32)."""
        cfg = self.cfg
        cdt = _DTYPES[cfg.compute_dtype]
        x = images.to(cdt)
        stem = {n: t.to(cdt) for n, t in self.stem.named_parameters()}
        w = _ws(stem["conv"], stem["g"]) if self.nf else stem["conv"]
        if self.s2d:
            b, hh, ww, c = x.shape
            x = x.reshape(b, hh // 2, 2, ww // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, hh // 2, ww // 2, 4 * c)
            x = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (1, 2, 1, 2)), w)
        else:
            # Contiguous NCHW: a permuted view is channels_last in memory,
            # and cuDNN would hand back channels_last kernel gradients.
            x = L.conv2d_nchw(x.permute(0, 3, 1, 2).contiguous(), w,
                              stride=2 if self.imagenet_stem else 1)
        if self.nf:
            x = x + _chan(stem["c"])
        else:
            new: Dict[str, torch.Tensor] = {}
            s = dict(self.stem.named_buffers())
            x = self._bn(x, stem, s, "bn", new)
            self._write(s, new)
        x = F.relu(x)
        if self.imagenet_stem:
            x = L.max_pool_nchw(x)
        for stage in self.stages():
            for blk in stage:
                p = {n: t.to(cdt) for n, t in blk.named_parameters()}
                s = dict(blk.named_buffers())
                if cfg.remat:
                    # No RNG state: restoring the card's generator is
                    # refused inside a CUDA graph capture.
                    x, new = checkpoint(self._block, x, p, s, blk,
                                        use_reentrant=False,
                                        preserve_rng_state=False)
                else:
                    x, new = self._block(x, p, s, blk)
                self._write(s, new)
        x = x.mean(dim=(2, 3))                    # global average pool
        logits = L.dense(x, self.fc.kernel.to(cdt), self.fc.bias.to(cdt))
        if cfg.logit_relu:   # shared faithful-mode switch (cifar10cnn.py:145)
            logits = F.relu(logits)
        return logits.float()

    def _write(self, buffers: Dict[str, torch.Tensor],
               new: Dict[str, torch.Tensor]) -> None:
        """Train mode: a block's new running stats into its buffers, in
        place (whatever tensors ``functional_call`` put there)."""
        if self.training:
            with torch.no_grad():
                for name, t in buffers.items():
                    t.copy_(new[name])


def depth_of(name: str) -> int:
    """The depth a model name asks for: ``resnet18`` -> 18."""
    depth = int(name[len("resnet"):]) if name.startswith("resnet") \
        and name[len("resnet"):].isdigit() else None
    if depth not in STAGES:
        raise ValueError(f"unsupported resnet {name!r}; have "
                         f"{['resnet%d' % d for d in sorted(STAGES)]}")
    return depth


def param_count(model: nn.Module) -> int:
    return sum(math.prod(p.shape) for p in model.parameters())
