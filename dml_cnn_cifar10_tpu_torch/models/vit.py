"""ViT-Tiny as an ``nn.Module`` — the attention rung of the config ladder.

Port of ``dml_cnn_cifar10_tpu/models/vit.py``: conv patch embed → +cls
token → learned positional embedding → ``depth`` pre-LN transformer blocks
(MHA + 4× GELU MLP) → final LN → linear head on the cls token (or the
token mean). ViT-Ti geometry by default (``ModelConfig``): patch 4, dim
192, depth 12, 3 heads. Attention goes through
:func:`ops.attention.dispatch_attention`: the hand-written CUDA flash
kernels from 128 tokens up, the dense path below.

Parameters keep the JAX package's leaf names AND layouts (patch kernel
HWIO, dense kernels ``[in, out]``), and the per-block leaves stay
**stacked** with a leading ``[depth]`` axis (``blocks.qkv.kernel`` is
``[depth, dim, 3·dim]``), so checkpoints interchange with no transpose
(``convert.py`` passes every ViT leaf through). A Python loop over the
blocks takes the place of ``lax.scan``; ``remat`` wraps each block in
``torch.utils.checkpoint(use_reentrant=False)``, so the backward recomputes
the block (and its attention forward) instead of storing it.

Parity traps, mirrored on purpose:
- GELU is ``jax.nn.gelu``'s default tanh approximation (``vit.py:159``).
- LayerNorm has eps 1e-6 and a biased variance (``vit.py:44-47``).
- The fused qkv output is heads-major: ``[heads][q|k|v][head_dim]``
  (``vit.py:127``); q, k and v are strided views the kernels read as is.
- The patch embed flattens its NHWC output row-major over (ph, pw)
  (``vit.py:205-208``); cls is prepended before ``pos`` is added.
- EVERY param, LayerNorm included, is cast to ``compute_dtype`` before use
  (``vit.py:200-202``) — explicit casts, not autocast; logits return f32.

Sequence parallelism (``vit.py:184-226``): with a mesh whose ``seq`` > 1
the patches are embedded and ``pos`` added on the full image, each rank
keeps its ``S/seq`` token slice through the blocks, attention runs over
the seq ranks by ``ModelConfig.sp_mode`` — ``"ring"`` (K/V shards walk
the ring, ``parallel/ring_attention.py``) or ``"ulysses"`` (a
tokens-to-heads all-to-all around full-sequence attention,
``parallel/ulysses.py``, which needs ``heads % seq == 0``) — and the
mean pool sums the token slices with a differentiable all-reduce. That
needs ``pool="mean"`` (a cls token breaks even seq sharding) and a token
count the seq ranks divide.

Tensor parallelism (a mesh with ``model`` > 1, ``parallel/tp.py``): in
every block ``qkv`` and ``mlp1`` are column-parallel (their inputs pass
``copy_to_model``), ``proj`` and ``mlp2`` row-parallel (their partial
products pass ``reduce_from_model``, then the replicated bias is added
once). The qkv columns are heads-major, so a model rank's contiguous
``1/M`` of them is ``vit_heads / M`` whole heads, which its attention
runs on (``vit_heads % M`` must be 0), and ``proj`` takes their
``dim / M`` outputs. Under ``remat`` the recompute replays the forward's
all-reduces. Tensor parallelism with sequence parallelism is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
from dml_cnn_cifar10_tpu_torch.ops import attention as attn
from dml_cnn_cifar10_tpu_torch.ops import layers as L
from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
from dml_cnn_cifar10_tpu_torch.parallel import ring_attention as ring
from dml_cnn_cifar10_tpu_torch.parallel import tp
from dml_cnn_cifar10_tpu_torch.parallel import ulysses

MLP_RATIO = 4
SP_MODES = ("ring", "ulysses")
LN_EPS = 1e-6
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Per-block leaves (module, leaf); kernels are He-normal initialised.
_BLOCK_LEAVES = (("ln1", "scale"), ("ln1", "bias"), ("qkv", "kernel"),
                 ("qkv", "bias"), ("proj", "kernel"), ("proj", "bias"),
                 ("ln2", "scale"), ("ln2", "bias"), ("mlp1", "kernel"),
                 ("mlp1", "bias"), ("mlp2", "kernel"), ("mlp2", "bias"))


class _Leaves(nn.Module):
    """A group of named parameters of the given shapes."""

    def __init__(self, dtype: torch.dtype, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(
                name, nn.Parameter(torch.empty(shape, dtype=dtype)))


class ViT(nn.Module):
    def __init__(self, cfg: ModelConfig, data: DataConfig,
                 mesh: Optional[mesh_lib.Mesh] = None):
        super().__init__()
        self.cfg = cfg
        # The ring runs when the mesh has seq ranks; a mesh without (data
        # parallelism alone) leaves the forward as it is.
        self.mesh = mesh if mesh is not None and mesh.seq > 1 else None
        # The model ranks' mesh (tensor parallelism), or None.
        self.tp_mesh = mesh if mesh is not None and mesh.model > 1 else None
        if self.tp_mesh is not None and self.mesh is not None:
            raise NotImplementedError(
                f"tensor parallelism (model_axis={mesh.model}) with "
                f"sequence parallelism (seq_axis={mesh.seq}) is not "
                f"ported; see {tp.ROADMAP}")
        dim, depth, p = cfg.vit_dim, cfg.vit_depth, cfg.patch_size
        ph, pw = data.crop_height // p, data.crop_width // p
        if ph * p != data.crop_height or pw * p != data.crop_width:
            raise ValueError(
                f"input {data.crop_height}x{data.crop_width} not divisible "
                f"by patch_size={p}")
        if cfg.pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got "
                             f"{cfg.pool!r}")
        if dim % cfg.vit_heads:
            raise ValueError(f"vit_dim {dim} is not divisible by vit_heads "
                             f"{cfg.vit_heads}")
        model = 1 if self.tp_mesh is None else self.tp_mesh.model
        tp.check_heads(cfg.vit_heads, model)
        self.local_heads = cfg.vit_heads // model
        self.seq = ph * pw + (1 if cfg.pool == "cls" else 0)
        if self.mesh is not None:
            if cfg.sp_mode not in SP_MODES:
                raise ValueError(f"unknown sp_mode {cfg.sp_mode!r}; have "
                                 f"{SP_MODES}")
            if cfg.sp_mode == "ulysses":
                ulysses.check_heads(cfg.vit_heads, self.mesh.seq)
            if cfg.pool != "mean":
                raise ValueError(
                    "sequence parallelism needs pool='mean' (a cls token "
                    "breaks even seq sharding)")
            if self.seq % self.mesh.seq:
                raise ValueError(f"{self.seq} tokens not divisible by seq "
                                 f"axis {self.mesh.seq}")
        dt = _DTYPES[cfg.dtype]
        hidden = dim * MLP_RATIO
        self.patch = _Leaves(dt, kernel=(p, p, data.num_channels, dim),
                             bias=(dim,))
        self.pos = nn.Parameter(torch.empty((1, self.seq, dim), dtype=dt))
        self.blocks = nn.Module()
        for name, (fan_in, width) in (("qkv", (dim, 3 * dim)),
                                      ("proj", (dim, dim)),
                                      ("mlp1", (dim, hidden)),
                                      ("mlp2", (hidden, dim))):
            setattr(self.blocks, name, _Leaves(
                dt, kernel=(depth, fan_in, width), bias=(depth, width)))
        for name in ("ln1", "ln2"):
            setattr(self.blocks, name, _Leaves(dt, scale=(depth, dim),
                                               bias=(depth, dim)))
        self.ln_f = _Leaves(dt, scale=(dim,), bias=(dim,))
        self.head = _Leaves(dt, kernel=(dim, cfg.num_classes),
                            bias=(cfg.num_classes,))
        if cfg.pool == "cls":
            self.cls = nn.Parameter(torch.zeros((1, 1, dim), dtype=dt))
        self.split = None if self.tp_mesh is None else tp.megatron_split(
            self, "vit_tiny", self.tp_mesh)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> None:
        """He-normal patch/qkv/proj/mlp kernels (each block's slice on its
        own fan-in), ``0.02·N(0,1)`` pos, ``0.01·N(0,1)`` head kernel,
        LayerNorm scales 1, zeros for cls and every bias; under tensor
        parallelism the whole leaves, of which this rank keeps its
        slices."""
        targets = tp.init_targets(self, self.split)
        L.he_normal_(self.patch.kernel, generator)
        self.pos.normal_(0.0, 0.02, generator=generator)
        for mod, leaf in _BLOCK_LEAVES:
            t = targets[f"blocks.{mod}.{leaf}"]
            if leaf == "kernel":
                for block in t:
                    L.he_normal_(block, generator)
            else:
                t.fill_(1.0 if leaf == "scale" else 0.0)
        self.head.kernel.normal_(0.0, 0.01, generator=generator)
        for t in (self.patch.bias, self.ln_f.bias, self.head.bias):
            t.zero_()
        self.ln_f.scale.fill_(1.0)
        if self.cfg.pool == "cls":
            self.cls.zero_()
        tp.keep_slices(self, self.split, targets)

    def _block(self, x: torch.Tensor, p) -> torch.Tensor:
        cfg = self.cfg
        b, s, dim = x.shape
        h = F.layer_norm(x, (dim,), p["ln1.scale"], p["ln1.bias"], LN_EPS)
        if self.tp_mesh is not None:
            return self._block_tp(x, h, p)
        qkv = L.dense(h, p["qkv.kernel"], p["qkv.bias"])
        qkv = qkv.reshape(b, s, cfg.vit_heads, 3, dim // cfg.vit_heads)
        q, k, v = qkv.unbind(3)                       # heads-major
        if self.mesh is None:
            o = attn.dispatch_attention(q, k, v, causal=cfg.attn_causal,
                                        window=cfg.attn_window)
        elif cfg.sp_mode == "ulysses":
            o = ulysses.ulysses_attention_local(q, k, v, self.mesh,
                                                causal=cfg.attn_causal,
                                                window=cfg.attn_window)
        elif cfg.sp_mode == "ring":
            o = ring.ring_attention_local(q, k, v, self.mesh,
                                          causal=cfg.attn_causal,
                                          window=cfg.attn_window)
        else:
            raise ValueError(f"unknown sp_mode {cfg.sp_mode!r}")
        x = x + L.dense(o.reshape(b, s, dim), p["proj.kernel"],
                        p["proj.bias"])
        h = F.layer_norm(x, (dim,), p["ln2.scale"], p["ln2.bias"], LN_EPS)
        h = F.gelu(L.dense(h, p["mlp1.kernel"], p["mlp1.bias"]),
                   approximate="tanh")
        return x + L.dense(h, p["mlp2.kernel"], p["mlp2.bias"])

    def _block_tp(self, x: torch.Tensor, h: torch.Tensor, p) -> torch.Tensor:
        """The block on this model rank's heads and MLP columns (``h`` is
        ``ln1(x)``): the column-parallel layers see ``copy_to_model`` of
        their input, the row-parallel ones' partial products are summed
        over the model ranks before their bias."""
        cfg, mesh = self.cfg, self.tp_mesh
        b, s, dim = x.shape
        hd = dim // cfg.vit_heads
        qkv = L.dense(mesh_lib.copy_to_model(h, mesh), p["qkv.kernel"],
                      p["qkv.bias"])
        q, k, v = qkv.reshape(b, s, self.local_heads, 3, hd).unbind(3)
        o = attn.dispatch_attention(q, k, v, causal=cfg.attn_causal,
                                    window=cfg.attn_window)
        o = L.dense(o.reshape(b, s, self.local_heads * hd), p["proj.kernel"],
                    None)
        x = x + (mesh_lib.reduce_from_model(o, mesh) + p["proj.bias"])
        h = F.layer_norm(x, (dim,), p["ln2.scale"], p["ln2.bias"], LN_EPS)
        h = F.gelu(L.dense(mesh_lib.copy_to_model(h, mesh), p["mlp1.kernel"],
                           p["mlp1.bias"]), approximate="tanh")
        h = L.dense(h, p["mlp2.kernel"], None)
        return x + (mesh_lib.reduce_from_model(h, mesh) + p["mlp2.bias"])

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images → logits [B, num_classes] (float32)."""
        cfg = self.cfg
        cdt = _DTYPES[cfg.compute_dtype]
        dim = cfg.vit_dim
        x = images.to(cdt)
        # Patch embed: a VALID stride-patch conv, output NHWC.
        x = L.conv2d(x, self.patch.kernel.to(cdt), stride=cfg.patch_size,
                     padding="VALID") + self.patch.bias.to(cdt)
        b = x.shape[0]
        x = x.reshape(b, -1, dim)
        if cfg.pool == "cls":
            x = torch.cat([self.cls.to(cdt).expand(b, 1, dim), x], dim=1)
        x = x + self.pos.to(cdt)
        if self.mesh is not None:
            x = ring.seq_shard(x, self.mesh, "tokens")
        # One unbind per stacked leaf: its backward stacks the per-block
        # gradients in one op.
        stacked = {f"{mod}.{leaf}": getattr(getattr(self.blocks, mod), leaf)
                   .to(cdt).unbind(0) for mod, leaf in _BLOCK_LEAVES}
        for i in range(cfg.vit_depth):
            p = {name: t[i] for name, t in stacked.items()}
            if cfg.remat:
                # A block draws no random numbers, so there is no RNG
                # state to stash: restoring the card's generator state is
                # refused inside a CUDA graph capture, and a chunk captures
                # the remat backward.
                x = checkpoint(self._block, x, p, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = self._block(x, p)
        x = F.layer_norm(x, (dim,), self.ln_f.scale.to(cdt),
                         self.ln_f.bias.to(cdt), LN_EPS)
        if self.mesh is not None:
            # The mean over every rank's tokens: an f32 sum of the local
            # slice, summed over the seq ranks (gradient summed back).
            pooled = (mesh_lib.all_reduce_sum(x.float().sum(dim=1),
                                              self.mesh, "seq")
                      / self.seq).to(cdt)
        else:
            pooled = x.mean(dim=1) if cfg.pool == "mean" else x[:, 0]
        logits = L.dense(pooled, self.head.kernel.to(cdt),
                         self.head.bias.to(cdt))
        if cfg.logit_relu:   # shared faithful-mode switch (cifar10cnn.py:145)
            logits = F.relu(logits)
        return logits.float()


def param_count(model: nn.Module) -> int:
    """Total parameter count (the JAX package's ``models.param_count``)."""
    return sum(math.prod(p.shape) for p in model.parameters())
