"""Device-side input preprocessing (cast / crop / augment / normalize).

Port of ``dml_cnn_cifar10_tpu/ops/preprocess.py``. The host ships raw
uint8 bytes (or nothing, on the resident path) and the device does the
math: the chunked training path (``parallel/step.py:make_train_chunk*``)
decodes its whole ``[K, B, H, W, C]`` chunk with :func:`device_preprocess`
before its K steps, and the resident evals decode each batch with it.
Plain tensor operations, on the card inside the captured chunk.

Center crop (with pad-if-smaller), the uint8→f32 cast and the ``none`` and
``scale`` modes are exact against the JAX function. ``standardize`` has an
exact mean (a sum of integers below 2^24) but its f32 standard deviation
is torch's, correctly rounded, where XLA's sums the squared deviations in
another order: the two differ in the last bits (``tests/
test_torch_preprocess.py`` states the tolerance).

Augmentations (``random_crop``, ``random_flip``, ``random_brightness``,
``random_contrast``, in the JAX function's order: crop, flip, brightness,
contrast, then normalize). A crop and a flip select exact pixels by
index: a crop is a window of its source and a flip its mirror, as in the
JAX function's one-hot products. Brightness adds a per-image delta and
contrast scales each channel's deviation from its mean by a per-image
factor (:func:`brightness`, :func:`contrast`, the JAX function's math
given the same per-image values; the channel mean is a float32 sum whose
order differs from XLA's, so contrast agrees to the last bits, as
``standardize`` does: ``tests/test_torch_augment.py`` states the
tolerance). Their draws cannot be the JAX package's threefry bits; they
are a counter-based hash (the port's ``device_stream._mix``) of (data
seed, the image's global step, its index in its batch, one salt a draw),
so they are deterministic, the same on the CPU and the card, and need no
host seed inside a captured graph; a brightness or contrast value takes
the hash's top 24 bits as a float32 in [0, 1) mapped onto its range. A
``[K, B, ...]`` chunk decoded at ``step`` draws batch ``k`` at ``step +
k``: the chunk decodes exactly as its K batches would one step at a time.
A data rank that decodes its own columns of a global batch passes their
first index (``col0``), so each image draws as it would in the whole
batch.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from dml_cnn_cifar10_tpu_torch.config import DataConfig
from dml_cnn_cifar10_tpu_torch.data.device_stream import (_C0, _C1, _M32,
                                                          _mix, _mul32)

# Salts of the draws an image takes (at most _SALTS of them).
_TOP, _LEFT, _FLIP, _BRIGHT, _CONTRAST = 0, 1, 2, 3, 4
_SALTS = 8
# 2^-24: a float32 in [0, 1) from the top 24 bits of a draw, exactly.
_U24 = 1.0 / (1 << 24)


def device_preprocess(images_u8: torch.Tensor, cfg: DataConfig,
                      step: Optional[torch.Tensor] = None,
                      col0: int = 0) -> torch.Tensor:
    """uint8 ``[..., B, H, W, C]`` full-size images → float32
    ``[..., B, crop_h, crop_w, C]``, cropped/augmented and normalized per
    ``cfg``: the device-side mirror of the host pipeline's ``_finish``.
    A randomized augmentation (``cfg.augmented``) draws at global ``step``
    (an int or a 0-d integer tensor; leading index ``k`` of a ``[K, B]``
    chunk draws at ``step + k``) and raises without one; image ``i`` of a
    batch draws as image ``col0 + i`` of the global batch."""
    if cfg.augmented and step is None:
        raise ValueError(
            "random crop/flip/brightness/contrast on the device draw from "
            "the global step; pass step= or use the host pipeline")
    x = images_u8
    if cfg.random_crop:
        x = _random_crop(x, cfg, step, col0, flip=cfg.random_flip)
    else:
        x = _center_crop(x, cfg)
        if cfg.random_flip:
            x = _random_flip(x, cfg, step, col0)
    x = x.to(torch.float32)
    lead = x.shape[:-3]
    if cfg.random_brightness:
        b = float(cfg.random_brightness)
        u = _uniform(cfg, step, col0, lead, _BRIGHT, x.device)
        x = brightness(x, u * (2.0 * b) - b)
    if cfg.random_contrast:
        c = float(cfg.random_contrast)
        u = _uniform(cfg, step, col0, lead, _CONTRAST, x.device)
        x = contrast(x, u * (2.0 * c) + (1.0 - c))
    return _normalize(x, cfg)


def brightness(x: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """``x`` [..., B, H, W, C] float32 plus one delta an image
    (``deltas`` [..., B]): JAX ``_random_brightness`` given its deltas."""
    return x + deltas[..., None, None, None]


def contrast(x: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Each image's per-channel deviation from its mean over H, W scaled
    by its factor (``factors`` [..., B]): JAX ``_random_contrast`` given
    its factors."""
    mean = x.mean(dim=(-3, -2), keepdim=True)
    return (x - mean) * factors[..., None, None, None] + mean


def _draws(cfg: DataConfig, step, col0: int, lead, salt: int,
           device: torch.device) -> torch.Tensor:
    """One uint32 (in an int64) per image of leading shape ``lead``
    (``[..., B]``): a hash of (seed, image's global step, its index in the
    global batch, which is ``col0`` + its index here, salt)."""
    b = lead[-1] if lead else 1
    r = torch.arange(math.prod(lead), dtype=torch.int64, device=device)
    if isinstance(step, torch.Tensor):
        step = step.to(device=device, dtype=torch.int64)
    steps = (step + r // b) & _M32
    key = _mix(((cfg.seed & _M32) * _C0 & _M32) ^ _mul32(steps, _C1))
    return _mix(key ^ _mix((r % b + col0) * _SALTS + salt))


def _uniform(cfg: DataConfig, step, col0: int, lead, salt: int,
             device: torch.device) -> torch.Tensor:
    """One float32 in [0, 1) per image of leading shape ``lead``: the top
    24 bits of its draw."""
    bits = _draws(cfg, step, col0, lead, salt, device) >> 8
    return (bits.to(torch.float32) * _U24).reshape(lead)


def _center_crop(x: torch.Tensor, cfg: DataConfig) -> torch.Tensor:
    h, w = x.shape[-3], x.shape[-2]
    if cfg.crop_height > h or cfg.crop_width > w:
        # Pad-if-smaller, as the host records.center_crop
        # (tf.image.resize_image_with_crop_or_pad).
        ph, pw = max(cfg.crop_height - h, 0), max(cfg.crop_width - w, 0)
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        h, w = x.shape[-3], x.shape[-2]
    oh, ow = (h - cfg.crop_height) // 2, (w - cfg.crop_width) // 2
    return x[..., oh:oh + cfg.crop_height, ow:ow + cfg.crop_width, :]


def _random_crop(x: torch.Tensor, cfg: DataConfig, step, col0: int,
                 flip: bool) -> torch.Tensor:
    """Per-image random window, with the optional horizontal flip folded
    into its column indices (the JAX function's formulation: a flipped
    image's crop at offset ``left`` reads columns ``w-1-left-j``)."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    ch, cw = cfg.crop_height, cfg.crop_width
    if ch > h or cw > w:
        raise ValueError(f"random crop {ch}x{cw} is larger than the "
                         f"{h}x{w} images")
    flat = x.reshape(-1, h, w, c)
    dev = x.device
    tops = _draws(cfg, step, col0, lead, _TOP, dev) % (h - ch + 1)
    lefts = _draws(cfg, step, col0, lead, _LEFT, dev) % (w - cw + 1)
    rows = tops[:, None] + torch.arange(ch, device=dev)        # [N, ch]
    cols = lefts[:, None] + torch.arange(cw, device=dev)       # [N, cw]
    if flip:
        flipped = (_draws(cfg, step, col0, lead, _FLIP, dev) & 1).bool()
        cols = torch.where(flipped[:, None],
                           (w - 1 - lefts)[:, None]
                           - torch.arange(cw, device=dev), cols)
    n = torch.arange(flat.shape[0], device=dev)
    out = flat[n[:, None, None], rows[:, :, None], cols[:, None, :]]
    return out.reshape(lead + (ch, cw, c))


def _random_flip(x: torch.Tensor, cfg: DataConfig, step,
                 col0: int) -> torch.Tensor:
    """Per-image horizontal flip with p = 1/2."""
    lead = x.shape[:-3]
    flat = x.reshape(-1, *x.shape[-3:])
    flipped = (_draws(cfg, step, col0, lead, _FLIP, x.device) & 1).bool()
    out = torch.where(flipped[:, None, None, None], flat.flip(-2), flat)
    return out.reshape(x.shape)


def _normalize(x: torch.Tensor, cfg: DataConfig) -> torch.Tensor:
    if cfg.normalize == "scale":
        return x / 255.0
    if cfg.normalize == "standardize":
        dims = (-3, -2, -1)
        mean = x.mean(dim=dims, keepdim=True)
        # jnp.std is the population std: correction 0, not torch's
        # default unbiased one.
        std = x.std(dim=dims, correction=0, keepdim=True)
        # tf.image.per_image_standardization's floor 1/sqrt(n), rounded
        # in f32 as the JAX function computes it (a host constant: no
        # copy to the device inside a captured graph).
        n = cfg.crop_height * cfg.crop_width * x.shape[-1]
        floor = float(np.float32(1.0) / np.sqrt(np.float32(n)))
        return (x - mean) / std.clamp(min=floor)
    if cfg.normalize != "none":
        raise ValueError(f"unknown normalize mode {cfg.normalize!r}")
    return x
