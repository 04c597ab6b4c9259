"""Fixed-length CIFAR record decoding on the host (numpy).

A copy of ``dml_cnn_cifar10_tpu/data/records.py`` for the port: read
bytes → ``[N, record_bytes]`` view → label byte + CHW uint8 image → HWC
(``cifar10cnn.py:54-70``). Crop/augmentation happen batched in the
pipeline. Every function must give the same array as the JAX package's
for the same inputs and the same ``np.random.Generator`` state
(``tests/test_torch_data.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from dml_cnn_cifar10_tpu_torch.config import DataConfig


def read_record_file(path: str, record_bytes: int) -> np.ndarray:
    """Read a binary shard into a ``[N, record_bytes]`` uint8 array.
    Trailing partial records are dropped, like the fixed-length reader."""
    raw = np.fromfile(path, dtype=np.uint8)
    n = raw.size // record_bytes
    return raw[: n * record_bytes].reshape(n, record_bytes)


def decode_records(records: np.ndarray, cfg: DataConfig,
                   label_offset: int = 0, dtype=np.float32
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 records → (images [N,H,W,C] ``dtype``, labels [N] int32).

    Mirrors ``read_cifar_files`` (``cifar10cnn.py:54-66``): byte
    ``label_offset`` is the label, the remaining bytes are a CHW image
    transposed to HWC.
    """
    nlb = records.shape[1] - cfg.image_height * cfg.image_width * cfg.num_channels
    labels = records[:, label_offset].astype(np.int32)
    chw = records[:, nlb:].reshape(
        -1, cfg.num_channels, cfg.image_height, cfg.image_width)
    # order="C": a strided (transposed) layout makes every later gather
    # and host->device copy a strided copy.
    images = chw.transpose(0, 2, 3, 1).astype(dtype, order="C")
    return images, labels


def center_crop(images: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Deterministic center crop (pad if smaller) — parity with
    ``tf.image.resize_image_with_crop_or_pad`` (``cifar10cnn.py:68``),
    which floors the top/left offset."""
    n, h, w, c = images.shape
    if out_h > h or out_w > w:
        ph, pw = max(out_h - h, 0), max(out_w - w, 0)
        images = np.pad(
            images,
            ((0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2), (0, 0)),
        )
        n, h, w, c = images.shape
    top, left = (h - out_h) // 2, (w - out_w) // 2
    return images[:, top : top + out_h, left : left + out_w, :]


def random_crop(images: np.ndarray, out_h: int, out_w: int,
                rng: np.random.Generator) -> np.ndarray:
    """Per-image random crop (the augmentation the reference's comment at
    ``cifar10cnn.py:67`` intended; ``DataConfig.random_crop``)."""
    n, h, w, _ = images.shape
    tops = rng.integers(0, h - out_h + 1, size=n)
    lefts = rng.integers(0, w - out_w + 1, size=n)
    windows = np.lib.stride_tricks.sliding_window_view(
        images, (out_h, out_w), axis=(1, 2)
    )  # [N, h-out_h+1, w-out_w+1, C, out_h, out_w]
    out = windows[np.arange(n), tops, lefts]  # [N, C, out_h, out_w]
    return np.ascontiguousarray(out.transpose(0, 2, 3, 1))


def random_flip(images: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Per-image horizontal flip with p=0.5."""
    flip = rng.random(images.shape[0]) < 0.5
    images = images.copy()
    images[flip] = images[flip, :, ::-1, :]
    return images


def normalize(images: np.ndarray, mode: str) -> np.ndarray:
    """Pixel normalization (``DataConfig.normalize``). "standardize"
    matches ``tf.image.per_image_standardization``: per-image zero mean,
    divide by ``max(stddev, 1/sqrt(num_pixels))``."""
    if mode == "none":
        return images
    if mode == "scale":
        return images / np.float32(255.0)
    if mode == "standardize":
        n = np.float32(images[0].size)
        mean = images.mean(axis=(1, 2, 3), keepdims=True)
        std = images.std(axis=(1, 2, 3), keepdims=True)
        return (images - mean) / np.maximum(std, 1.0 / np.sqrt(n))
    raise ValueError(f"unknown normalize mode {mode!r}")
