"""Dataset files: the CIFAR shard layouts plus the offline synthetic modes.

The port reads the CIFAR-10 binary layout (``cifar10cnn.py:34-52``) from
``<data_dir>/cifar-10-batches-bin`` and CIFAR-100's (two label bytes,
coarse then fine) from ``<data_dir>/cifar-100-binary``. ``synthetic``
writes files in the CIFAR-10 layout and ``imagenet_synth`` (generate-only:
ImageNet has no fixed-length binary distribution) ImageNet-shaped shards
whose records lead with a big-endian uint16 label; both are byte-identical
to the JAX package's generator for the same seed, so both packages train
on the same bytes. Nothing is downloaded: a missing CIFAR split raises the
JAX package's classified :class:`DownloadError` (fault ``"network"``),
where the JAX package would fetch, and names the synthetic modes.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from dml_cnn_cifar10_tpu_torch.config import DataConfig

CIFAR10_FOLDER = "cifar-10-batches-bin"   # extract_folder (cifar10cnn.py:27)
CIFAR100_FOLDER = "cifar-100-binary"
# The ImageNet-shaped synthetic rung (BASELINE.json "ResNet-50 on
# ImageNet-1k"): the fixed-length framing at configurable geometry with a
# 2-byte big-endian label (1000 classes do not fit one byte).
IMAGENET_SYNTH_FOLDER = "imagenet-synth-bin"
DATASETS = ("cifar10", "cifar100", "synthetic", "imagenet_synth")


class DownloadError(RuntimeError):
    """Dataset acquisition failed. ``fault`` names the class, as in the
    JAX package: ``"network"`` (nothing reachable; the port never
    fetches) or ``"integrity"``."""

    def __init__(self, fault: str, msg: str):
        super().__init__(msg)
        self.fault = fault


def _check(cfg: DataConfig) -> None:
    if cfg.dataset not in DATASETS:
        raise ValueError(f"unknown dataset {cfg.dataset!r}; have "
                         f"{list(DATASETS)}")


def train_files(cfg: DataConfig) -> List[str]:
    """Training shards: CIFAR-10 ``data_batch_{1..5}.bin``
    (cifar10cnn.py:78), CIFAR-100 ``train.bin``, imagenet_synth
    ``train_{1..4}.bin``."""
    _check(cfg)
    if cfg.dataset == "cifar100":
        return [os.path.join(cfg.data_dir, CIFAR100_FOLDER, "train.bin")]
    if cfg.dataset == "imagenet_synth":
        base = os.path.join(cfg.data_dir, IMAGENET_SYNTH_FOLDER)
        return [os.path.join(base, f"train_{i}.bin") for i in range(1, 5)]
    base = os.path.join(cfg.data_dir, CIFAR10_FOLDER)
    return [os.path.join(base, f"data_batch_{i}.bin") for i in range(1, 6)]


def test_files(cfg: DataConfig) -> List[str]:
    """Test shard: ``test_batch.bin`` (cifar10cnn.py:80), CIFAR-100's
    ``test.bin``, imagenet_synth's ``val.bin``."""
    _check(cfg)
    if cfg.dataset == "cifar100":
        return [os.path.join(cfg.data_dir, CIFAR100_FOLDER, "test.bin")]
    if cfg.dataset == "imagenet_synth":
        return [os.path.join(cfg.data_dir, IMAGENET_SYNTH_FOLDER, "val.bin")]
    return [os.path.join(cfg.data_dir, CIFAR10_FOLDER, "test_batch.bin")]


def label_bytes(cfg: DataConfig) -> int:
    """CIFAR-10 records lead with 1 label byte; CIFAR-100 with 2
    (coarse + fine); imagenet_synth with 2 (one big-endian uint16)."""
    return 2 if cfg.dataset in ("cifar100", "imagenet_synth") else 1


def wide_label(cfg: DataConfig) -> bool:
    """True when the 2 leading label bytes are ONE big-endian uint16
    rather than CIFAR-100's coarse + fine pair."""
    return cfg.dataset == "imagenet_synth"


def generate_synthetic_dataset(cfg: DataConfig, seed: int = 0) -> None:
    """Write CIFAR-layout binary files with class-separable random images.

    Byte layout per record is the real dataset's (label byte(s) + CHW
    uint8 image, ``cifar10cnn.py:24-25,58-62``): Gaussian noise around a
    per-class mean color, so a real model can fit them. The draws are the
    JAX package's, in the same order, so the bytes are identical.
    """
    rng = np.random.default_rng(seed)
    nlb = label_bytes(cfg)
    wide = wide_label(cfg)
    img_len = cfg.image_height * cfg.image_width * cfg.num_channels
    # One class→color table for the WHOLE dataset (train and test shards
    # must share it or nothing generalizes).
    means = rng.integers(30, 226, size=(cfg.num_classes, cfg.num_channels))

    def write(path: str, n: int) -> None:
        # Reuse only a file of exactly the requested geometry and count.
        want_bytes = n * (nlb + img_len)
        if os.path.isfile(path) and os.path.getsize(path) == want_bytes:
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            # Bounded chunks: one float32 normal draw a chunk.
            step = max(1, min(n, (64 << 20) // max(img_len, 1)))
            for lo in range(0, n, step):
                m = min(step, n - lo)
                labels = rng.integers(0, cfg.num_classes, size=m,
                                      dtype=np.int32)
                recs = np.empty((m, nlb + img_len), dtype=np.uint8)
                if wide:
                    recs[:, 0] = (labels >> 8).astype(np.uint8)
                    recs[:, 1] = (labels & 0xFF).astype(np.uint8)
                else:
                    for lb in range(nlb):
                        # coarse == fine for synthetic CIFAR-100
                        recs[:, lb] = labels.astype(np.uint8)
                chw = rng.normal(
                    means[labels][:, :, None, None], 40.0,
                    size=(m, cfg.num_channels, cfg.image_height,
                          cfg.image_width)).astype(np.float32)
                recs[:, nlb:] = np.clip(chw, 0, 255).astype(
                    np.uint8).reshape(m, img_len)
                f.write(recs.tobytes())
        os.replace(tmp, path)

    per_shard = max(1, cfg.synthetic_train_records // len(train_files(cfg)))
    for path in train_files(cfg):
        write(path, per_shard)
    for path in test_files(cfg):
        write(path, cfg.synthetic_test_records)


def ensure_dataset(cfg: DataConfig) -> None:
    """Make sure the binary shards exist (``download_data``,
    ``cifar10cnn.py:34-52``): synthesize them for ``synthetic`` and
    ``imagenet_synth``, otherwise require the extracted CIFAR files."""
    _check(cfg)
    if cfg.dataset in ("synthetic", "imagenet_synth"):
        generate_synthetic_dataset(cfg, seed=cfg.seed)
        return
    missing = [p for p in train_files(cfg) + test_files(cfg)
               if not os.path.isfile(p)]
    if missing:
        archive = ("cifar-100-binary.tar.gz" if cfg.dataset == "cifar100"
                   else "cifar-10-binary.tar.gz")
        raise DownloadError(
            "network",
            f"{cfg.dataset} shards missing under {cfg.data_dir} "
            f"({missing[0]} ...); the port does not download: extract "
            f"{archive} there, or use --dataset synthetic / "
            f"imagenet_synth")
