"""Dataset files: the CIFAR-10 shard layout plus the offline synthetic mode.

The port's slice reads the CIFAR-10 binary layout (``cifar10cnn.py:34-52``)
from ``<data_dir>/cifar-10-batches-bin``. ``synthetic`` writes files in
that exact layout, byte-identical to the JAX package's generator for the
same seed, so both packages train on the same bytes. Downloading the real
archive is not ported yet: a missing CIFAR-10 split raises and names the
synthetic mode.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from dml_cnn_cifar10_tpu_torch.config import DataConfig

CIFAR10_FOLDER = "cifar-10-batches-bin"   # extract_folder (cifar10cnn.py:27)


def train_files(cfg: DataConfig) -> List[str]:
    """Training shards: ``data_batch_{1..5}.bin`` (cifar10cnn.py:78)."""
    if cfg.dataset in ("cifar10", "synthetic"):
        base = os.path.join(cfg.data_dir, CIFAR10_FOLDER)
        return [os.path.join(base, f"data_batch_{i}.bin") for i in range(1, 6)]
    raise NotImplementedError(
        f"dataset {cfg.dataset!r} is not ported yet (ROADMAP.md Queue 1); "
        "use cifar10 or synthetic")


def test_files(cfg: DataConfig) -> List[str]:
    """Test shard: ``test_batch.bin`` (cifar10cnn.py:80)."""
    if cfg.dataset in ("cifar10", "synthetic"):
        return [os.path.join(cfg.data_dir, CIFAR10_FOLDER, "test_batch.bin")]
    raise NotImplementedError(
        f"dataset {cfg.dataset!r} is not ported yet (ROADMAP.md Queue 1); "
        "use cifar10 or synthetic")


def generate_synthetic_dataset(cfg: DataConfig, seed: int = 0) -> None:
    """Write CIFAR-layout binary files with class-separable random images.

    Byte layout per record is the real dataset's (label byte + CHW uint8
    image, ``cifar10cnn.py:24-25,58-62``): Gaussian noise around a
    per-class mean color, so a real model can fit them. The draws are the
    JAX package's, in the same order, so the bytes are identical.
    """
    rng = np.random.default_rng(seed)
    img_len = cfg.image_height * cfg.image_width * cfg.num_channels
    # One class→color table for the WHOLE dataset (train and test shards
    # must share it or nothing generalizes).
    means = rng.integers(30, 226, size=(cfg.num_classes, cfg.num_channels))

    def write(path: str, n: int) -> None:
        # Reuse only a file of exactly the requested geometry and count.
        want_bytes = n * (1 + img_len)
        if os.path.isfile(path) and os.path.getsize(path) == want_bytes:
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            step = max(1, min(n, (64 << 20) // max(img_len, 1)))
            for lo in range(0, n, step):
                m = min(step, n - lo)
                labels = rng.integers(0, cfg.num_classes, size=m,
                                      dtype=np.int32)
                recs = np.empty((m, 1 + img_len), dtype=np.uint8)
                recs[:, 0] = labels.astype(np.uint8)
                chw = rng.normal(
                    means[labels][:, :, None, None], 40.0,
                    size=(m, cfg.num_channels, cfg.image_height,
                          cfg.image_width)).astype(np.float32)
                recs[:, 1:] = np.clip(chw, 0, 255).astype(
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
    ``cifar10cnn.py:34-52``): synthesize them in ``synthetic`` mode,
    otherwise require the extracted CIFAR-10 files."""
    if cfg.dataset == "synthetic":
        generate_synthetic_dataset(cfg, seed=cfg.seed)
        return
    missing = [p for p in train_files(cfg) + test_files(cfg)
               if not os.path.isfile(p)]
    if missing:
        raise FileNotFoundError(
            f"CIFAR-10 shards missing under {cfg.data_dir} ({missing[0]} "
            "...); the port does not download yet — extract "
            "cifar-10-binary.tar.gz there or use --dataset synthetic")
