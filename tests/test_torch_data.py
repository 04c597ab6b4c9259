"""PyTorch port, data/{download,records,pipeline}.py, against the JAX package.

The port keeps its own numpy copy of the input pipeline. For the same seed
it must write the same synthetic ``.bin`` bytes and draw the same batches
(same numpy draws in the same order), and its eval preprocessing (center
crop, normalize) must be exact.
"""

import os

import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.data import download as jax_download
from dml_cnn_cifar10_tpu.data import pipeline as jax_pipeline
from dml_cnn_cifar10_tpu.data import records as jax_records
from dml_cnn_cifar10_tpu_torch.config import DataConfig
from dml_cnn_cifar10_tpu_torch.data import download, pipeline, records

torch.set_num_threads(2)

_SYNTH = dict(dataset="synthetic", synthetic_train_records=250,
              synthetic_test_records=70)


def _cfgs(tmp_path, seed=3, **kw):
    port = DataConfig(data_dir=str(tmp_path / "port"), seed=seed,
                      **_SYNTH, **kw)
    ref = JaxDataConfig(data_dir=str(tmp_path / "jax"), seed=seed,
                        use_native_loader=False, **_SYNTH, **kw)
    download.ensure_dataset(port)
    jax_download.ensure_dataset(ref)
    return port, ref


def test_synthetic_bytes_identical(tmp_path):
    port, ref = _cfgs(tmp_path)
    files = download.train_files(port) + download.test_files(port)
    ref_files = jax_download.train_files(ref) + jax_download.test_files(ref)
    assert [os.path.basename(f) for f in files] == \
        [os.path.basename(f) for f in ref_files]
    for mine, theirs in zip(files, ref_files):
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            got, want = a.read(), b.read()
        assert len(got) > 0 and got == want, os.path.basename(mine)


@pytest.mark.parametrize("aug", [
    dict(),                                                  # faithful
    dict(random_crop=True, random_flip=True, normalize="standardize"),
    dict(normalize="scale"),
], ids=["faithful", "fixed", "scale"])
def test_shuffle_batches_identical(tmp_path, aug):
    """Three epochs' worth of batches (50 records each, 250 records: the
    reshuffle at every epoch boundary included), then the padded sweep of
    the 70-record test split (two pad rows)."""
    port, ref = _cfgs(tmp_path, **aug)
    mine = pipeline.input_pipeline(port, 50, train=True, seed=11)
    theirs = jax_pipeline.input_pipeline(ref, 50, train=True, seed=11)
    assert isinstance(theirs, jax_pipeline.ShuffleBatchIterator)
    for _ in range(16):
        a, b = next(mine), next(theirs)
        assert a.images.dtype == b.images.dtype == np.float32
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    acc_a, acc_b = mine.clone(seed=18), theirs.clone(seed=18)
    np.testing.assert_array_equal(next(acc_a).images, next(acc_b).images)

    mine = pipeline.input_pipeline(port, 36, train=False, seed=11)
    theirs = jax_pipeline.input_pipeline(ref, 36, train=False, seed=11)
    assert mine.total_records == theirs.total_records == 70
    assert mine.num_padded_sweep_batches() == \
        theirs.num_padded_sweep_batches() == 2
    for a, b in zip(mine.full_sweep_padded(), theirs.full_sweep_padded()):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert (a.labels[-2:] == -1).all()


def test_decode_crop_normalize_exact():
    cfg, ref = DataConfig(), JaxDataConfig()
    rng = np.random.default_rng(5)
    recs = rng.integers(0, 256, size=(6, cfg.record_bytes), dtype=np.uint8)
    recs[:, 0] = rng.integers(0, 10, size=6)
    images, labels = records.decode_records(recs, cfg)
    want_i, want_l = jax_records.decode_records(recs, ref)
    np.testing.assert_array_equal(images, want_i)
    np.testing.assert_array_equal(labels, want_l)
    for out in ((24, 24), (36, 30)):   # crop, and pad-then-crop
        np.testing.assert_array_equal(records.center_crop(images, *out),
                                      jax_records.center_crop(images, *out))
    crop = records.center_crop(images, 24, 24)
    for mode in ("none", "scale", "standardize"):
        np.testing.assert_array_equal(records.normalize(crop, mode),
                                      jax_records.normalize(crop, mode))
    with pytest.raises(ValueError):
        records.normalize(crop, "bogus")


def test_random_augmentations_identical():
    rng_images = np.random.default_rng(6).uniform(
        0, 255, size=(9, 32, 32, 3)).astype(np.float32)
    a, b = np.random.default_rng(8), np.random.default_rng(8)
    np.testing.assert_array_equal(
        records.random_crop(rng_images, 24, 24, a),
        jax_records.random_crop(rng_images, 24, 24, b))
    np.testing.assert_array_equal(records.random_flip(rng_images, a),
                                  jax_records.random_flip(rng_images, b))


def test_to_device_on_cpu():
    batch = pipeline.Batch(np.zeros((4, 24, 24, 3), np.float32),
                           np.arange(4, dtype=np.int32))
    images, labels = pipeline.to_device(batch, torch.device("cpu"))
    assert images.dtype == torch.float32 and images.shape == (4, 24, 24, 3)
    assert labels.dtype == torch.int64 and labels.tolist() == [0, 1, 2, 3]


def test_unported_datasets_raise(tmp_path):
    cfg = DataConfig(dataset="imagenet", data_dir=str(tmp_path))
    with pytest.raises(ValueError, match="unknown dataset"):
        download.train_files(cfg)
    with pytest.raises(download.DownloadError, match="synthetic"):
        download.ensure_dataset(DataConfig(data_dir=str(tmp_path)))
