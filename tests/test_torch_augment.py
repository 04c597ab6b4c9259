"""PyTorch port, the brightness and contrast augmentations against the JAX
package on the CPU: ``data/records.py`` and ``data/pipeline.py`` (the
host decode and its ``skip_batches`` draw mirror), and
``ops/preprocess.py`` (the device decode).

- Host batches with crop, flip, brightness and contrast on are bit-equal
  to JAX's ``ShuffleBatchIterator`` of the same seed: both draw from
  numpy's ``Generator`` in the same order.
- ``skip_batches(n, aug=True)`` with them on leaves the stream where
  consuming ``n`` batches does, and where the JAX iterator skipped to
  (exact resume).
- The device ``brightness`` and ``contrast`` equal JAX's
  ``_random_brightness`` and ``_random_contrast`` given the same
  per-image values (JAX's threefry draws, passed in): brightness exactly;
  contrast within atol 1e-4 on 0-255 pixels (rtol 0), because the channel
  mean is a float32 sum whose order differs from XLA's (a few ulp of a
  mean near 128, 7.6e-6 each, carried through one multiply-add).
- The port's own device draws are in range, deterministic, keyed on
  (seed, step, column), and a ``[K, B]`` chunk decodes as its K batches
  one step at a time.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.data import pipeline as jax_pipe
from dml_cnn_cifar10_tpu.ops import preprocess as jax_pre
from dml_cnn_cifar10_tpu_torch.config import DataConfig
from dml_cnn_cifar10_tpu_torch.data import pipeline as pipe
from dml_cnn_cifar10_tpu_torch.ops import preprocess as pre

torch.set_num_threads(2)

JITTER = dict(random_brightness=63.0, random_contrast=0.8)
AUG = dict(dataset="synthetic", normalize="scale", random_crop=True,
           random_flip=True, synthetic_train_records=200,
           synthetic_test_records=40, **JITTER)
CONTRAST_ATOL = 1e-4


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("synth"))


def _jax_it(data_dir, seed, **over):
    cfg = JaxDataConfig(data_dir=data_dir, use_native_loader=False,
                        **{**AUG, **over})
    return jax_pipe.input_pipeline(cfg, 16, train=True, seed=seed)


@pytest.mark.parametrize("over", [{}, dict(random_crop=False,
                                           random_flip=False,
                                           normalize="none")])
def test_host_batches_bit_equal_jax(data_dir, over):
    cfg = DataConfig(data_dir=data_dir, **{**AUG, **over})
    it = pipe.input_pipeline(cfg, 16, train=True, seed=3)
    j = _jax_it(data_dir, 3, **over)
    for _ in range(3):
        a, b = next(it), next(j)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    # The jitter is on: the same seed without it decodes other pixels.
    plain = dataclasses.replace(cfg, random_brightness=0.0,
                                random_contrast=0.0)
    assert not np.array_equal(
        next(pipe.input_pipeline(plain, 16, train=True, seed=3)).images,
        next(pipe.input_pipeline(cfg, 16, train=True, seed=3)).images)


def test_skip_batches_continues_the_consumed_stream(data_dir):
    cfg = DataConfig(data_dir=data_dir, **AUG)
    a = pipe.input_pipeline(cfg, 16, train=True, seed=5)
    b = pipe.input_pipeline(cfg, 16, train=True, seed=5)
    j = _jax_it(data_dir, 5)
    for _ in range(4):
        next(a)
    b.skip_batches(4, aug=True)
    j.skip_batches(4, aug=True)
    for _ in range(3):
        ba, bb, bj = next(a), next(b), next(j)
        np.testing.assert_array_equal(ba.images, bb.images)
        np.testing.assert_array_equal(bb.images, bj.images)
        np.testing.assert_array_equal(ba.labels, bb.labels)
    # Each jitter on its own is mirrored too.
    for name in JITTER:
        one = dataclasses.replace(cfg, **{k: 0.0 for k in JITTER
                                          if k != name})
        c = pipe.input_pipeline(one, 16, train=True, seed=6)
        d = pipe.input_pipeline(one, 16, train=True, seed=6)
        next(c), next(c)
        d.skip_batches(2, aug=True)
        np.testing.assert_array_equal(next(c).images, next(d).images)


def test_device_functions_match_jax_given_its_draws():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (2, 6, 24, 24, 3)).astype(np.float32)
    key = jax.random.key(7)
    n = 12
    deltas = np.array(jax.random.uniform(key, (n,), minval=-63.0,
                                         maxval=63.0)).reshape(2, 6)
    factors = np.array(jax.random.uniform(key, (n,), minval=0.2,
                                          maxval=1.8)).reshape(2, 6)
    want_b = np.asarray(jax_pre._random_brightness(x, 63.0, key))
    want_c = np.asarray(jax_pre._random_contrast(x, 0.8, key))
    got_b = pre.brightness(torch.from_numpy(x), torch.from_numpy(deltas))
    got_c = pre.contrast(torch.from_numpy(x), torch.from_numpy(factors))
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0,
                               atol=CONTRAST_ATOL)


def _cfg(**kw):
    # Crop = image size and no normalization: the output is the jitter
    # alone on the cast pixels.
    return DataConfig(image_height=8, image_width=8, crop_height=8,
                      crop_width=8, seed=11, **kw)


def test_device_draws_in_range_deterministic_and_chunked():
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (3, 5, 8, 8, 3), dtype=torch.uint8,
                      generator=gen)
    xf = x.float()
    out = pre.device_preprocess(x, _cfg(random_brightness=63.0), 40)
    delta = out - xf
    # One delta an image (x + d - x is d to within a rounding of x + d).
    per_image = delta.amax(dim=(-3, -2, -1))
    assert (per_image - delta.amin(dim=(-3, -2, -1))).abs().max() <= 3e-5
    assert per_image.abs().max() <= 63.0 and per_image.std() > 1.0
    out_c = pre.device_preprocess(x, _cfg(random_contrast=0.8), 40)
    mean = xf.mean(dim=(-3, -2), keepdim=True)
    dev = xf - mean
    sel = dev.abs() > 8
    f = ((out_c - mean)[sel] / dev[sel])
    assert f.min() >= 0.2 - 1e-4 and f.max() <= 1.8 + 1e-4
    # Deterministic, and keyed on the step and the seed.
    cfg = _cfg(random_crop=False, random_flip=True, **JITTER)
    a = pre.device_preprocess(x, cfg, torch.tensor(40))
    assert torch.equal(a, pre.device_preprocess(x, cfg, 40))
    assert not torch.equal(a, pre.device_preprocess(x, cfg, 41))
    assert not torch.equal(a, pre.device_preprocess(
        x, dataclasses.replace(cfg, seed=12), 40))
    # A [K, B] chunk at step s decodes batch k as step s + k does.
    for k in range(3):
        assert torch.equal(a[k], pre.device_preprocess(x[k], cfg, 40 + k))
    # A data rank's columns draw as they do in the whole batch.
    assert torch.equal(a[:, 2:4], pre.device_preprocess(
        x[:, 2:4], cfg, 40, col0=2))
    # Eval decode: every augmentation off.
    assert not cfg.without_augmentation().augmented
    with pytest.raises(ValueError, match="step"):
        pre.device_preprocess(x, cfg)
