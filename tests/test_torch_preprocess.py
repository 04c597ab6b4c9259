"""PyTorch port, ops/preprocess.py, against the JAX package.

Center crop (with pad-if-smaller), the uint8→f32 cast and the ``none`` and
``scale`` modes are EXACT against JAX ``device_preprocess``, for a batch
and for leading ``[K, B]`` dims. ``standardize`` has an exact mean (a sum
of integers below 2^24) and divides by an f32 population std that XLA and
torch sum in different orders: the outputs are held to 1e-6 absolute
plus 1e-6 relative (a few f32 ulps at the outputs' magnitude of ~2). The
random crop and flip cannot draw the JAX package's threefry bits: every
output must be an exact window (or mirrored window) of its source, the
draws deterministic per (seed, step), and a missing step must raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.ops import preprocess as jax_pre
from dml_cnn_cifar10_tpu_torch.config import DataConfig
from dml_cnn_cifar10_tpu_torch.ops.preprocess import device_preprocess

torch.set_num_threads(2)

# (input shape, crop): a batch, a [K, B] chunk, and images smaller than
# the crop in one dimension (pad, then crop).
SHAPES = [((4, 32, 32, 3), 24), ((3, 2, 32, 32, 3), 24),
          ((2, 20, 30, 3), 24)]


def _raw(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("mode", ["none", "scale", "standardize"])
@pytest.mark.parametrize("shape,crop", SHAPES,
                         ids=["batch", "chunk", "pad"])
def test_center_crop_and_normalize_match_jax(shape, crop, mode):
    raw = _raw(shape)
    kw = dict(normalize=mode, crop_height=crop, crop_width=crop)
    want = np.asarray(jax_pre.device_preprocess(jnp.asarray(raw),
                                                JaxDataConfig(**kw)))
    got = device_preprocess(torch.from_numpy(raw), DataConfig(**kw))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if mode == "standardize":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def _is_window(out, src, mirrored):
    """True when ``out`` [ch, cw, C] is a window of ``src`` [H, W, C], or
    of its mirror."""
    ch, cw = out.shape[:2]
    img = src[:, ::-1] if mirrored else src
    return any(np.array_equal(out, img[t:t + ch, l:l + cw])
               for t in range(src.shape[0] - ch + 1)
               for l in range(src.shape[1] - cw + 1))


@pytest.mark.parametrize("flip", [False, True])
def test_random_crop_is_an_exact_window(flip):
    raw = _raw((2, 6, 32, 32, 3), seed=1)
    cfg = DataConfig(random_crop=True, random_flip=flip)
    out = device_preprocess(torch.from_numpy(raw), cfg,
                            torch.tensor(5, dtype=torch.int32)).numpy()
    assert out.shape == (2, 6, 24, 24, 3)
    mirrored = 0
    for k in range(2):
        for b in range(6):
            src = raw[k, b].astype(np.float32)
            if _is_window(out[k, b], src, False):
                continue
            assert flip and _is_window(out[k, b], src, True), (k, b)
            mirrored += 1
    assert (mirrored > 0) == flip


def test_random_flip_alone_mirrors_or_keeps():
    raw = _raw((16, 32, 32, 3), seed=2)
    cfg = DataConfig(random_flip=True)
    out = device_preprocess(torch.from_numpy(raw), cfg, 0).numpy()
    center = raw[:, 4:28, 4:28].astype(np.float32)
    flipped = raw[:, 4:28, ::-1][:, :, 4:28].astype(np.float32)
    kept = [np.array_equal(o, c) for o, c in zip(out, center)]
    mirrored = [np.array_equal(o, f) for o, f in zip(out, flipped)]
    assert all(a or b for a, b in zip(kept, mirrored))
    assert any(kept) and any(mirrored)


def test_draws_are_deterministic_per_seed_and_step():
    raw = torch.from_numpy(_raw((3, 8, 32, 32, 3), seed=3))
    cfg = DataConfig(random_crop=True, random_flip=True)

    def run(step, seed=0):
        cfg.seed = seed
        return device_preprocess(raw, cfg, step)

    a = run(torch.tensor(7, dtype=torch.int32))
    assert torch.equal(a, run(7))
    assert not torch.equal(a, run(8))
    assert not torch.equal(a, run(7, seed=1))
    # A [K, B] chunk at step s decodes batch k as it would alone at s + k.
    cfg.seed = 0
    for k in range(3):
        assert torch.equal(a[k], device_preprocess(raw[k], cfg, 7 + k))


def test_augmentation_needs_a_step_and_eval_config_turns_it_off():
    raw = torch.from_numpy(_raw((2, 32, 32, 3)))
    for aug in (dict(random_crop=True), dict(random_flip=True)):
        cfg = DataConfig(**aug)
        assert cfg.augmented
        with pytest.raises(ValueError, match="step"):
            device_preprocess(raw, cfg)
        plain = cfg.without_augmentation()
        assert not plain.augmented and plain.crop_height == cfg.crop_height
        assert torch.equal(device_preprocess(raw, plain),
                           device_preprocess(raw, DataConfig()))
    assert not DataConfig().augmented
    with pytest.raises(ValueError, match="normalize"):
        device_preprocess(raw, DataConfig(normalize="bogus"))
    with pytest.raises(ValueError, match="larger"):
        device_preprocess(raw, DataConfig(random_crop=True, crop_height=40),
                          0)
