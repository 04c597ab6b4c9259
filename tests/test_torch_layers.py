"""PyTorch port, ops/layers.py + models/cnn.py + convert.py + models/registry.py,
against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks; the
JAX model's params are carried into the port with ``convert.py`` (the two
truncated-normal inits cannot draw the same numbers). Tolerances: 1e-5
absolute for one conv / dense (f32, different summation order), exact for
max pooling (a max is exact), 1e-4 absolute for the whole CNN forward
(two 5x5 convs and three products summed in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.config import ModelConfig as JaxModelConfig
from dml_cnn_cifar10_tpu.models import cnn as jax_cnn
from dml_cnn_cifar10_tpu.ops import layers as jax_layers
from dml_cnn_cifar10_tpu_torch import convert
from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
from dml_cnn_cifar10_tpu_torch.models.resnet import ResNet
from dml_cnn_cifar10_tpu_torch.models.registry import get_model
from dml_cnn_cifar10_tpu_torch.models.vit import ViT
from dml_cnn_cifar10_tpu_torch.ops import layers

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("hw,cin,cout,stride", [(24, 3, 64, 1),
                                                (12, 64, 64, 1),
                                                (24, 8, 16, 2),
                                                (7, 4, 5, 2)])
def test_conv2d_matches_jax(hw, cin, cout, stride):
    """Stride 2 on 24 and 7 makes TF "SAME" pad asymmetrically. Inputs at
    the model's own scale: activations in [0, 1), kernels at the init's
    σ=0.05."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 1.0, size=(2, hw, hw, cin)).astype(np.float32)
    k = rng.normal(scale=0.05, size=(5, 5, cin, cout)).astype(np.float32)
    want = np.asarray(jax_layers.conv2d(jnp.asarray(x), jnp.asarray(k),
                                        stride=stride))
    got = layers.conv2d(_t(x), _t(k), stride=stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw,patch", [(48, 4), (64, 4), (12, 3)])
def test_conv2d_valid_patch_embed_matches_jax(hw, patch):
    """VALID, stride = kernel size: the ViT's patch embed."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, hw, hw, 3)).astype(np.float32)
    k = rng.normal(scale=0.1, size=(patch, patch, 3, 16)).astype(np.float32)
    want = np.asarray(jax_layers.conv2d(jnp.asarray(x), jnp.asarray(k),
                                        stride=patch, padding="VALID"))
    got = layers.conv2d(_t(x), _t(k), stride=patch, padding="VALID").numpy()
    assert got.shape == want.shape == (2, hw // patch, hw // patch, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_he_normal_matches_the_jax_distribution():
    """Fan-in from every dim but the last, σ = sqrt(2 / fan_in)."""
    t = layers.he_normal_(torch.empty(4, 4, 3, 4096),
                          torch.Generator().manual_seed(0))
    want = jax_layers.he_normal_init(jax.random.key(0), (4, 4, 3, 4096))
    assert abs(t.std().item() - np.sqrt(2.0 / 48)) < 0.005
    assert abs(t.std().item() - float(jnp.std(want))) < 0.005
    assert abs(t.mean().item()) < 0.005


@pytest.mark.parametrize("hw", [24, 12, 7])
def test_max_pool_tf_same_matches_jax(hw):
    """All-negative inputs: a zero pad (instead of -inf) would win the max
    on the padded edge row/column."""
    rng = np.random.default_rng(1)
    x = -np.abs(rng.normal(size=(2, hw, hw, 5))).astype(np.float32) - 1.0
    want = np.asarray(jax_layers.max_pool(jnp.asarray(x)))
    got = layers.max_pool(_t(x)).numpy()
    assert got.shape == want.shape == (2, -(-hw // 2), -(-hw // 2), 5)
    np.testing.assert_array_equal(got, want)
    assert layers.pooled_hw(hw, hw, 1) == jax_layers.pooled_hw(hw, hw, 1)


def test_dense_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 2304)).astype(np.float32)
    w = rng.normal(scale=0.05, size=(2304, 384)).astype(np.float32)
    b = rng.normal(size=(384,)).astype(np.float32)
    want = np.asarray(jax_layers.dense(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b)))
    np.testing.assert_allclose(layers.dense(_t(x), _t(w), _t(b)).numpy(),
                               want, rtol=0, atol=1e-5)


def _jax_params(seed=0):
    return jax_cnn.init_params(jax.random.key(seed), JaxModelConfig(),
                               JaxDataConfig())


def _port_cnn(logit_relu=True):
    return CNN(ModelConfig(logit_relu=logit_relu), DataConfig())


@pytest.mark.parametrize("logit_relu", [True, False])
def test_cnn_forward_matches_jax(logit_relu):
    params = _jax_params()
    model = _port_cnn(logit_relu)
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(3)
    images = rng.uniform(0.0, 1.0, size=(8, 24, 24, 3)).astype(np.float32)
    want = np.asarray(jax_cnn.apply(params, jnp.asarray(images),
                                    JaxModelConfig(logit_relu=logit_relu)))
    with torch.no_grad():
        got = model(_t(images)).numpy()
    assert got.shape == want.shape == (8, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if logit_relu:
        assert (got >= 0).all()


def test_cnn_gradients_are_contiguous():
    """The fused update kernel takes contiguous leaves only: the model's
    NHWC input must not leave the conv kernels' gradients channels_last."""
    model = _port_cnn(logit_relu=False)
    model.reset_parameters(torch.Generator().manual_seed(0))
    images = torch.rand(4, 24, 24, 3)
    grads = torch.autograd.grad(model(images).sum(),
                                list(model.parameters()))
    assert all(g.is_contiguous() for g in grads)


def test_cnn_full_width_matches_the_jax_model():
    """Same leaf names and element counts (1,068,298 f32 params in 10
    leaves at the reference width), in the port's layouts."""
    params = jax.tree.map(np.asarray, _jax_params())
    model = _port_cnn()
    named = dict(model.named_parameters())
    flat = convert.params_from_jax(params)
    assert sorted(named) == sorted(flat)
    assert len(named) == 10
    assert sum(p.numel() for p in named.values()) == 1_068_298
    for name, p in named.items():
        assert tuple(p.shape) == tuple(flat[name].shape), name
    assert named["conv1.kernel"].shape == (64, 3, 5, 5)        # OIHW
    assert named["full1.kernel"].shape == (384, 2304)          # [out, in]


def test_convert_round_trip_is_exact():
    params = jax.tree.map(np.asarray, _jax_params(seed=4))
    back = convert.params_to_jax(convert.params_from_jax(params))
    assert sorted(back) == sorted(params)
    for layer in params:
        assert sorted(back[layer]) == sorted(params[layer])
        for leaf in params[layer]:
            np.testing.assert_array_equal(back[layer][leaf],
                                          params[layer][leaf])


def test_reset_parameters_is_seeded_and_truncated():
    """The port's own init: a torch.Generator seed gives the same weights
    on every call, drawn from the reference's distribution (normal σ=0.05
    truncated at ±2σ, biases 0.1)."""
    a, b = _port_cnn(), _port_cnn()
    a.reset_parameters(torch.Generator().manual_seed(7))
    b.reset_parameters(torch.Generator().manual_seed(7))
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("kernel"):
            assert pa.abs().max().item() <= 0.1 + 1e-7
            assert 0.03 < pa.std().item() < 0.05
        else:
            assert torch.all(pa == 0.1)


def test_registry_has_cnn_and_queues_the_rest():
    model = get_model("cnn")(ModelConfig(), DataConfig())
    assert isinstance(model, CNN)
    assert get_model("vit_tiny") is ViT
    assert get_model("resnet18") is get_model("resnet50") is ResNet
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model("vit_moe")
    with pytest.raises(ValueError, match="unknown model"):
        get_model("nope")
