"""PyTorch port, the training-health scalars of ``parallel/step.py``
(``health_metrics``) against the JAX package's ``_health_stats`` on the
CPU: ``health_grad_norm``, ``health_param_norm`` and
``health_update_ratio``.

- Eager: JAX ``make_train_step(..., health_metrics=True)`` and the port's
  from the same params (carried over with ``convert.py``) on the same
  batches, three steps, each scalar within rtol 1e-5 (the pin of
  ``tests/test_torch_step.py``: f32 convolutions sum in other orders).
  The gradient norm is taken where JAX takes it: after accumulation and
  before clipping (a case with ``grad_accum 2``, ``grad_clip_norm 0.5``
  and momentum).
- Chunked: the resident device-stream chunk of K = 3 steps, two
  dispatches; each dispatch's health scalars are its last step's.
- Two gloo ranks, each with half the batch, give the one-rank scalars
  (rtol 1e-5), eagerly and through a host-fed chunk.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_dist

from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.config import ModelConfig as JaxModelConfig
from dml_cnn_cifar10_tpu.config import OptimConfig as JaxOptimConfig
from dml_cnn_cifar10_tpu.config import ParallelConfig as JaxParallelConfig
from dml_cnn_cifar10_tpu.models.registry import get_model as jax_get_model
from dml_cnn_cifar10_tpu.parallel import mesh as jax_mesh
from dml_cnn_cifar10_tpu.parallel import step as jax_step
from dml_cnn_cifar10_tpu_torch import convert
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              OptimConfig)
from dml_cnn_cifar10_tpu_torch.data import pipeline
from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

torch.set_num_threads(2)

CPU = torch.device("cpu")
KEYS = ("health_grad_norm", "health_param_norm", "health_update_ratio")
RTOL = 1e-5


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    cfg = DataConfig(dataset="synthetic", normalize="scale",
                     data_dir=str(tmp_path_factory.mktemp("synth")),
                     synthetic_train_records=96, synthetic_test_records=20)
    it = pipeline.input_pipeline(cfg, 16, train=True, seed=0)
    raw = pipeline.input_pipeline(
        DataConfig(**{**cfg.__dict__, "normalize": "none"}), 8, train=True)
    return [next(it) for _ in range(3)], raw.images, raw.labels


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(params_np, **optim):
    model = CNN(ModelConfig(logit_relu=False), DataConfig())
    ocfg = OptimConfig(**optim)
    state = step_lib.init_train_state(model, ocfg, CPU,
                                      torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, value in convert.params_from_jax(params_np).items():
            state.params[name].copy_(value)
    return model, ocfg, state


def _close(m, jm):
    for key in KEYS:
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=RTOL,
                                   err_msg=key)
    assert 0 < float(m["health_update_ratio"]) < 1


@pytest.mark.parametrize("optim", [
    dict(learning_rate=0.01),
    dict(learning_rate=0.01, momentum=0.9, grad_clip_norm=0.5,
         grad_accum=2)], ids=["sgd", "momentum_clip_accum"])
def test_eager_health_matches_jax(data, optim):
    batches, _, _ = data
    model_def, mcfg = jax_get_model("cnn"), JaxModelConfig(logit_relu=False)
    jocfg = JaxOptimConfig(**optim)
    jstate = jax_step.init_train_state(jax.random.key(0), model_def, mcfg,
                                       JaxDataConfig(), jocfg)
    jtrain = jax_step.make_train_step(model_def, mcfg, jocfg,
                                      health_metrics=True)
    model, ocfg, state = _port(_np(jstate.params), **optim)
    train = step_lib.make_train_step(model, ocfg, health_metrics=True)
    for b in batches:
        jstate, jm = jtrain(jstate, b.images, b.labels)
        state, m = train(state, *pipeline.to_device(b, CPU))
        _close(m, jm)
    # Off by default: no health keys.
    _, m = step_lib.make_train_step(model, ocfg)(
        state, *pipeline.to_device(batches[0], CPU))
    assert set(m) == {"loss", "accuracy"}


def test_chunked_health_matches_jax(data):
    _, images, labels = data
    optim, k, b = dict(learning_rate=0.01), 3, 8
    mesh = jax_mesh.build_mesh(JaxParallelConfig(),
                               devices=jax.devices()[:1])
    model_def, mcfg = jax_get_model("cnn"), JaxModelConfig(logit_relu=False)
    jdata = JaxDataConfig(use_native_loader=False, normalize="scale")
    jstate = jax_step.init_train_state(jax.random.key(1), model_def, mcfg,
                                       jdata, JaxOptimConfig(**optim), mesh)
    repl = jax_mesh.replicated(mesh)
    jchunk = jax_step.make_train_chunk_resident(
        model_def, mcfg, JaxOptimConfig(**optim), mesh,
        jax.device_put(images, repl),
        jax.device_put(labels.astype(np.int32), repl), data_cfg=jdata,
        index_stream=(0, b, k), health_metrics=True)
    model, ocfg, state = _port(_np(jstate.params), **optim)
    chunk = step_lib.make_train_chunk_resident(
        model, ocfg, torch.from_numpy(images),
        torch.from_numpy(labels.astype(np.int64)),
        data_cfg=DataConfig(normalize="scale"), index_stream=(0, b, k),
        health_metrics=True)
    for _ in range(2):
        jstate, jm = jchunk(jstate)
        state, m = chunk(state)
        _close(m, jm)


def test_two_gloo_ranks_equal_one_rank(data, tmp_path):
    batches, images, labels = data
    params = _np(jax_step.init_train_state(
        jax.random.key(2), jax_get_model("cnn"),
        JaxModelConfig(logit_relu=False), JaxDataConfig(),
        JaxOptimConfig()).params)
    raw = images[:2 * 16].reshape(2, 16, *images.shape[1:])
    raw_labels = labels[:2 * 16].reshape(2, 16)
    b = batches[0]
    ranks = _torch_dist.run_ranks("health_ranks", 2, tmp_path, params,
                                  b.images, b.labels, raw, raw_labels)
    one = _torch_dist.health_ranks(0, 1, params, b.images, b.labels, raw,
                                   raw_labels)
    for got in ranks:
        for g, w in zip(got, one):
            for key in KEYS:
                np.testing.assert_allclose(g[key], w[key], rtol=RTOL,
                                           err_msg=key)
