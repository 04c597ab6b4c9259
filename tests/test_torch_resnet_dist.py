"""PyTorch port, cross-replica BatchNorm: ResNet-18 on 2 spawned gloo ranks.

One spawn (``tests/_torch_dist.py:sharded_runs``) trains ResNet-18 three
steps (global batch 8, 4 images a rank, 24 px, SGD with momentum 0.9 and
weight decay 5e-4) from the JAX package's init, replicated, under zero1
and under fsdp. Each rank normalizes by the global batch's statistics:
``ops/layers.py:batch_norm_nchw`` all-reduces (E[x], E[x²]) over the
data ranks in the forward and the cotangents in the backward. The run is
held to:

- JAX's shard_map step (``explicit_collectives=True``: ``lax.pmean`` of
  the two statistics) and its auto-jit step (global-batch statistics) on
  a ``data=2`` CPU mesh, the pair JAX's
  ``test_explicit_shard_map_matches_auto_jit`` pins;
- the port's one-rank run at the global batch.

Pins as ``test_torch_resnet_train.py``'s: per-step loss rtol 2e-5; params
and ``model_state`` ``max|Δ| / max(1, max|ref|)`` 1e-4; the momentum's
relative norm 2e-3 (ReLU-side flips, ROADMAP.md Queue 3). zero1 and fsdp
equal the replicated run bit for bit: two ranks' sums do not depend on
their order, and the update is elementwise. The ranks' running stats are
equal bit for bit (every rank computes them from the same all-reduced
statistics).
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
from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
from dml_cnn_cifar10_tpu_torch.config import OptimConfig
from dml_cnn_cifar10_tpu_torch.models.resnet import ResNet
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

MODEL = dict(name="resnet18", logit_relu=False)
SGD = dict(learning_rate=0.02, momentum=0.9, weight_decay=5e-4)
LOSS_RTOL, STATE_ATOL, MOMENTUM_RTOL = 2e-5, 1e-4, 2e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(seed=7, n=3, b=8, hw=24):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (b, hw, hw, 3)).astype(np.float32),
             rng.integers(0, 10, b).astype(np.int32)) for _ in range(n)]


def jax_runs(batches):
    """``{explicit: (losses, state tree)}`` of JAX's auto-jit and
    shard_map steps on a data=2 mesh, and the initial params."""
    mcfg = JaxModelConfig(**MODEL)
    dcfg = JaxDataConfig()
    ocfg = JaxOptimConfig(**SGD)
    mesh = jax_mesh.build_mesh(JaxParallelConfig(data_axis=2),
                               devices=jax.devices()[:2])
    model_def = jax_get_model("resnet18")
    out, params0 = {}, None
    for explicit in (False, True):
        state = jax_step.init_train_state(jax.random.key(0), model_def,
                                          mcfg, dcfg, ocfg, mesh)
        params0 = _np(state.params)
        train = jax_step.make_train_step(model_def, mcfg, ocfg, mesh,
                                         explicit_collectives=explicit)
        losses = []
        for images, labels in batches:
            state, m = train(state, *jax_mesh.shard_batch(mesh, images,
                                                          labels))
            losses.append(float(m["loss"]))
        out[explicit] = (losses, {
            "params": _np(state.params), "model_state": _np(
                state.model_state),
            "opt": {"momentum": _np(state.opt["momentum"])}})
    return params0, out


def one_rank(params0, batches):
    net = ResNet(ModelConfig(**MODEL), DataConfig())
    ocfg = OptimConfig(**SGD)
    state = step_lib.init_train_state(net, ocfg, torch.device("cpu"),
                                      torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, value in convert.params_from_jax(params0).items():
            state.params[name].copy_(value)
    train = step_lib.make_train_step(net, ocfg)
    losses = []
    for images, labels in batches:
        _, m = train(state, torch.from_numpy(images),
                     torch.from_numpy(labels.astype(np.int64)))
        losses.append(float(m["loss"]))
    return losses, {"params": convert.params_to_jax(state.params),
                    "model_state": convert.state_to_jax(
                        state.model_state, state.params),
                    "opt": {"momentum": convert.params_to_jax(
                        state.opt["momentum"])}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(2)
    batches = _batches()
    params0, jax_out = jax_runs(batches)
    cases = {mode: dict(mode=mode, model=MODEL, optim=SGD, params=params0,
                        batches=batches) for mode in ("none", "zero1",
                                                      "fsdp")}
    ranks = _torch_dist.run_ranks("sharded_runs", 2,
                                  tmp_path_factory.mktemp("resnet_dist"),
                                  cases, timeout_s=240.0)
    return ranks, jax_out, one_rank(params0, batches)


def _port_tree(tree):
    """A state tree (the port's msgpack form or JAX's) as flat tensors by
    the port's names."""
    return {"params": convert.params_from_jax(tree["params"]),
            "model_state": convert.params_from_jax(tree["model_state"]),
            "momentum": convert.params_from_jax(tree["opt"]["momentum"])}


def _close(got, want, what):
    for key in ("params", "model_state", "momentum"):
        g, w = got[key], want[key]
        assert set(g) == set(w) and g, (what, key)
        if key == "momentum":
            num = sum(float(((g[n].double() - w[n].double()) ** 2).sum())
                      for n in g)
            den = sum(float((w[n].double() ** 2).sum()) for n in g)
            assert (num / den) ** 0.5 <= MOMENTUM_RTOL, (what, key)
            continue
        for n in g:
            err = float((g[n] - w[n]).abs().max()) / max(
                1.0, float(w[n].abs().max()))
            assert err <= STATE_ATOL, f"{what} {key}.{n}: {err:.3g}"


def _losses(rank_result):
    return [m["loss"] for m in rank_result["metrics"]]


@pytest.mark.parametrize("ref", ["shard_map", "auto_jit", "one_rank"])
def test_cross_replica_bn_matches(runs, ref):
    ranks, jax_out, one = runs
    want_losses, want = {"shard_map": jax_out[True],
                         "auto_jit": jax_out[False],
                         "one_rank": one}[ref]
    want = _port_tree(want)
    for r in ranks:
        np.testing.assert_allclose(_losses(r["none"]), want_losses,
                                   rtol=LOSS_RTOL)
        _close(_port_tree(r["none"]["tree"]), want, ref)


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_modes_equal_replicated_bit_for_bit(runs, mode):
    ranks, _, _ = runs
    for r in ranks:
        assert _losses(r[mode]) == _losses(r["none"])
        got, want = _port_tree(r[mode]["tree"]), _port_tree(r["none"]["tree"])
        for key in got:
            for n, t in got[key].items():
                assert torch.equal(t, want[key][n]), (mode, key, n)
        # The moments really are sharded over the two ranks.
        assert r[mode]["moment_bytes"] < r["none"]["moment_bytes"] / 1.5


def test_ranks_hold_the_same_running_stats(runs):
    ranks, _, _ = runs
    a, b = (_port_tree(r["none"]["tree"])["model_state"] for r in ranks)
    assert a and all(torch.equal(a[n], b[n]) for n in a)
