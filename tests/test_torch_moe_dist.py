"""PyTorch port, ``vit_moe`` over ranks on the CPU: routing that stays
global over the data ranks, and expert parallelism over the model ranks.

One spawn of 2 gloo ranks (``tests/_torch_dist.py:moe_runs``) runs, from
the JAX package's init, 3 steps at batch 16 (24 px, 10 tokens a image):

- data 2 at capacity factor 0.5, where tokens drop: against JAX
  ``make_train_step`` on ``data=2`` (losses rtol 1e-5, atol 1e-6;
  parameters rtol 2e-5, atol 2e-6; the router stats of every step) and
  against the port's one-process run of the same global batches (its
  ``moe_dropped_frac`` equal). A rank that routed its half alone would
  queue and drop other tokens;
- the same with ``grad_accum`` 2: each data rank holds one of the JAX
  package's two microbatches of the global batch whole;
- the same as zero1 and as fsdp: bit-equal to the replicated data ranks;
- model 2 (ViT width 48, 3 heads, so a rank's attention cuts a head in two;
  4 experts, 2 a rank) with SGD and AdamW against JAX ``data=1, model=2``
  at the same pins, AdamW's rounding-driven elements as
  ``test_torch_tp.py:_adam_noise`` holds them;
- one SGD step at lr 1: the gate kernel's gradient (``params0 -
  params1``) equal, within rtol 1e-5, to the one-process run's, where a
  router gradient not summed over the model ranks, or an aux term counted
  once a rank, is off by half or double;
- the JAX package's ``.sharded`` save of its ``data=1, model=2`` SGD
  state, restored into the port's two model ranks and saved again: every
  piece of the expert leaves (``P(None, "model", None, None)``), its
  index range, dtype and bytes, is JAX's, and the JAX package restores
  the port's files to its own values.
"""

import os

import jax
import numpy as np
import pytest
import torch

import _torch_dist
from dml_cnn_cifar10_tpu.ckpt import checkpoint as jax_ckpt
from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.config import ModelConfig as JaxModelConfig
from dml_cnn_cifar10_tpu.config import OptimConfig as JaxOptimConfig
from dml_cnn_cifar10_tpu.config import ParallelConfig as JaxParallelConfig
from dml_cnn_cifar10_tpu.models.registry import get_model as jax_get_model
from dml_cnn_cifar10_tpu.parallel import mesh as jax_mesh
from dml_cnn_cifar10_tpu.parallel import step as jax_step
from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              OptimConfig)
from dml_cnn_cifar10_tpu_torch.models.registry import get_model
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
from test_torch_tp import (LOSS_PIN, PARAM_PIN, _adam_noise, _batches,
                           _close, _np)

DP = dict(name="vit_moe", logit_relu=False, vit_depth=2, vit_dim=64,
          vit_heads=2, patch_size=8, moe_experts=4, moe_capacity_factor=0.5)
EP = dict(DP, vit_dim=48, vit_heads=3, moe_capacity_factor=1.25)
SGD = dict(learning_rate=0.05)
ADAMW = dict(optimizer="adamw", learning_rate=1e-3)
ONE = 2.0 ** -24      # a float32 ulp of 1: JAX's jitted division


def jax_run(model_kw, optim_kw, batches, data, model):
    """JAX steps on a ``data x model`` mesh: ``(initial params, per-step
    metrics, final state)``."""
    mcfg, dcfg = JaxModelConfig(**model_kw), JaxDataConfig(normalize="scale")
    ocfg = JaxOptimConfig(**optim_kw)
    mesh = jax_mesh.build_mesh(
        JaxParallelConfig(data_axis=data, model_axis=model),
        devices=jax.devices()[:data * model])
    model_def = jax_get_model(mcfg.name)
    sh = jax_step.train_state_shardings(mesh, model_def, mcfg, dcfg, ocfg)
    state = jax_step.init_train_state(jax.random.key(0), model_def, mcfg,
                                      dcfg, ocfg, mesh, state_sharding=sh)
    params0 = _np(state.params)
    train = jax_step.make_train_step(model_def, mcfg, ocfg, mesh,
                                     state_sharding=sh)
    metrics = []
    for images, labels in batches:
        state, m = train(state, *jax_mesh.shard_batch(mesh, images, labels))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return params0, metrics, state


def one_rank(run):
    """The port's run of ``run`` in this process, one rank, the global
    batches: ``(per-step metrics, state tree)``."""
    mcfg = ModelConfig(**run["model"])
    net = get_model(mcfg.name)(mcfg, DataConfig())
    ocfg = OptimConfig(**run["optim"])
    state = step_lib.init_train_state(net, ocfg, torch.device("cpu"),
                                      torch.Generator().manual_seed(0))
    tree = ckpt_lib.state_to_tree(state)
    tree["params"] = run["params"]
    ckpt_lib.load_tree_into(state, tree)
    train = step_lib.make_train_step(net, ocfg)
    metrics = []
    for images, labels in run["batches"]:
        _, m = train(state, torch.from_numpy(images),
                     torch.from_numpy(labels.astype(np.int64)))
        metrics.append(_torch_dist._metrics(m))
    return metrics, ckpt_lib.state_to_tree(state)


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    batches = _batches(16)
    jax_res = {
        "dp": jax_run(DP, SGD, batches, 2, 1),
        "dp_accum": jax_run(DP, dict(SGD, grad_accum=2), batches, 2, 1),
        "ep_sgd": jax_run(EP, SGD, batches, 1, 2),
        "ep_adamw": jax_run(EP, ADAMW, batches, 1, 2)}
    dp0, ep0 = jax_res["dp"][0], jax_res["ep_sgd"][0]
    runs = {"dp": dict(model=DP, optim=SGD, params=dp0),
            "dp_accum": dict(model=DP, optim=dict(SGD, grad_accum=2),
                             params=dp0),
            "dp_zero1": dict(model=DP, optim=SGD, params=dp0, mode="zero1"),
            "dp_fsdp": dict(model=DP, optim=SGD, params=dp0, mode="fsdp"),
            "ep_sgd": dict(model=EP, optim=SGD, params=ep0, model_axis=2),
            "ep_adamw": dict(model=EP, optim=ADAMW, params=ep0,
                             model_axis=2),
            "ep_gate": dict(model=EP, optim=dict(learning_rate=1.0),
                            params=ep0, model_axis=2,
                            batches=batches[:1])}
    runs = {n: {"batches": batches, **r} for n, r in runs.items()}
    work = tmp_path_factory.mktemp("moe_dist")
    jax_ckpt.save_checkpoint(str(work / "jax_ckpt"), jax_res["ep_sgd"][2],
                             3, fmt="sharded", shard_io_threads=1)
    ranks = _torch_dist.run_ranks(
        "moe_runs", 2, work / "ranks", runs,
        dict(run="ep_sgd", jax=str(work / "jax_ckpt"),
             out=str(work / "port_ckpt")))
    ones = {n: one_rank(runs[n]) for n in ("dp", "ep_sgd", "ep_gate")}
    return ranks, ones, jax_res, work, runs


def _losses(metrics):
    return [float(m["loss"]) for m in metrics]


def _stats_match_jax(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["moe_aux_loss"], w["moe_aux_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(g["moe_dropped_frac"],
                                   w["moe_dropped_frac"], rtol=0, atol=ONE)
        np.testing.assert_allclose(g["moe_expert_load"],
                                   w["moe_expert_load"], rtol=0, atol=ONE)


@pytest.mark.parametrize("name", ["dp", "dp_accum"])
def test_global_routing_over_data_ranks_matches_jax(moe, name):
    ranks, ones, jax_res, _, _ = moe
    _, jm, jstate = jax_res[name]
    for r in ranks:
        got = r[name]["metrics"]
        np.testing.assert_allclose(_losses(got), _losses(jm), **LOSS_PIN)
        _stats_match_jax(got, jm)
        # Capacity binds: tokens drop, the same on every rank.
        assert all(m["moe_dropped_frac"] > 0.1 for m in got)
        assert [m["moe_dropped_frac"] for m in got] == \
            [m["moe_dropped_frac"] for m in ranks[0][name]["metrics"]]
        _close(r[name]["tree"]["params"], _np(jstate.params),
               f"{name} vs JAX", **PARAM_PIN)
    if name == "dp":
        one_metrics, one_tree = ones["dp"]
        got = ranks[0]["dp"]["metrics"]
        np.testing.assert_allclose(_losses(got), _losses(one_metrics),
                                   **LOSS_PIN)
        assert [m["moe_dropped_frac"] for m in got] == \
            [m["moe_dropped_frac"] for m in one_metrics]
        _close(ranks[0]["dp"]["tree"]["params"], one_tree["params"],
               "dp vs one rank", **PARAM_PIN)


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_state_is_bit_equal_to_replicated(moe, mode):
    ranks, _, _, _, _ = moe
    for r in ranks:
        _close(r[f"dp_{mode}"]["tree"], r["dp"]["tree"], mode, rtol=0,
               atol=0)
        assert r[f"dp_{mode}"]["metrics"] == r["dp"]["metrics"]


@pytest.mark.parametrize("name", ["ep_sgd", "ep_adamw"])
def test_expert_parallelism_matches_jax(moe, name):
    ranks, _, jax_res, _, _ = moe
    _, jm, jstate = jax_res[name]
    skip = None
    if name == "ep_adamw":
        skip = _adam_noise({"opt": {"nu": _np(jstate.opt["nu"])}}, 3,
                           ADAMW["learning_rate"])
    for r in ranks:
        got = r[name]["metrics"]
        np.testing.assert_allclose(_losses(got), _losses(jm), **LOSS_PIN)
        _stats_match_jax(got, jm)
        _close(r[name]["tree"]["params"], _np(jstate.params),
               f"{name} vs JAX", skip, **PARAM_PIN)
    # Two experts a rank; the 3 heads' qkv columns and proj rows halved.
    local = ranks[1][name]["local"]
    assert local["blocks.moe.w1"] == (2, 2, 48, 192)
    assert local["blocks.moe.b2"] == (2, 2, 48)
    assert local["blocks.moe.gate.kernel"] == (2, 48, 4)
    assert local["blocks.qkv.kernel"] == (2, 48, 72)
    assert local["blocks.proj.kernel"] == (2, 24, 48)


def test_gate_gradient_equals_one_rank(moe):
    ranks, ones, _, _, runs = moe
    p0 = runs["ep_gate"]["params"]["blocks"]["moe"]["gate"]["kernel"]
    want = p0 - ones["ep_gate"][1]["params"]["blocks"]["moe"]["gate"][
        "kernel"]
    for r in ranks:
        got = p0 - r["ep_gate"]["tree"]["params"]["blocks"]["moe"]["gate"][
            "kernel"]
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    assert np.abs(want).max() > 1e-4


def _pieces(path, leaf):
    """``[(index, dtype, shape, bytes)]`` of every piece of ``leaf`` in a
    sharded checkpoint's data files."""
    out = []
    for name in sorted(os.listdir(path)):
        if not name.endswith(".msgpack"):
            continue
        with open(os.path.join(path, name), "rb") as f:
            part = ckpt_lib.from_bytes(f.read())
        entries = part.get(leaf, {})
        entries = entries.values() if isinstance(entries, dict) else entries
        for e in entries:
            a = np.asarray(e["data"])
            out.append((np.asarray(e["index"]).tolist(), str(a.dtype),
                        a.shape, a.tobytes()))
    return sorted(out)


def test_sharded_expert_pieces_are_the_jax_packages(moe):
    """The JAX package's sharded save of its model-2 state, restored into
    the port's two model ranks and saved again: every piece of the expert
    leaves, its index range and its bytes, is JAX's; the JAX package
    restores the port's files to its own values."""
    _, _, jax_res, work, _ = moe
    _, _, jstate = jax_res["ep_sgd"]
    jdir = os.path.join(work, "jax_ckpt", "ckpt_3.sharded")
    pdir = os.path.join(work, "port_ckpt", "ckpt_3.sharded")
    for leaf in ("w1", "b1", "w2", "b2"):
        path = f".params/blocks/moe/{leaf}"
        want = _pieces(jdir, path)
        assert [i[1] for i, *_ in want] == [[0, 2], [2, 4]], path
        assert _pieces(pdir, path) == want, path
    back = jax_ckpt.restore_checkpoint(os.path.dirname(pdir), jstate)
    _close(_np(back.params), _np(jstate.params), "JAX <- port", rtol=0,
           atol=0)
