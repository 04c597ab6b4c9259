"""PyTorch port, ZeRO-1 (``--optimizer_sharding zero1``) on 2 spawned gloo
ranks, against the port's replicated update and the JAX package's zero1.

One spawn (``tests/_torch_dist.py:sharded_runs``) runs every case from the
same initial params, the JAX package's CNN init; the tests read it:

- zero1 against replicated: params and momentum within 1e-6 absolute
  after 3 steps (PARITY.md "Update-path equivalence"), the loss within
  1e-6 relative, the health scalars within 1e-5 (their sums reorder);
  LARS, LAMB and AdamW with clipping and the EMA the same way (their norms
  sum the shards' partial squares over the ranks);
- zero1 against JAX zero1 on a ``data=2`` mesh: params within 1e-5 (the
  pin of ``test_torch_parallel.py``);
- the moments really are sharded: each rank holds less than 1/1.5 of the
  replicated bytes, the parameters stay whole;
- a chunk of 2 zero1 steps equals 2 steps, and eval over a sharded EMA;
- the mesh's reduce-scatter and all-gather on a known input;
- 4 ranks (a second spawn), where the head's 10-wide bias no longer
  divides and stays whole: zero1 and fsdp against replicated (1e-6) and
  JAX zero1 on ``data=4`` (1e-5).
"""

import jax
import numpy as np
import pytest

import _torch_dist
from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.config import ModelConfig as JaxModelConfig
from dml_cnn_cifar10_tpu.config import OptimConfig as JaxOptimConfig
from dml_cnn_cifar10_tpu.config import ParallelConfig as JaxParallelConfig
from dml_cnn_cifar10_tpu.models.registry import get_model as jax_get_model
from dml_cnn_cifar10_tpu.parallel import mesh as jax_mesh
from dml_cnn_cifar10_tpu.parallel import step as jax_step

CNN = dict(name="cnn", logit_relu=False)
SGD = dict(learning_rate=0.01, momentum=0.9, weight_decay=1e-4)
OPTIMS = {
    "lars": dict(optimizer="lars", learning_rate=0.1, weight_decay=1e-4),
    "lamb": dict(optimizer="lamb", learning_rate=1e-3, weight_decay=1e-4),
    "adamw_clip_ema": dict(optimizer="adamw", learning_rate=1e-3,
                           grad_clip_norm=0.5, ema_decay=0.9),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_train(model_kw, optim_kw, batches, data=2, **sharding):
    """JAX steps on a ``data``-device mesh with ``sharding`` (zero1=True
    or fsdp=True): ``(initial params, per-step loss, final state tree)``
    as numpy."""
    mcfg = JaxModelConfig(**model_kw)
    dcfg = JaxDataConfig(crop_height=batches[0][0].shape[1],
                         crop_width=batches[0][0].shape[2])
    ocfg = JaxOptimConfig(**optim_kw, optimizer_sharding=(
        "zero1" if sharding.get("zero1") else "none"))
    mesh = jax_mesh.build_mesh(JaxParallelConfig(data_axis=data),
                               devices=jax.devices()[:data])
    model_def = jax_get_model(mcfg.name)
    sh = jax_step.train_state_shardings(mesh, model_def, mcfg, dcfg, ocfg,
                                        **sharding)
    state = jax_step.init_train_state(jax.random.key(0), model_def, mcfg,
                                      dcfg, ocfg, mesh, state_sharding=sh)
    params0 = _np(state.params)
    train = jax_step.make_train_step(model_def, mcfg, ocfg, mesh,
                                     state_sharding=sh)
    losses = []
    for images, labels in batches:
        state, m = train(state, *jax_mesh.shard_batch(mesh, images, labels))
        losses.append(float(m["loss"]))
    return params0, losses, {"params": _np(state.params),
                             "opt": _np(state.opt)}


def _batches(seed, n=3, b=16, hw=24):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (b, hw, hw, 3)).astype(np.float32),
             rng.integers(0, 10, b).astype(np.int32)) for _ in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batches = _batches(2)
    params0, jax_losses, jax_state = jax_train(CNN, SGD, batches, zero1=True)
    cases = {}
    for mode in ("none", "zero1"):
        cases[f"sgd_{mode}"] = dict(mode=mode, model=CNN, optim=SGD,
                                    params=params0, batches=batches)
        cases[f"chunk_{mode}"] = dict(mode=mode, model=CNN, optim=SGD,
                                      params=params0, batches=batches[:2],
                                      chunk=True)
        for name, optim in OPTIMS.items():
            cases[f"{name}_{mode}"] = dict(
                mode=mode, model=CNN, optim=optim, params=params0,
                batches=batches, eval=batches[0])
    ranks = _torch_dist.run_ranks("sharded_runs", 2,
                                  tmp_path_factory.mktemp("zero1"), cases)
    return ranks, jax_losses, jax_state


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _close(a, b, atol, what):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0,
                                   atol=atol, err_msg=f"{what} {path}")


def test_zero1_matches_replicated_within_1e6(runs):
    ranks, _, _ = runs
    for r in ranks:
        none, z = r["sgd_none"], r["sgd_zero1"]
        _close(z["tree"]["params"], none["tree"]["params"], 1e-6, "params")
        _close(z["tree"]["opt"]["momentum"], none["tree"]["opt"]["momentum"],
               1e-6, "momentum")
        assert int(z["tree"]["opt"]["step"]) == 3
        np.testing.assert_allclose([m["loss"] for m in z["metrics"]],
                                   [m["loss"] for m in none["metrics"]],
                                   rtol=1e-6)
        for key in ("health_grad_norm", "health_param_norm",
                    "health_update_ratio"):
            np.testing.assert_allclose(
                [m[key] for m in z["metrics"]],
                [m[key] for m in none["metrics"]], rtol=1e-5, err_msg=key)


def test_zero1_matches_jax_zero1_on_data2(runs):
    ranks, jax_losses, jax_state = runs
    for r in ranks:
        z = r["sgd_zero1"]
        np.testing.assert_allclose([m["loss"] for m in z["metrics"]],
                                   jax_losses, rtol=1e-5)
        _close(z["tree"]["params"], jax_state["params"], 1e-5, "params")
        _close(z["tree"]["opt"]["momentum"], jax_state["opt"]["momentum"],
               1e-5, "momentum")


def test_zero1_moments_really_sharded_params_whole(runs):
    ranks, _, _ = runs
    for r in ranks:
        none, z = r["sgd_none"], r["sgd_zero1"]
        assert z["moment_bytes"] < none["moment_bytes"] / 1.5
        assert z["param_bytes"] == none["param_bytes"]
        # Only full1's bias (the rule's "model" claims its one dim) stays
        # whole: 384 floats beside half of the rest.
        assert z["moment_bytes"] == (none["moment_bytes"] + 384 * 4) // 2
    # The ranks agree bit for bit on the gathered state.
    _close(ranks[0]["sgd_zero1"]["tree"], ranks[1]["sgd_zero1"]["tree"], 0,
           "rank 0 vs rank 1")


@pytest.mark.parametrize("name", sorted(OPTIMS))
def test_zero1_other_optimizers_match_replicated(runs, name):
    ranks, _, _ = runs
    for r in ranks:
        none, z = r[f"{name}_none"], r[f"{name}_zero1"]
        _close(z["tree"], none["tree"], 1e-6, name)
        np.testing.assert_allclose([m["loss"] for m in z["metrics"]],
                                   [m["loss"] for m in none["metrics"]],
                                   rtol=1e-6)
        assert z["eval"] == none["eval"]
        assert z["moment_bytes"] < none["moment_bytes"] / 1.5


def test_zero1_chunk_equals_steps(runs):
    ranks, _, _ = runs
    for r in ranks:
        chunk, steps = r["chunk_zero1"], r["sgd_zero1"]
        # The chunk ran the first 2 of the 3 steps: same loss at step 2.
        np.testing.assert_allclose(chunk["metrics"][-1]["loss"],
                                   steps["metrics"][1]["loss"], rtol=0)
        _close(chunk["tree"]["params"], r["chunk_none"]["tree"]["params"],
               1e-6, "chunk zero1 vs chunk none")
        assert int(chunk["tree"]["opt"]["step"]) == 2


def test_mesh_reduce_scatter_and_all_gather(runs):
    ranks, _, _ = runs
    send = np.arange(6, dtype=np.float32)
    total = send * 1 + send * 2
    for r, res in enumerate(ranks):
        got, gathered = res["collectives"]
        np.testing.assert_array_equal(got, total[3 * r:3 * r + 3])
        np.testing.assert_array_equal(gathered, total)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    batches = _batches(7, n=2)
    params0, jax_losses, jax_state = jax_train(CNN, SGD, batches, data=4,
                                               zero1=True)
    cases = {mode: dict(mode=mode, model=CNN, optim=SGD, params=params0,
                        batches=batches)
             for mode in ("none", "zero1", "fsdp")}
    return _torch_dist.run_ranks("sharded_runs", 4,
                                 tmp_path_factory.mktemp("zero1_4"),
                                 cases), jax_losses, jax_state


def test_four_ranks_match_replicated_and_jax(four):
    ranks, jax_losses, jax_state = four
    for r in ranks:
        for mode in ("zero1", "fsdp"):
            _close(r[mode]["tree"], r["none"]["tree"], 1e-6, mode)
            _close(r[mode]["tree"]["params"], jax_state["params"], 1e-5,
                   f"{mode} vs JAX")
            np.testing.assert_allclose([m["loss"] for m in r[mode]
                                        ["metrics"]], jax_losses, rtol=1e-5)
        # A quarter of every split leaf, full1's and full3's biases whole.
        whole = (384 + 10) * 4
        assert r["zero1"]["moment_bytes"] == \
            (r["none"]["moment_bytes"] - whole) // 4 + whole
        assert r["fsdp"]["param_bytes"] == r["zero1"]["moment_bytes"]
