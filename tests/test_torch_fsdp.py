"""PyTorch port, FSDP (``--fsdp``: parameters and moments stored 1/N per
data rank) on 2 spawned gloo ranks, against the port's replicated DP and
the JAX package's ``--fsdp`` on a ``data=2`` mesh, from the JAX init.

- the CNN with momentum 0.9 and a small ViT (depth 2, dim 64, 2 heads,
  64 tokens) with AdamW and with SGD momentum, 3 steps: losses rtol 2e-5 /
  atol 2e-6 and params rtol 2e-5 / atol 2e-6 against both
  (``tests/test_fsdp.py:99-113``). Under AdamW a few ViT elements whose
  gradient is rounding noise (``tests/test_torch_vit.py``: the attention
  key bias, whose exact gradient is 0; an Adam step is the noise's sign
  times lr) miss the pin against JAX in the port's replicated run too:
  there the fsdp run must hold the replicated run's values bit for bit
  (the layout adds nothing to the gap; ``test_torch_vit.py`` holds the
  replicated run to JAX, and the ViT with SGD momentum meets the pin);
- the parameters and the moments really are sharded on each rank, only
  the leaves with no divisible dim whole;
- eval gathers the parameters (and the EMA, when kept): the same accuracy
  as the replicated state;
- a chunk of 2 fsdp steps equals 2 steps.
"""

import numpy as np
import pytest

import _torch_dist
from test_torch_zero1 import _batches, _close, jax_train

CNN = dict(name="cnn", logit_relu=False)
VIT = dict(name="vit_tiny", pool="cls", logit_relu=False, vit_depth=2,
           vit_dim=64, vit_heads=2, patch_size=4)
SGD = dict(learning_rate=0.01, momentum=0.9)
ADAMW = dict(optimizer="adamw", learning_rate=1e-3, weight_decay=1e-4)
MODELS = {"cnn": (CNN, SGD, 24), "vit": (VIT, ADAMW, 32),
          "vit_sgd": (VIT, SGD, 32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases, ref = {}, {}
    for name, (model, optim, hw) in MODELS.items():
        batches = _batches(3, hw=hw)
        jax_model = dict(model, use_pallas_attention=False) \
            if model is VIT else model
        params0, losses, state = jax_train(jax_model, optim, batches,
                                           fsdp=True)
        ref[name] = (losses, state)
        data = dict(crop_height=hw, crop_width=hw)
        for mode in ("none", "fsdp"):
            cases[f"{name}_{mode}"] = dict(
                mode=mode, model=model, data=data, optim=optim,
                params=params0, batches=batches, eval=batches[0])
            if name == "cnn":
                cases[f"chunk_{mode}"] = dict(
                    mode=mode, model=model, optim=optim, params=params0,
                    batches=batches[:2], chunk=True)
                cases[f"ema_{mode}"] = dict(
                    mode=mode, model=model, optim=dict(optim, ema_decay=0.5),
                    params=params0, batches=batches, eval=batches[1])
    ranks = _torch_dist.run_ranks("sharded_runs", 2,
                                  tmp_path_factory.mktemp("fsdp"), cases)
    return ranks, ref


def _pinned(a, b, what):
    for key in a:
        np.testing.assert_allclose(np.asarray(a[key]), np.asarray(b[key]),
                                   rtol=2e-5, atol=2e-6,
                                   err_msg=f"{what} {key}") \
            if not isinstance(a[key], dict) else _pinned(a[key], b[key],
                                                         f"{what} {key}")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fsdp_matches_dp(runs, name):
    ranks, _ = runs
    for r in ranks:
        dp, fs = r[f"{name}_none"], r[f"{name}_fsdp"]
        np.testing.assert_allclose([m["loss"] for m in fs["metrics"]],
                                   [m["loss"] for m in dp["metrics"]],
                                   rtol=2e-5, atol=2e-6)
        _pinned(fs["tree"]["params"], dp["tree"]["params"], "params")
        assert fs["eval"] == dp["eval"]


def _pinned_beside_dp(got, want, dp, what):
    """``got`` (fsdp) within the pin of ``want`` (JAX), or else bit-equal
    to ``dp`` (the port's replicated run)."""
    for key in want:
        if isinstance(want[key], dict):
            _pinned_beside_dp(got[key], want[key], dp[key], f"{what} {key}")
            continue
        a, b, d = (np.asarray(t) for t in (got[key], want[key], dp[key]))
        bad = ~np.isclose(a, b, rtol=2e-5, atol=2e-6)
        np.testing.assert_array_equal(a[bad], d[bad], err_msg=f"{what} {key}")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fsdp_matches_jax_fsdp(runs, name):
    ranks, ref = runs
    losses, state = ref[name]
    for r in ranks:
        fs = r[f"{name}_fsdp"]
        np.testing.assert_allclose([m["loss"] for m in fs["metrics"]],
                                   losses, rtol=2e-5, atol=2e-6)
        moments = "mu" if name == "vit" else "momentum"
        if name == "vit":
            dp = r["vit_none"]["tree"]
            _pinned_beside_dp(fs["tree"]["params"], state["params"],
                              dp["params"], "params")
            _pinned_beside_dp(fs["tree"]["opt"], state["opt"], dp["opt"],
                              "opt")
        else:
            _pinned(fs["tree"]["params"], state["params"], "params")
            _pinned(fs["tree"]["opt"][moments], state["opt"][moments],
                    moments)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fsdp_params_and_moments_really_sharded(runs, name):
    ranks, _ = runs
    for r in ranks:
        dp, fs = r[f"{name}_none"], r[f"{name}_fsdp"]
        assert fs["param_bytes"] < dp["param_bytes"] / 1.5
        assert fs["moment_bytes"] < dp["moment_bytes"] / 1.5
    if name == "cnn":
        # Only full1's bias stays whole on both ranks.
        assert ranks[0]["cnn_fsdp"]["param_bytes"] == (
            ranks[0]["cnn_none"]["param_bytes"] + 384 * 4) // 2
    _close(ranks[0][f"{name}_fsdp"]["tree"],
           ranks[1][f"{name}_fsdp"]["tree"], 0, "rank 0 vs rank 1")


def test_fsdp_eval_gathers_the_ema(runs):
    ranks, _ = runs
    for r in ranks:
        dp, fs = r["ema_none"], r["ema_fsdp"]
        _pinned(fs["tree"]["opt"]["ema"], dp["tree"]["opt"]["ema"], "ema")
        assert fs["eval"] == dp["eval"]


def test_fsdp_chunk_equals_steps(runs):
    ranks, _ = runs
    for r in ranks:
        chunk = r["chunk_fsdp"]
        np.testing.assert_allclose(chunk["metrics"][-1]["loss"],
                                   r["cnn_fsdp"]["metrics"][1]["loss"],
                                   rtol=0)
        _pinned(chunk["tree"]["params"], r["chunk_none"]["tree"]["params"],
                "chunk fsdp vs chunk none")
        assert int(chunk["tree"]["opt"]["step"]) == 2
