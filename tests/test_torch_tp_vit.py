"""PyTorch port, tensor parallelism of the ViT: one spawn of 2 gloo ranks
(model 2, ``tests/_torch_dist.py:tp_runs``) runs the ViT of
``tests/test_tp.py:106-109`` (depth 2, dim 64, heads 2, patch 8; 24x24
images, 10 tokens; batch 16, 3 steps, from the JAX package's init) with
SGD, and with AdamW with and without remat, against JAX
``make_train_step`` on ``data=1, model=2`` and the port's replicated run
at the pins of ``tests/test_tp.py:104-121`` (losses rtol 1e-5, atol
1e-6; parameters rtol 2e-5, atol 2e-6), AdamW's rounding-driven elements
held as ``test_torch_tp.py:_adam_noise`` says; each model rank attends
with its one head, and remat (which replays the forward's all-reduces in
the backward) changes no bit.
"""

import numpy as np
import pytest

import _torch_dist
from test_torch_tp import (ADAMW, LOSS_PIN, PARAM_PIN, SGD, VIT, _adam_noise,
                           _batches, _close, _losses, jax_train, replicated)


@pytest.fixture(scope="module")
def vit(tmp_path_factory):
    batches = _batches(6)
    jax_res = {name: jax_train(VIT, optim, batches, 1, 2)
               for name, optim in (("sgd", SGD), ("adamw", ADAMW))}
    params0 = jax_res["sgd"][0]
    runs = {"sgd": dict(model=VIT, optim=SGD),
            "adamw": dict(model=VIT, optim=ADAMW),
            "adamw_remat": dict(model=dict(VIT, remat=True), optim=ADAMW)}
    runs = {n: dict(r, params=params0, batches=batches)
            for n, r in runs.items()}
    ranks = _torch_dist.run_ranks("tp_runs", 2,
                                  tmp_path_factory.mktemp("tp_vit"), 2, runs)
    reps = {name: replicated(runs[name]) for name in ("sgd", "adamw")}
    return ranks, reps, jax_res


@pytest.mark.parametrize("name", ["sgd", "adamw", "adamw_remat"])
def test_vit_tp_matches_jax_and_replicated(vit, name):
    ranks, reps, jax_res = vit
    base = name.replace("_remat", "")
    _, jax_losses, jax_params = jax_res[base]
    rep_metrics, rep_tree, _ = reps[base]
    skip = _adam_noise(rep_tree, 3, ADAMW["learning_rate"]) \
        if base == "adamw" else None
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose(_losses(got["metrics"]), jax_losses,
                                   **LOSS_PIN)
        np.testing.assert_allclose(_losses(got["metrics"]),
                                   _losses(rep_metrics), **LOSS_PIN)
        _close(got["tree"]["params"], jax_params, f"{name} vs JAX", skip,
               **PARAM_PIN)
        _close(got["tree"]["params"], rep_tree["params"],
               f"{name} vs replicated", skip, **PARAM_PIN)
    # Each model rank attends with one of the two heads.
    assert ranks[0][name]["local"]["blocks.qkv.kernel"].shape == (2, 64, 96)
    assert ranks[0][name]["local"]["blocks.proj.kernel"].shape == (2, 32, 64)
    if name == "adamw_remat":
        _close(got["tree"], ranks[0]["adamw"]["tree"], "remat vs not",
               rtol=0, atol=0)
