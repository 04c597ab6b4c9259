"""PyTorch port, the two repairs that the MoE rung needs, on the CPU.

- **Deterministic cuDNN**: a trainer's set-up (its step builders,
  ``parallel/step.py:f32_parity``) leaves ``cudnn.deterministic`` on and
  ``cudnn.benchmark`` off, with TF32 off, whatever they were before; so
  does the eval step.
- **Half-head tensor parallelism**: ViT-Ti's widths (dim 192, 3 heads of
  64) cut to depth 2, at model 2 on one spawn of 2 gloo ranks
  (``tests/_torch_dist.py:tp_runs``), where each rank holds half the
  heads-major qkv columns and proj rows and so cuts head 1 in two: SGD,
  AdamW and AdamW with remat, 3 steps at batch 16 from the JAX package's
  init, against JAX ``make_train_step`` on ``data=1, model=2`` and the
  port's replicated run at the pins of ``tests/test_torch_tp_vit.py``
  (losses rtol 1e-5, atol 1e-6; parameters rtol 2e-5, atol 2e-6; AdamW's
  rounding-driven elements as ``test_torch_tp.py:_adam_noise`` holds
  them); remat changes no bit. At these widths the JAX package's own
  AdamW runs on ``data=1`` and on ``data=1, model=2`` part at 40 elements
  of each 294,912-element MLP kernel (cancelling float32 gradient sums,
  whose step is about ``lr·sign(g)``), above ``_adam_noise``'s 1 in 10^4:
  a leaf may have as many such elements as JAX's two layouts show there,
  each still held to ``steps·lr``.
"""

import numpy as np
import pytest
import torch

import _torch_dist
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              TrainConfig)
from dml_cnn_cifar10_tpu_torch.models.registry import get_model
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
from dml_cnn_cifar10_tpu_torch.train.loop import Trainer
from test_torch_tp import (ADAMW, LOSS_PIN, PARAM_PIN, SGD, _adam_noise,
                           _batches, _close, _leaves, _losses, jax_train,
                           replicated)

VIT_TI = dict(name="vit_tiny", logit_relu=False, vit_depth=2)


def _scramble():
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


def _flags():
    return (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def test_trainer_setup_sets_deterministic_cudnn(tmp_path):
    saved = _flags()
    try:
        _scramble()
        cfg = TrainConfig(device="cpu", log_dir=str(tmp_path),
                          batch_size=8)
        cfg.data.dataset = "synthetic"
        cfg.data.data_dir = str(tmp_path / "data")
        cfg.data.synthetic_train_records = 64
        cfg.data.synthetic_test_records = 16
        Trainer(cfg).close()
        assert _flags() == (True, False, False, False)
        assert step_lib.CUDNN_MODE == ("cudnn deterministic, benchmark off, "
                                       "TF32 off")
        # The eval step too (the serving engine sets them on the card).
        _scramble()
        step_lib.make_eval_step(get_model("cnn")(ModelConfig(),
                                                 DataConfig()))
        assert _flags() == (True, False, False, False)
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.fixture(scope="module")
def halfhead(tmp_path_factory):
    batches = _batches(17)
    jax_res = {name: jax_train(VIT_TI, optim, batches, 1, 2)
               for name, optim in (("sgd", SGD), ("adamw", ADAMW))}
    jax_res["adamw_1x1"] = jax_train(VIT_TI, ADAMW, batches, 1, 1)
    params0 = jax_res["sgd"][0]
    runs = {"sgd": dict(model=VIT_TI, optim=SGD),
            "adamw": dict(model=VIT_TI, optim=ADAMW),
            "adamw_remat": dict(model=dict(VIT_TI, remat=True),
                                optim=ADAMW)}
    runs = {n: dict(r, params=params0, batches=batches)
            for n, r in runs.items()}
    ranks = _torch_dist.run_ranks("tp_runs", 2,
                                  tmp_path_factory.mktemp("halfhead"), 2,
                                  runs)
    reps = {name: replicated(runs[name]) for name in ("sgd", "adamw")}
    return ranks, reps, jax_res


def _adam_noise_within_jax(rep_tree, jax_res):
    """``_adam_noise`` with a leaf's allowance of far elements raised to
    what the JAX package's own ``data=1`` and ``data=1, model=2`` AdamW
    runs show on it."""
    own = {path: int((~np.isclose(a, b, **PARAM_PIN)).sum())
           for (path, a), (_, b) in zip(
               _leaves(jax_res["adamw_1x1"][2]), _leaves(jax_res["adamw"][2]))}
    lr = ADAMW["learning_rate"]
    base = _adam_noise(rep_tree, 3, lr)

    def skip(path, x, y):
        leaf = path[len("['params']"):] if path.startswith("['params']") \
            else path
        far = ~np.isclose(x, y, **PARAM_PIN)
        if far.sum() <= max(2, x.size // 10 ** 4):
            return base(path, x, y)
        assert far.sum() <= own.get(leaf, 0), (path, far.sum(), own)
        assert np.abs(x - y)[far].max() <= 3 * lr * 1.001, path
        return True

    return skip


@pytest.mark.parametrize("name", ["sgd", "adamw", "adamw_remat"])
def test_half_head_tp_matches_jax_and_replicated(halfhead, name):
    ranks, reps, jax_res = halfhead
    base = name.replace("_remat", "")
    _, jax_losses, jax_params = jax_res[base]
    rep_metrics, rep_tree, _ = reps[base]
    skip = _adam_noise_within_jax(rep_tree, jax_res) \
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
    # Half of the 576 qkv columns and of the 192 proj rows a rank.
    assert ranks[1][name]["local"]["blocks.qkv.kernel"].shape == (2, 192,
                                                                  288)
    assert ranks[1][name]["local"]["blocks.proj.kernel"].shape == (2, 96,
                                                                   192)
    if name == "adamw_remat":
        _close(got["tree"], ranks[-1]["adamw"]["tree"], "remat vs not",
               rtol=0, atol=0)
