"""PyTorch port, ops/optimizer.py + train/optim.py, against the JAX package.

The plain PyTorch version of the fused SGD kernels (K1 ``_sgd_kernel_plain``,
K2 ``_sgd_kernel``) is held against the JAX package's Pallas kernel run in
interpret mode and against its XLA form ``_xla_leaf``, on the tile-hostile
leaf shapes of ``tests/test_zero1.py:_leaves``. Tolerance: 5e-7 absolute
(PARITY.md's pin for the kernel vs its fallback: separate roundings vs a
possible FMA contraction, a few f32 ULPs, no reductions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu.config import OptimConfig as JaxOptimConfig
from dml_cnn_cifar10_tpu.ops import optimizer as jax_fused
from dml_cnn_cifar10_tpu.train import optim as jax_optim
from dml_cnn_cifar10_tpu_torch.config import OptimConfig
from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
from dml_cnn_cifar10_tpu_torch.train import optim

torch.set_num_threads(2)

SHAPES = [(37,), (130, 7), (256, 128)]  # tests/test_zero1.py:_leaves
CASES = [(0.0, 0.0), (0.0, 5e-4), (0.9, 0.0), (0.9, 5e-4)]
ATOL = 5e-7


def _leaves(seed):
    rng = np.random.default_rng(seed)

    def mk():
        return {f"l{i}": rng.normal(size=s).astype(np.float32)
                for i, s in enumerate(SHAPES)}
    return mk(), mk(), mk()


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("mu,wd", CASES)
@pytest.mark.parametrize("reference", ["pallas_interpret", "xla_leaf"])
def test_plain_matches_jax_kernel(mu, wd, reference):
    p, g, m = _leaves(0)
    lr = np.float32(0.05)
    mom = m if mu else None
    jp, jm = jax_fused.fused_sgd_update(
        {k: jnp.asarray(v) for k, v in p.items()},
        {k: jnp.asarray(v) for k, v in g.items()},
        None if mom is None else {k: jnp.asarray(v) for k, v in mom.items()},
        jnp.float32(lr), mu, wd,
        use_pallas=reference == "pallas_interpret", interpret=True)
    for k in p:
        tp, tm = fused.fused_sgd_update_plain(
            torch.from_numpy(p[k]), torch.from_numpy(g[k]),
            None if mom is None else torch.from_numpy(mom[k]),
            torch.tensor(lr), mu, wd)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=ATOL)
        if mom is None:
            assert tm is None and jm is None
        else:
            np.testing.assert_allclose(tm.numpy(), np.asarray(jm[k]),
                                       rtol=0, atol=ATOL)


@pytest.mark.parametrize("mu,wd", CASES)
def test_wrapper_on_cpu_is_plain_in_place_and_launches_nothing(mu, wd):
    p, g, m = _leaves(1)
    params, grads = _torch(p), _torch(g)
    mom = _torch(m) if mu else None
    ids = {k: v.data_ptr() for k, v in params.items()}
    lr = torch.tensor(0.05)
    fused.reset_launches()
    fused.fused_sgd_update(params, grads, mom, lr, mu, wd)
    assert fused.LAUNCHES == {"sgd_update_plain": 0,
                              "sgd_update_momentum": 0}
    for k in p:
        want_p, want_m = fused.fused_sgd_update_plain(
            torch.from_numpy(p[k]), torch.from_numpy(g[k]),
            None if mom is None else torch.from_numpy(m[k]), lr, mu, wd)
        assert params[k].data_ptr() == ids[k]
        assert torch.equal(params[k], want_p)
        if mom is not None:
            assert torch.equal(mom[k], want_m)


@pytest.mark.parametrize("mu,wd", CASES)
def test_fused_update_bit_identical_to_unfused_chain(mu, wd):
    """Mirrors tests/test_zero1.py:426 — same expression, same bits."""
    p, g, _ = _leaves(2)
    out = {}
    for flag in (True, False):
        cfg = OptimConfig(learning_rate=0.05, momentum=mu, weight_decay=wd,
                          fused_optimizer=flag)
        params = _torch(p)
        state = optim.sgd_init(params, cfg)
        for _ in range(2):
            optim.sgd_update(_torch(g), state, params, cfg)
        out[flag] = (params, state)
    (p1, s1), (p0, s0) = out[True], out[False]
    for k in p:
        assert torch.equal(p1[k], p0[k])
        if mu:
            assert torch.equal(s1["momentum"][k], s0["momentum"][k])
    assert int(s1["step"]) == int(s0["step"]) == 2


@pytest.mark.parametrize("mu,wd,ema", [(0.0, 0.0, 0.0), (0.9, 5e-4, 0.0),
                                       (0.0, 5e-4, 0.9)])
def test_sgd_update_matches_jax(mu, wd, ema):
    """Three updates through both packages' sgd_update (fused route on
    the port, XLA route on the JAX side), EMA included."""
    p, g, _ = _leaves(3)
    kw = dict(learning_rate=0.05, momentum=mu, weight_decay=wd,
              ema_decay=ema, dead_lr_decay=False, decay_every=2)
    jcfg, tcfg = JaxOptimConfig(**kw), OptimConfig(**kw)
    jparams = {k: jnp.asarray(v) for k, v in p.items()}
    jstate = jax_optim.sgd_init(jparams, jcfg)
    tparams = _torch(p)
    tstate = optim.sgd_init(tparams, tcfg)
    upd = jax.jit(lambda g_, s, p_: jax_optim.sgd_update(g_, s, p_, jcfg))
    for _ in range(3):
        jparams, jstate = upd({k: jnp.asarray(v) for k, v in g.items()},
                              jstate, jparams)
        optim.sgd_update(_torch(g), tstate, tparams, tcfg)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    for k in p:
        np.testing.assert_allclose(tparams[k].numpy(),
                                   np.asarray(jparams[k]), rtol=0, atol=ATOL)
        if ema:
            np.testing.assert_allclose(tstate["ema"][k].numpy(),
                                       np.asarray(jstate["ema"][k]),
                                       rtol=0, atol=ATOL)


SCHEDULES = [
    dict(schedule="exponential", dead_lr_decay=True),
    dict(schedule="exponential", dead_lr_decay=False),
    dict(schedule="exponential", dead_lr_decay=False, staircase=False),
    dict(schedule="cosine", cosine_decay_steps=1000, warmup_steps=50),
    dict(schedule="constant", warmup_steps=10),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_learning_rate_matches_jax(kw):
    """f32 schedules on both sides; pow/cos may differ by an ULP between
    the two libraries' math, so 1e-6 relative."""
    steps = [0, 1, 9, 249, 250, 251, 999, 1000, 5000]
    jcfg, tcfg = JaxOptimConfig(**kw), OptimConfig(**kw)
    for s in steps:
        want = float(jax_optim.learning_rate(jcfg, jnp.asarray(s, jnp.int32)))
        got = optim.learning_rate(tcfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


def test_other_optimizer_families_raise():
    params = {"w": torch.zeros(3)}
    for name in ("lars", "lamb", "adafactor"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            optim.sgd_init(params, OptimConfig(optimizer=name))
    with pytest.raises(ValueError, match="momentum"):
        optim.sgd_init(params, OptimConfig(optimizer="adamw", momentum=0.9))


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_adamw_update_matches_jax(wd):
    """Five AdamW steps on the same leaves and gradients: params and both
    moments within 1e-6 (the same f32 expression; pow and sqrt may differ
    by an ULP between the libraries)."""
    kw = dict(optimizer="adamw", learning_rate=1e-2, weight_decay=wd,
              schedule="cosine", warmup_steps=2, cosine_decay_steps=10,
              ema_decay=0.9)
    jcfg, tcfg = JaxOptimConfig(**kw), OptimConfig(**kw)
    params, _, _ = _leaves(7)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jax_optim.sgd_init(jp, jcfg)
    tp = _torch(params)
    tstate = optim.sgd_init(tp, tcfg)
    assert sorted(tstate) == sorted(jstate) == ["ema", "mu", "nu", "step"]
    for i in range(5):
        grads = _leaves(100 + i)[0]
        jp, jstate = jax_optim.sgd_update(
            jax.tree.map(jnp.asarray, grads), jstate, jp, jcfg)
        optim.sgd_update(_torch(grads), tstate, tp, tcfg)
    assert int(tstate["step"]) == int(jstate["step"]) == 5
    for got, want in ((tp, jp), (tstate["mu"], jstate["mu"]),
                      (tstate["nu"], jstate["nu"]),
                      (tstate["ema"], jstate["ema"])):
        for name in params:
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]), rtol=0,
                                       atol=1e-6, err_msg=name)
