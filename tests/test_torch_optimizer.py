"""PyTorch port, ops/optimizer.py + train/optim.py, against the JAX package.

The plain PyTorch version of the fused SGD kernels (K1 ``_sgd_kernel_plain``,
K2 ``_sgd_kernel``) is held against the JAX package's Pallas kernel run in
interpret mode and against its XLA form ``_xla_leaf``, on the tile-hostile
leaf shapes of ``tests/test_zero1.py:_leaves``. Tolerance: 5e-7 absolute
(PARITY.md's pin for the kernel vs its fallback: separate roundings vs a
possible FMA contraction, a few f32 ULPs, no reductions). The wrapper's
grouping of leaves into K1 and K2 launches is checked with a library
that records its calls.
"""

import contextlib
import math
import os
import re
import types

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
    """The families without a momentum knob refuse one (as the JAX
    package's do), and an unknown family raises; lars, lamb and adafactor
    build the JAX package's state keys (their updates are held to JAX in
    ``tests/test_torch_optim_surface.py``)."""
    params = {"w": torch.zeros(3), "k": torch.zeros(4, 5)}
    for name in ("adamw", "lamb", "adafactor"):
        with pytest.raises(ValueError, match="momentum"):
            optim.sgd_init(params, OptimConfig(optimizer=name, momentum=0.9))
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.sgd_init(params, OptimConfig(optimizer="adagrad"))
    keys = {name: sorted(optim.sgd_init(params, OptimConfig(optimizer=name)))
            for name in ("lars", "lamb", "adafactor")}
    assert keys == {"lars": ["momentum", "step"],
                    "lamb": ["mu", "nu", "step"],
                    "adafactor": ["step", "v", "vc", "vr"]}


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


SGD_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dml_cnn_cifar10_tpu_torch", "csrc", "sgd_update.cu")


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``, so that the wrapper routes it
    as it routes a leaf on the card (to a recording library here)."""

    @property
    def is_cuda(self):
        return True


class _RecordingLib:
    """Records every K1/K2 call with the table it was given."""

    def __init__(self):
        self.calls = []

    def sgd_update_plain(self, lr, p, g, n, leaves, wd, stream):
        self.calls.append(dict(kind="plain", p=list(p[:leaves]),
                               g=list(g[:leaves]), m=None,
                               n=list(n[:leaves]), leaves=leaves, mu=None,
                               wd=wd))
        return 0

    def sgd_update_momentum(self, lr, p, g, m, n, leaves, mu, wd, stream):
        self.calls.append(dict(kind="momentum", p=list(p[:leaves]),
                               g=list(g[:leaves]), m=list(m[:leaves]),
                               n=list(n[:leaves]), leaves=leaves, mu=mu,
                               wd=wd))
        return 0


@pytest.fixture
def recording_lib(monkeypatch):
    lib = _RecordingLib()
    monkeypatch.setattr(fused, "_lib", lambda: lib)
    monkeypatch.setattr(fused, "LAUNCHES", dict.fromkeys(fused.LAUNCHES, 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    return lib


def _card_leaves(n_leaves, seed):
    """``n_leaves`` f32 leaves "on the card" of a few sizes, one of them
    empty, plus one bf16 leaf; and their gradients."""
    rng = np.random.default_rng(seed)
    params, grads = {}, {}
    for i in range(n_leaves):
        shape = (0,) if i == 1 else ((37,), (130, 7), (5,))[i % 3]
        params[f"l{i}"], grads[f"l{i}"] = (
            torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .as_subclass(_OnCard) for _ in range(2))
    params["bf16"], grads["bf16"] = (
        torch.from_numpy(rng.normal(size=(9,)).astype(np.float32))
        .to(torch.bfloat16).as_subclass(_OnCard) for _ in range(2))
    return params, grads


@pytest.mark.parametrize("n_leaves", [10, 65, 130])
@pytest.mark.parametrize("kind", ["plain", "momentum"])
def test_k1_takes_every_f32_leaf_of_a_step_in_one_launch_per_table(
        recording_lib, kind, n_leaves):
    """K1 (plain) and K2 (momentum) get the step's non-empty f32 leaves in
    order, at most MAX_LEAVES a call: one call for the CNN's 10,
    ceil(n / MAX_LEAVES) beyond; K2's table also holds the momentum
    buffers. The empty leaf is skipped, the bf16 leaf takes the plain
    version, and LAUNCHES counts calls."""
    params, grads = _card_leaves(n_leaves, seed=n_leaves)
    mu = 0.9 if kind == "momentum" else 0.0
    moms = ({k: (v + 1).as_subclass(_OnCard) for k, v in grads.items()}
            if mu else None)
    lr = torch.tensor([0.05]).as_subclass(_OnCard)
    bf16_want, bf16_m_want = fused.fused_sgd_update_plain(
        params["bf16"].clone(), grads["bf16"],
        moms["bf16"].clone() if mu else None, lr, mu, 5e-4)
    fused.fused_sgd_update(params, grads, moms, lr, mu, 5e-4)
    live = [k for k in params if k != "bf16" and params[k].numel()]
    want = [live[i:i + fused.MAX_LEAVES]
            for i in range(0, len(live), fused.MAX_LEAVES)]
    assert len(recording_lib.calls) == len(want) == math.ceil(
        (n_leaves - 1) / fused.MAX_LEAVES)
    for call, names in zip(recording_lib.calls, want):
        assert call["kind"] == kind and call["wd"] == 5e-4
        assert call["leaves"] == len(names)
        assert call["p"] == [params[k].data_ptr() for k in names]
        assert call["g"] == [grads[k].data_ptr() for k in names]
        assert call["n"] == [params[k].numel() for k in names]
        if mu:
            assert call["m"] == [moms[k].data_ptr() for k in names]
            assert call["mu"] == 0.9
        else:
            assert call["m"] is None
    name = f"sgd_update_{kind}"
    assert fused.LAUNCHES == {**dict.fromkeys(fused.LAUNCHES, 0),
                              name: len(want)}
    # The wrapper copies the plain version's result into the bf16 leaf.
    assert torch.equal(params["bf16"], bf16_want.to(torch.bfloat16))
    if mu:
        assert torch.equal(moms["bf16"], bf16_m_want.to(torch.bfloat16))


REFUSALS = ([(what, kind) for kind in ("plain", "momentum")
             for what in ("non-contiguous leaf", "lr of two values",
                          "gradient of another shape")]
            + [("momentum of another shape", "momentum"),
               ("non-contiguous momentum", "momentum")])


@pytest.mark.parametrize("what,kind", REFUSALS)
def test_k1_refuses_what_it_cannot_take(recording_lib, what, kind):
    """No fallback: a leaf on the card that K1 or K2 cannot take raises,
    and nothing is launched."""
    params, grads = _card_leaves(3, seed=2)
    del params["bf16"], grads["bf16"]
    moms = ({k: torch.zeros_like(v) for k, v in params.items()}
            if kind == "momentum" else None)
    lr = torch.tensor(0.05).as_subclass(_OnCard)
    if what == "non-contiguous leaf":
        params["l0"] = torch.zeros(8, 9).t().as_subclass(_OnCard)
        grads["l0"] = torch.zeros(9, 8).as_subclass(_OnCard)
        if moms is not None:
            moms["l0"] = torch.zeros(9, 8).as_subclass(_OnCard)
    elif what == "lr of two values":
        lr = torch.tensor([0.05, 0.1]).as_subclass(_OnCard)
    elif what == "gradient of another shape":
        grads["l2"] = torch.zeros(6).as_subclass(_OnCard)
    elif what == "momentum of another shape":
        moms["l2"] = torch.zeros(6).as_subclass(_OnCard)
    else:
        moms["l0"] = torch.zeros(37, 2)[:, 0].as_subclass(_OnCard)
    with pytest.raises(ValueError):
        fused.fused_sgd_update(params, grads, moms, lr,
                               0.9 if moms else 0.0, 0.0)
    assert recording_lib.calls == [] and sum(fused.LAUNCHES.values()) == 0


@pytest.mark.parametrize("entry", ["sgd_update_plain",
                                   "sgd_update_momentum"])
def test_max_leaves_is_the_kernels(entry):
    """MAX_LEAVES is the source's kMaxLeaves, and each C entry reaches the
    one launcher, which refuses more leaves than that and sizes the
    table by it."""
    with open(SGD_CU) as f:
        src = f.read()
    m = re.findall(r"constexpr int kMaxLeaves = (\d+);", src)
    assert m == [str(fused.MAX_LEAVES)]
    body = re.search(r"int %s\([^)]*\) \{(.*?)\n\}" % entry, src, re.S)
    kind = "true" if entry == "sgd_update_momentum" else "false"
    assert body and f"launch_multi<{kind}>(" in body.group(1)
    launcher = re.search(r"int launch_multi\(.*?\n\}", src, re.S).group(0)
    assert "leaves > kMaxLeaves" in launcher
    assert "L leaf[kMaxLeaves];" in src
