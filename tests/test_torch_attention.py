"""PyTorch port, ops/flash_attention.py + ops/attention.py against the JAX
package on the CPU.

The same seeded numpy inputs go through the JAX functions — the Pallas
flash kernels in interpret mode, as the JAX package's own tests run them
off-TPU — and the port, whose wrappers take their plain versions for CPU
tensors (the CUDA kernels are held to those same plain versions on the
card by ``chip_smoke.py``). Tolerances are the JAX package's own pins for
its flash kernels (``tests/test_flash_backward.py``): out 5e-6, lse 1e-5
and gradients 5e-5 in f32; 0.05 with bf16 inputs and outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu.ops import attention as jax_attn
from dml_cnn_cifar10_tpu.ops import flash_attention as jax_fa
from dml_cnn_cifar10_tpu_torch.ops import attention as attn
from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

OUT_TOL, LSE_TOL, GRAD_TOL, BF16_TOL = 5e-6, 1e-5, 5e-5, 0.05


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_exp():
    """One ``torch.exp`` before the module's tests: with torch 2.13.0+cpu
    (MKL 2024.2, AVX-512) the first ``exp`` of a freshly started worker
    process can be off by 1.5e-4 relative when several workers start
    together, and is exact from the second call on (ROADMAP.md Queue 3)."""
    torch.exp(torch.linspace(-10.0, 0.0, 1 << 16))


def _inputs(shape, seed, kv_len=None, n=3):
    rng = np.random.default_rng(seed)
    kv_shape = shape if kv_len is None else (shape[0], kv_len, *shape[2:])
    return [rng.normal(size=shape if i == 0 else kv_shape)
            .astype(np.float32) for i in range(n)]


def _segments(b, s, seed):
    """Packed-sequence ids: each row of the batch cut into 2-4 segments."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(1, s), rng.integers(1, 4),
                                  replace=False))
        for c in cuts:
            seg[i, c:] += 1
    return seg


MASKS = {
    "full": dict(),
    "causal": dict(causal=True),
    "window": dict(window=40),
    "segments": dict(segments=True),
    "window_segments": dict(window=40, segments=True),
}


def _mask_kw(case, b, s, seed):
    kw = dict(MASKS[case])
    seg = _segments(b, s, seed) if kw.pop("segments", False) else None
    return kw, seg


def _jax_grads(f, arrays):
    # sin() keeps the cotangent varied in sign and size.
    return jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))),
                    argnums=tuple(range(len(arrays))))(*arrays)


def _torch_grads(f, arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = f(*ts)
    torch.sin(out).sum().backward()
    return out, [t.grad for t in ts]


@pytest.mark.parametrize("s", [128, 300])
@pytest.mark.parametrize("case", list(MASKS))
def test_flash_attention_value_and_grads_match_jax(s, case):
    q, k, v = _inputs((2, s, 2, 32), seed=s)
    kw, seg = _mask_kw(case, 2, s, seed=1)
    jseg = None if seg is None else jnp.asarray(seg)
    tseg = None if seg is None else torch.from_numpy(seg)
    want = jax_fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), segment_ids=jseg, **kw)
    jgrads = _jax_grads(lambda *a: jax_fa.flash_attention(
        *a, segment_ids=jseg, **kw), [jnp.asarray(a) for a in (q, k, v)])
    out, grads = _torch_grads(lambda *t: fa.flash_attention(
        *t, segment_ids=tseg, **kw), [q, k, v])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=OUT_TOL)
    for name, g, w in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("kw", [
    dict(kv_start=0),
    dict(kv_start=64, causal=True),
    dict(kv_start=-100, window=60),
    dict(kv_start=150, causal=True, window=80, segments=True),
], ids=["plain", "causal_shift", "window_shift", "all"])
def test_fwd_lse_matches_jax(kw):
    kw = dict(kw)
    q, k, v = _inputs((2, 200, 2, 32), seed=3, kv_len=160)
    seg = None
    if kw.pop("segments", False):
        seg = (_segments(2, 200, 4), _segments(2, 160, 5))
    jout, jlse = jax_fa.flash_attention_fwd_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segment_ids=None if seg is None else tuple(map(jnp.asarray, seg)),
        **kw)
    out, lse = fa.flash_attention_fwd_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        segment_ids=None if seg is None else tuple(map(torch.from_numpy,
                                                       seg)), **kw)
    assert lse.dtype == torch.float32 and lse.shape == (2, 200, 2)
    jlse = np.asarray(jlse)
    dead = jlse == fa.DEAD_LSE
    np.testing.assert_array_equal(lse.numpy() == fa.DEAD_LSE, dead)
    np.testing.assert_allclose(lse.numpy()[~dead], jlse[~dead], rtol=0,
                               atol=LSE_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=OUT_TOL)
    assert np.all(out.numpy()[dead] == 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_standalone_out_dtype_f32(dtype):
    """The ring-backward interface: gradients from caller-held lse/delta,
    written in f32 whatever the input dtype."""
    q, k, v, do = _inputs((1, 256, 2, 64), seed=6, n=4)
    kw = dict(causal=True, window=100, kv_start=0)
    jd = jnp.dtype(dtype)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jd) for a in (q, k, v, do))
    jout, jlse = jax_fa.flash_attention_fwd_lse(jq, jk, jv, **kw)
    jdelta = jax_fa.attention_delta(jout, jdo)
    want = jax_fa.flash_attention_bwd(jq, jk, jv, jdo, jlse, jdelta,
                                      out_dtype=jnp.float32, **kw)
    td = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(td) for a in (q, k, v, do))
    out, lse = fa.flash_attention_fwd_lse(tq, tk, tv, **kw)
    delta = fa.attention_delta(out, tdo)
    got = fa.flash_attention_bwd(tq, tk, tv, tdo, lse, delta,
                                 out_dtype=torch.float32, **kw)
    tol = GRAD_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), rtol=0,
                               atol=tol)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol, err_msg=f"d{name}")


def test_fully_dead_rows_are_zero_with_finite_inert_grads():
    """Cross lengths under a window leave query rows with no key at all:
    they output exactly 0 and publish lse 1e30, so their cotangents leak
    into no gradient (``test_flash_backward.py``'s dead-row test)."""
    q = _inputs((1, 512, 1, 64), seed=7, n=1)[0]
    k, v = _inputs((1, 128, 1, 64), seed=8, n=2)
    out, lse = fa.flash_attention_fwd_lse(*map(torch.from_numpy, (q, k, v)),
                                          window=64)
    assert torch.all(out[:, 256:] == 0) and torch.all(lse[:, 256:] == 1e30)
    want = jax_fa.flash_attention(*map(jnp.asarray, (q, k, v)), window=64)
    np.testing.assert_array_equal(np.asarray(want)[:, 256:], 0.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=OUT_TOL)
    _, grads = _torch_grads(
        lambda *t: fa.flash_attention(*t, window=64), [q, k, v])
    assert all(torch.isfinite(g).all() for g in grads)
    _, live = _torch_grads(
        lambda *t: fa.flash_attention(*t, window=64)[:, :190], [q, k, v])
    ref = _jax_grads(lambda *a: jax_attn.xla_attention(*a, window=64)[:, :190],
                     [jnp.asarray(a) for a in (q, k, v)])
    for name, g, w in zip("qkv", live, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=OUT_TOL, err_msg=f"d{name}")


def test_bf16_inputs_and_outputs():
    q, k, v = _inputs((1, 256, 2, 32), seed=9)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax_fa.flash_attention(jq, jk, jv, causal=True)
    jgrads = _jax_grads(lambda *a: jax_fa.flash_attention(*a, causal=True),
                        [jq, jk, jv])
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
          for a in (q, k, v)]
    out = fa.flash_attention(*ts, causal=True)
    torch.sin(out.float()).sum().backward()
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=BF16_TOL)
    for name, t, w in zip("qkv", ts, jgrads):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(w, np.float32), rtol=0,
                                   atol=BF16_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", list(MASKS))
def test_xla_attention_and_mask_scores_match_jax(case):
    q, k, v = _inputs((2, 37, 3, 16), seed=10)
    kw, seg = _mask_kw(case, 2, 37, seed=11)
    jseg = None if seg is None else jnp.asarray(seg)
    tseg = None if seg is None else torch.from_numpy(seg)
    want = jax_attn.xla_attention(*map(jnp.asarray, (q, k, v)),
                                  segment_ids=jseg, **kw)
    got = attn.xla_attention(*map(torch.from_numpy, (q, k, v)),
                             segment_ids=tseg, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OUT_TOL)
    scores = np.random.default_rng(12).normal(size=(2, 3, 37, 37)) \
        .astype(np.float32)
    jm = jax_attn.mask_scores(jnp.asarray(scores), 37, 37, segment_ids=jseg,
                              kv_start=5, **kw)
    tm = attn.mask_scores(torch.from_numpy(scores), 37, 37,
                          segment_ids=tseg, kv_start=5, **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_dispatch_routes_by_sequence_length(monkeypatch):
    """``seq >= 128`` takes the flash kernels; shorter sequences take the
    dense path."""
    calls = []
    real = fa.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    for s, flash in ((37, False), (127, False), (128, True), (300, True)):
        q, k, v = map(torch.from_numpy, _inputs((1, s, 2, 32), seed=s))
        before = len(calls)
        out = attn.dispatch_attention(q, k, v, causal=True)
        assert calls[before:] == ([s] if flash else []), s
        np.testing.assert_allclose(
            out.numpy(), attn.xla_attention(q, k, v, causal=True).numpy(),
            rtol=0, atol=OUT_TOL)


def test_cpu_tensors_launch_no_kernel_and_bad_windows_raise():
    fa.reset_launches()
    q, k, v = _inputs((1, 130, 2, 32), seed=13)
    _, grads = _torch_grads(lambda *t: fa.flash_attention(*t, causal=True),
                            [q, k, v])
    with torch.no_grad():
        fa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert sum(fa.LAUNCHES.values()) == 0 and fa._LIB is None
    for bad in (0, -3):
        with pytest.raises(ValueError, match="window"):
            fa.flash_attention(*map(torch.from_numpy, (q, k, v)), window=bad)
        with pytest.raises(ValueError, match="window"):
            attn.xla_attention(*map(torch.from_numpy, (q, k, v)), window=bad)
