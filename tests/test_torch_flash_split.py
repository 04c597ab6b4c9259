"""The split-bf16 arithmetic of the flash kernels K3/K4/K5 (forward) and
K6/K7 (backward), emulated on the CPU and held against the JAX package.

``csrc/flash_attention.cu`` runs every product of ``flash_out_kernel``
(K3), ``flash_lse_kernel`` (K4), ``flash_stats_kernel`` (K5),
``flash_dq_kernel`` (K6) and ``flash_dkv_kernel`` (K7) on the tensor
cores as bf16 x bf16 with f32 accumulation. Operands that are not bf16 values are split into bf16 terms,
``x ≈ t0 + t1 + t2`` with ``t_i = bf16(x − t0 − … − t_{i−1})``, and a
product of two split operands keeps the term pairs ``(i, j)`` with
``i + j < max(terms of a, terms of b)``. By instance:

- f32 inputs: q, k, v and dO as three bf16 planes each (six products for
  every matrix product); P and dS as three terms.
- bf16 inputs, f32 gradients (the ring backward's ``out_dtype``): the
  first products are exact; P and dS as three terms.
- bf16 inputs, bf16 gradients, and the bf16 forward: P and dS rounded to
  bf16 once. K5 (the forward's stats mode, whose Pallas kernel keeps P in
  f32) takes ``kStatsBf16Terms`` = 3 P terms: one kept its normalized
  ``acc / l`` at about a tenth of the bf16 gate, but moved the 2-rank SP
  run's losses (``chip_smoke.py`` phase 19) past 1e-3 from the ring-free
  run's on the card.

This module repeats that arithmetic in plain torch (each term rounded by
``.to(torch.bfloat16)``, the products summed by f32 einsums) and holds it
against the JAX package's interpreted ``flash_attention_bwd``,
``flash_attention_fwd_lse`` and ``flash_attention_stats`` under the pins
the card holds the kernels to (``chip_smoke.py`` phases 10 and 16): 5e-5
on f32 gradients, 5e-6 on f32 out and on K5's ``acc / l``, 1e-5 on lse
and (relative) on K5's m and l, 1e-2 x max|reference| (at most 0.05) on
bf16 out, ``acc / l`` and gradients. Two f32 planes ("bf16x3") miss 5e-5 on causal head-dim-128
cases whose gradients reach ~5, and miss the forward's 5e-6 everywhere
(~2e-5), which is why f32 takes three; two P terms reach 6.6e-6 on out,
so the forward takes three as well. The term counts here must be the ones
the kernel source declares.

``PYTHONPATH=. python tests/test_torch_flash_split.py`` prints the
emulation's max abs difference from the port's plain f32 versions at [8,
257, 3, 64].
"""

import contextlib
import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu.ops import flash_attention as jax_fa
from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

GRAD_TOL, BF16_REL, BF16_CAP = 5e-5, 1e-2, 0.05
OUT_TOL, LSE_TOL = 5e-6, 1e-5
# bf16 terms per f32 operand, and P/dS terms for bf16 inputs with f32 or
# bf16 gradients: the kernel's kF32Planes, kRingTerms, kBf16Terms.
F32_PLANES, RING_TERMS, BF16_TERMS = 3, 3, 1
# The forward's f32 planes of q, k, v and terms of P (both kF32Planes in
# the source: FwdPlan's planes, and P as many terms as V has planes).
FWD_F32_PLANES, FWD_F32_P_TERMS = 3, 3
# P terms of K5 (the forward body's stats mode) with bf16 inputs: the
# kernel's kStatsBf16Terms. m and l are held 1e-5 relative.
STATS_BF16_TERMS, STATS_REL_TOL = 3, 1e-5

CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dml_cnn_cifar10_tpu_torch", "csrc", "flash_attention.cu")


def split(x: torch.Tensor, n: int):
    """``n`` bf16-valued f32 tensors whose sum approximates ``x``."""
    terms, rest = [], x.float()
    for _ in range(n):
        t = rest.to(torch.bfloat16).float()
        terms.append(t)
        rest = rest - t
    return terms


def product(eq: str, a_terms, b_terms) -> torch.Tensor:
    """Σ a_i ⊗ b_j over the pairs ``i + j < max(len(a), len(b))``."""
    n = max(len(a_terms), len(b_terms))
    return sum(torch.einsum(eq, a, b) for i, a in enumerate(a_terms)
               for j, b in enumerate(b_terms) if i + j < n)


def emulate_bwd(q, k, v, do, lse, delta, planes: int, p_terms: int,
                causal=False, window=None, kv_start=0):
    """``(dq, dk, dv)`` in f32 by the kernels' split products: q, k, v, dO
    as ``planes`` bf16 terms, P and dS as ``p_terms``."""
    d = q.shape[-1]
    scale = d ** -0.5
    qs, ks, vs, dos = (split(t, planes) for t in (q, k, v, do))
    live = fa._live(q.shape[1], k.shape[1], q.device, causal, window,
                    kv_start, None, None)
    s = product("bqhd,bkhd->bhqk", qs, ks) * scale
    lse_t = lse.float().permute(0, 2, 1)[..., None]
    delta_t = delta.float().permute(0, 2, 1)[..., None]
    p = torch.where(live, torch.exp(torch.where(live, s, fa.NEG_INF)
                                    - lse_t), 0.0)
    dp = product("bqhd,bkhd->bhqk", dos, vs)
    ds = p * (dp - delta_t) * scale
    pt, dst = split(p, p_terms), split(ds, p_terms)
    return (product("bhqk,bkhd->bqhd", dst, ks),
            product("bhqk,bqhd->bkhd", dst, qs),
            product("bhqk,bqhd->bkhd", pt, dos))


def emulate_fwd(q, k, v, planes: int, p_terms: int, causal=False,
                window=None, kv_start=0):
    """``(out, lse)`` in f32 by the forward kernels' split products: q, k,
    v as ``planes`` bf16 terms, ``P = exp(s − m)`` as ``p_terms``; ``l``
    sums the unrounded ``P``. Dead rows give out 0 and lse 1e30."""
    d = q.shape[-1]
    scale = d ** -0.5
    qs, ks, vs = (split(t, planes) for t in (q, k, v))
    live = fa._live(q.shape[1], k.shape[1], q.device, causal, window,
                    kv_start, None, None)
    s = torch.where(live, product("bqhd,bkhd->bhqk", qs, ks) * scale,
                    fa.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    dead = m <= fa.NEG_INF * 0.5
    acc = product("bhqk,bkhd->bhqd", split(p, p_terms), vs)
    out = torch.where(dead, 0.0, acc / l).permute(0, 2, 1, 3)
    lse = torch.where(dead, fa.DEAD_LSE, m + torch.log(l))[..., 0]
    return out, lse.permute(0, 2, 1)


def emulate_stats(q, k, v, planes: int, p_terms: int, causal=False,
                  window=None, kv_start=0):
    """K5's ``(acc, m, l)`` in f32 by the forward kernels' split products
    and its own epilogue: ``acc`` unnormalized (``P`` as ``p_terms`` bf16
    terms, no division, no rounding to the input dtype), ``m`` the row max
    of the scaled scores, ``l`` the sum of the unrounded ``P``. Dead rows
    give exactly ``m = -1e30``, ``l = 0``, ``acc = 0``. Layout ``[B, Sq,
    H, D]`` and ``[B, Sq, H]``, as the kernel writes them."""
    d = q.shape[-1]
    scale = d ** -0.5
    qs, ks, vs = (split(t, planes) for t in (q, k, v))
    live = fa._live(q.shape[1], k.shape[1], q.device, causal, window,
                    kv_start, None, None)
    s = torch.where(live, product("bqhd,bkhd->bhqk", qs, ks) * scale,
                    fa.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    acc = product("bhqk,bkhd->bhqd", split(p, p_terms), vs)
    return (acc.permute(0, 2, 1, 3), m[..., 0].permute(0, 2, 1),
            p.sum(dim=-1).permute(0, 2, 1))


def _inputs(shape, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=shape).astype(np.float32)
                   for _ in range(4))
    return q * np.float32(q_scale), k, v, do


# instance, shape [B, S, H, D], q scale, mask. The causal cases scale q so
# that rows with few live keys reach gradients of ~5, as the ring's window
# steps do on the card; there two f32 planes miss 5e-5 (~1e-4) and three
# stay near 8e-6.
CASES = {
    "f32_full": ("f32", (2, 130, 2, 64), 1.0, {}),
    "f32_causal_d128": ("f32", (2, 96, 1, 128), 2.0, {"causal": True}),
    "ring_causal": ("bf16_f32", (1, 192, 2, 64), 3.0, {"causal": True}),
    "ring_window": ("bf16_f32", (1, 192, 2, 64), 3.0,
                    {"window": 24, "kv_start": -40, "causal": True}),
    "bf16_full": ("bf16", (2, 130, 2, 64), 1.0, {}),
    "bf16_causal": ("bf16", (1, 192, 2, 64), 3.0, {"causal": True}),
}
TERMS = {"f32": (F32_PLANES, F32_PLANES), "bf16_f32": (1, RING_TERMS),
         "bf16": (1, BF16_TERMS)}


@pytest.mark.parametrize("case", list(CASES))
def test_split_products_match_jax_bwd(case):
    inst, shape, q_scale, kw = CASES[case]
    q, k, v, do = _inputs(shape, seed=len(case), q_scale=q_scale)
    jd = jnp.float32 if inst == "f32" else jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jd) for a in (q, k, v, do))
    jout, jlse = jax_fa.flash_attention_fwd_lse(jq, jk, jv, **kw)
    jdelta = jax_fa.attention_delta(jout, jdo)
    out_dtype = jnp.float32 if inst == "bf16_f32" else None
    want = jax_fa.flash_attention_bwd(jq, jk, jv, jdo, jlse, jdelta,
                                      out_dtype=out_dtype, **kw)
    planes, p_terms = TERMS[inst]
    tq, tk, tv, tdo = (torch.from_numpy(np.array(a, np.float32))
                       for a in (jq, jk, jv, jdo))
    lse = torch.from_numpy(np.array(jlse, np.float32))
    delta = torch.from_numpy(np.array(jdelta, np.float32))
    got = emulate_bwd(tq, tk, tv, tdo, lse, delta, planes, p_terms, **kw)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w, np.float32)
        if inst == "bf16":
            g = g.to(torch.bfloat16).float()
            tol = min(BF16_CAP, BF16_REL * float(np.abs(w).max()))
        else:
            tol = GRAD_TOL
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol,
                                   err_msg=f"{case}: d{name}")
    if inst == "bf16_f32":   # the case is as hard as the ring's windows
        assert max(float(np.abs(np.asarray(w)).max()) for w in want) > 3.0


# instance, shape [B, S, H, D], q scale, mask. q x 3 makes the softmax
# peaky, where two P terms miss the out pin (6.6e-6 on "f32_window").
FWD_CASES = {
    "f32_full": ("f32", (2, 130, 2, 64), 3.0, {}),
    "f32_causal_d128": ("f32", (2, 96, 1, 128), 2.0, {"causal": True}),
    "f32_window": ("f32", (1, 192, 2, 64), 3.0,
                   {"window": 24, "kv_start": -40, "causal": True}),
    "bf16_full": ("bf16", (2, 130, 2, 64), 3.0, {}),
    "bf16_causal_d128": ("bf16", (2, 96, 1, 128), 2.0, {"causal": True}),
    "bf16_window": ("bf16", (1, 192, 2, 64), 3.0, {"window": 24}),
}


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_split_products_match_jax_fwd(case):
    inst, shape, q_scale, kw = FWD_CASES[case]
    q, k, v, _ = _inputs(shape, seed=len(case), q_scale=q_scale)
    jd = jnp.float32 if inst == "f32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    jout, jlse = jax_fa.flash_attention_fwd_lse(jq, jk, jv, **kw)
    want = np.asarray(jout.astype(jnp.float32))
    want_lse = np.asarray(jlse)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  for a in (jq, jk, jv))
    planes, p_terms = ((FWD_F32_PLANES, FWD_F32_P_TERMS) if inst == "f32"
                       else (1, 1))
    out, lse = emulate_fwd(tq, tk, tv, planes, p_terms, **kw)
    if inst == "bf16":
        out = out.to(torch.bfloat16).float()
        tol = min(BF16_CAP, BF16_REL * float(np.abs(want).max()))
    else:
        tol = OUT_TOL
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=tol,
                               err_msg=f"{case}: out")
    dead = want_lse >= 1e29
    assert np.array_equal(lse.numpy() >= 1e29, dead), f"{case}: dead rows"
    np.testing.assert_allclose(lse.numpy()[~dead], want_lse[~dead], rtol=0,
                               atol=LSE_TOL, err_msg=f"{case}: lse")


# K5's cases: instance, shape [B, S, H, D], q scale, mask. "left"/"right"
# are a ring step's neighbour shards (kv_start = -S / +S): a window of 24
# leaves every row but the 23 nearest the seam with no live key; "dead"
# shifts the causal band so the first 64 rows see none.
STATS_CASES = {
    "bf16_full": ("bf16", (2, 130, 2, 64), 3.0, {}),
    "bf16_causal": ("bf16", (1, 192, 2, 64), 3.0, {"causal": True}),
    "bf16_left": ("bf16", (1, 192, 2, 64), 3.0,
                  {"window": 24, "kv_start": -192}),
    "bf16_right": ("bf16", (1, 192, 2, 64), 3.0,
                   {"window": 24, "kv_start": 192}),
    "f32_causal_d128": ("f32", (2, 96, 1, 128), 2.0, {"causal": True}),
    "bf16_dead": ("bf16", (1, 192, 2, 64), 1.0,
                  {"causal": True, "kv_start": 64}),
    "f32_dead": ("f32", (1, 192, 2, 64), 1.0,
                 {"causal": True, "kv_start": 64}),
}


@pytest.mark.parametrize("case", list(STATS_CASES))
def test_split_products_match_jax_stats(case):
    """K5 by its split products and epilogue against the JAX package's
    interpreted ``flash_attention_stats``, at ``chip_smoke.py``'s phase-16
    pins: the normalized ``acc / l`` 5e-6 in f32 and 1e-2 x max|ref| in
    bf16; m and l 1e-5 relative; dead rows exact (the Pallas kernel
    leaves their l and acc undefined, so only its m is compared there)."""
    inst, shape, q_scale, kw = STATS_CASES[case]
    q, k, v, _ = _inputs(shape, seed=len(case), q_scale=q_scale)
    jd = jnp.float32 if inst == "f32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    jacc, jm, jl = (np.asarray(t, np.float32) for t in
                    jax_fa.flash_attention_stats(jq, jk, jv, **kw))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  for a in (jq, jk, jv))
    planes, p_terms = ((FWD_F32_PLANES, FWD_F32_P_TERMS) if inst == "f32"
                       else (1, STATS_BF16_TERMS))
    acc, m, l = (t.numpy() for t in emulate_stats(tq, tk, tv, planes,
                                                  p_terms, **kw))
    dead = jm <= fa.NEG_INF * 0.5
    assert np.array_equal(m <= fa.NEG_INF * 0.5, dead), f"{case}: dead rows"
    assert (m[dead] == fa.NEG_INF).all() and (l[dead] == 0).all()
    assert (acc[dead] == 0).all(), f"{case}: dead acc"
    if "dead" in case or "kv_start" in kw:
        assert dead.any() and not dead.all(), f"{case}: no dead rows"
    live = ~dead
    out, want = acc[live] / l[live][:, None], jacc[live] / jl[live][:, None]
    tol = (OUT_TOL if inst == "f32"
           else min(BF16_CAP, BF16_REL * float(np.abs(want).max())))
    np.testing.assert_allclose(out, want, rtol=0, atol=tol,
                               err_msg=f"{case}: acc / l")
    np.testing.assert_allclose(m[live], jm[live], rtol=STATS_REL_TOL,
                               atol=STATS_REL_TOL, err_msg=f"{case}: m")
    np.testing.assert_allclose(l[live], jl[live], rtol=STATS_REL_TOL,
                               atol=0, err_msg=f"{case}: l")


def test_rows_the_async_copies_cannot_take_are_copied_once(monkeypatch):
    """Every flash kernel, K5 included, reads its tiles with 16-byte
    ``cp.async`` copies, so the wrappers hand them tensors whose base and
    B/S/H strides are 16-byte multiples: the ViT's views of a fused qkv
    pass as they are; a view 4 bytes past its allocation becomes one
    contiguous copy."""
    for dtype in (torch.float32, torch.bfloat16):
        k = torch.randn(2, 257, 3, 3, 64).to(dtype).unbind(3)[1]
        assert fa._aligned16(k) is k
    flat = torch.randn(1 + 2 * 257 * 3 * 64)
    off = flat[1:].view(2, 257, 3, 64)
    got = fa._aligned16(off)
    assert got is not off and got.is_contiguous()
    assert got.data_ptr() % 16 == 0 and torch.equal(got, off)

    # The forward wrapper on the CPU, with a library that records the
    # pointers each C entry point is given.
    calls = []

    class Lib:
        def __getattr__(self, fn_name):
            def fn(*args):
                calls.append((fn_name, args[:3]))
                return 0
            return fn

    aligned, copies = fa._aligned16, []

    def aligned16(t):
        got = aligned(t)
        copies.append(got is not t)
        return got

    monkeypatch.setattr(fa, "_aligned16", aligned16)
    monkeypatch.setattr(fa, "_lib", Lib)
    monkeypatch.setattr(fa, "_check", lambda *args: None)
    monkeypatch.setattr(fa, "LAUNCHES", dict(fa.LAUNCHES))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    fused = torch.randn(2, 257, 3, 3, 64).unbind(3)
    for mode in ("out", "lse", "stats"):
        calls.clear()
        copies.clear()
        fa._fwd_launch(*fused, 0.125, False, None, 0, None, None, mode)
        assert calls[0][1] == tuple(t.data_ptr() for t in fused), mode
        assert not any(copies), mode
        calls.clear()
        copies.clear()
        fa._fwd_launch(off, *fused[1:], 0.125, False, None, 0, None, None,
                       mode)
        (fn_name, (qp, kp, vp)), = calls
        assert (kp, vp) == (fused[1].data_ptr(), fused[2].data_ptr())
        assert qp != off.data_ptr() and qp % 16 == 0, mode
        assert copies == [True, False, False], mode


def test_term_counts_are_the_kernels():
    """The emulated term counts are the ones the kernels are built with:
    the backward's constants, and the forward's planes (the tile plan's
    ``kNP``: kF32Planes for f32, 1 for bf16) with P split into as many
    terms as V has planes, except K5's bf16 instance, which takes
    kStatsBf16Terms."""
    with open(CU) as f:
        src = f.read()
    for name, want in (("kF32Planes", F32_PLANES), ("kRingTerms", RING_TERMS),
                       ("kBf16Terms", BF16_TERMS),
                       ("kStatsBf16Terms", STATS_BF16_TERMS)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == want, name
    assert re.search(r"kNP = kF32 \? kF32Planes : 1;", src)
    assert FWD_F32_PLANES == FWD_F32_P_TERMS == F32_PLANES
    body = src[src.index("void flash_fwd_tc("):]
    body = body[:body.index("\n}\n")]
    assert "using P = FwdPlan<T, D>;" in body
    assert ("constexpr int NT = P::kF32 ? NP : (Mode == kStats ? "
            "kStatsBf16Terms : 1);") in body
    assert "accumulate<D, NT, P>(" in body
    assert "accumulate<D, NP, P>(" not in body
    # K5 is that body's stats mode; the CUDA-core forward is gone.
    assert "flash_fwd_tc<T, D, kStats>(a);" in src
    assert "flash_fwd<" not in src


def test_ab_tool_refuses_without_a_card(capsys, monkeypatch):
    """``tools/flash_ab.py``, the A/B timing of two versions of the flash
    kernels, exits 1 with a message and builds nothing where no card is
    present."""
    from dml_cnn_cifar10_tpu_torch.tools import flash_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(fa, "_LIB", None)
    assert flash_ab.main(["--other", CU]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
    assert fa._LIB is None


def main() -> None:
    """The emulation against the port's plain f32 forward and backward
    (the card's reference) at [8, 257, 3, 64], for each instance and term
    count."""
    for inst, planes, p_terms, q_scale, causal in (
            ("f32", 2, 2, 1.0, False), ("f32", 3, 2, 1.0, False),
            ("f32", 3, 3, 1.0, False), ("f32", 3, 2, 3.0, True),
            ("f32", 3, 3, 3.0, True), ("bf16", 1, 1, 3.0, True)):
        q, k, v, _ = (torch.from_numpy(a) for a in
                      _inputs((8, 257, 3, 64), seed=0, q_scale=q_scale))
        if inst != "f32":
            q, k, v = (t.to(torch.bfloat16).float() for t in (q, k, v))
        want, want_lse = fa.flash_attention_plain(q, k, v, causal=causal)
        got, lse = emulate_fwd(q, k, v, planes, p_terms, causal=causal)
        if inst == "bf16":
            got = got.to(torch.bfloat16).float()
        print(f"fwd {inst:4s} q x {q_scale} planes {planes} P terms "
              f"{p_terms} causal {causal}: max abs diff out "
              f"{(got - want).abs().max().item():.3g}, lse "
              f"{(lse - want_lse).abs().max().item():.3g}; max |out| "
              f"{want.abs().max().item():.3g}")
    for inst, planes, p_terms, q_scale, causal in (
            ("bf16", 1, 1, 1.0, False), ("bf16", 1, 3, 1.0, False),
            ("bf16", 1, 1, 3.0, True), ("bf16", 1, 3, 3.0, True),
            ("f32", 3, 3, 3.0, True)):
        q, k, v, _ = (torch.from_numpy(a) for a in
                      _inputs((8, 257, 3, 64), seed=0, q_scale=q_scale))
        if inst != "f32":
            q, k, v = (t.to(torch.bfloat16).float() for t in (q, k, v))
        pacc, pm, pl = fa.flash_attention_stats_plain(q, k, v, causal=causal)
        acc, m, l = emulate_stats(q, k, v, planes, p_terms, causal=causal)
        want = pacc / pl[..., None]
        print(f"stats {inst:4s} q x {q_scale} P terms {p_terms} causal "
              f"{causal}: max abs diff acc / l "
              f"{(acc / l[..., None] - want).abs().max().item():.3g} (bf16 "
              f"gate {BF16_REL * want.abs().max().item():.3g}), m rel "
              f"{((m - pm).abs() / pm.abs().clamp_min(1.0)).max().item():.3g}"
              f", l rel {((l - pl).abs() / pl).max().item():.3g}")
    for inst, planes, p_terms, q_scale, causal in (
            ("f32", 2, 2, 1.0, False), ("f32", 3, 3, 1.0, False),
            ("f32", 2, 2, 1.0, True), ("f32", 3, 3, 1.0, True),
            ("bf16_f32", 1, 3, 3.0, True), ("bf16", 1, 1, 3.0, True)):
        q, k, v, do = (torch.from_numpy(a) for a in
                       _inputs((8, 257, 3, 64), seed=0, q_scale=q_scale))
        if inst != "f32":
            q, k, v, do = (t.to(torch.bfloat16).float() for t in (q, k, v, do))
        out, lse = fa.flash_attention_plain(q, k, v, causal=causal)
        delta = fa.attention_delta(out, do)
        want = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                            causal=causal)
        got = emulate_bwd(q, k, v, do, lse, delta, planes, p_terms,
                          causal=causal)
        if inst == "bf16":
            got = [g.to(torch.bfloat16).float() for g in got]
            want = [w.to(torch.bfloat16).float() for w in want]
        print(f"{inst:8s} planes {planes} P/dS terms {p_terms} causal "
              f"{causal}: max abs diff dq/dk/dv "
              + ", ".join(f"{(g - w).abs().max().item():.3g}"
                          for g, w in zip(got, want))
              + "; max |grad| "
              + ", ".join(f"{w.abs().max().item():.3g}" for w in want))


if __name__ == "__main__":
    main()
