"""PyTorch port, K5 and ring attention against the JAX package on the CPU.

- ``flash_attention_stats_plain`` — the plain version that K5 is held to
  on the card — against the JAX package's ``flash_attention_stats`` (the
  Pallas kernel in interpret mode) on masks a ring step produces: full,
  causal, window, a neighbour shard at ``kv_start = ±S`` and segment-id
  pairs. Pins: the normalized ``acc / l`` 5e-6, ``m`` 1e-5, ``l`` 1e-4.
  Rows with no live key are compared on ``m`` only (the Pallas kernel
  leaves ``l``/``acc`` undefined there); the port's are exactly 0.
- The port's ring over 2 and 4 spawned gloo ranks (seq only, and data 2 x
  seq 2) against JAX ``ring_attention`` on the same global q/k/v, value
  and gradients of ``sum(sin(out))``: out 2e-5 and grads 5e-5 (the pins
  of ``tests/test_ring_attention.py``), 1e-3 for large logits, 0.05 for
  bf16; one case with 128 local tokens runs the port's flash engine (the
  K5/K6/K7 wrappers) against the JAX ring on its Pallas kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from dml_cnn_cifar10_tpu.config import ParallelConfig as JaxParallelConfig
from dml_cnn_cifar10_tpu.ops import flash_attention as jax_fa
from dml_cnn_cifar10_tpu.parallel import mesh as jax_mesh
from dml_cnn_cifar10_tpu.parallel import ring_attention as jax_ring
from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
from dml_cnn_cifar10_tpu_torch.parallel import ring_attention as ring

torch.set_num_threads(2)

ACC_TOL, M_TOL, L_TOL = 5e-6, 1e-5, 1e-4
OUT_TOL, GRAD_TOL, LARGE_TOL, BF16_TOL = 2e-5, 5e-5, 1e-3, 0.05


def _normal(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _segments(b, s, seed):
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        for c in np.sort(rng.choice(np.arange(1, s), 2, replace=False)):
            seg[i, c:] += 1
    return seg


# K5 masks of one ring step at [1, 130, 2, 16]: the diagonal block (full,
# causal, window) and a neighbour shard 130 columns away (left: kv_start
# -130; right, bidirectional windows only: +130), with segment-id pairs.
STATS_CASES = {
    "full": dict(),
    "causal": dict(causal=True),
    "window": dict(window=50),
    "left_window": dict(window=60, kv_start=-130),
    "right_window": dict(window=60, kv_start=130),
    "segment_pair": dict(causal=True, segments=True),
}


@pytest.mark.parametrize("case", list(STATS_CASES))
def test_flash_stats_plain_matches_jax(case):
    kw = dict(STATS_CASES[case])
    q, k, v = (_normal((1, 130, 2, 16), seed) for seed in (1, 2, 3))
    seg = None
    if kw.pop("segments", False):
        seg = (_segments(1, 130, 4), _segments(1, 130, 5))
    jacc, jm, jl = (np.asarray(a) for a in jax_fa.flash_attention_stats(
        *map(jnp.asarray, (q, k, v)),
        segment_ids=None if seg is None else tuple(map(jnp.asarray, seg)),
        **kw))
    acc, m, l = (t.numpy() for t in fa.flash_attention_stats(
        *map(torch.from_numpy, (q, k, v)),
        segment_ids=None if seg is None else tuple(map(torch.from_numpy,
                                                       seg)), **kw))
    assert acc.dtype == m.dtype == l.dtype == np.float32
    dead = m <= fa.NEG_INF * 0.5
    np.testing.assert_array_equal(dead, jm <= fa.NEG_INF * 0.5)
    np.testing.assert_array_equal(m[dead], jm[dead])
    assert (l[dead] == 0).all() and (acc[dead] == 0).all()
    if case in ("left_window", "right_window"):
        assert dead.any() and not dead.all()
    live = ~dead
    np.testing.assert_allclose(m[live], jm[live], rtol=M_TOL, atol=M_TOL)
    np.testing.assert_allclose(l[live], jl[live], rtol=L_TOL, atol=L_TOL)
    np.testing.assert_allclose(acc[live] / l[live][:, None],
                               jacc[live] / jl[live][:, None],
                               rtol=ACC_TOL, atol=ACC_TOL)


# Ring cases: name -> (global [B, S, H, D], input scale, port kwargs, tol).
RING_CASES = {
    "full": ((2, 64, 2, 16), 1.0, dict(), OUT_TOL),
    "causal": ((2, 64, 2, 16), 1.0, dict(causal=True), OUT_TOL),
    "window": ((2, 64, 2, 16), 1.0, dict(window=16), OUT_TOL),
    "causal_window": ((2, 64, 2, 16), 1.0, dict(causal=True, window=12),
                      OUT_TOL),
    "large_logits": ((2, 64, 2, 16), 8.0, dict(), LARGE_TOL),
    "bf16": ((2, 64, 2, 16), 1.0, dict(dtype="bfloat16"), BF16_TOL),
    "flash_engine": ((1, 256, 2, 16), 1.0, dict(), OUT_TOL),
}
# (data, seq) topology -> cases it runs
TOPOLOGIES = {
    (1, 2): list(RING_CASES),
    (1, 4): ["full", "causal", "window"],
    (2, 2): ["full", "causal"],
}


def _ring_inputs(name):
    shape, scale, _, _ = RING_CASES[name]
    seed = sorted(RING_CASES).index(name)
    q = _normal(shape, 10 + seed, scale)
    k = _normal(shape, 20 + seed, scale)
    # V stays unit-scale so a saturation near-tie cannot dominate.
    v = _normal(shape, 30 + seed)
    return q, k, v


@pytest.fixture(scope="module")
def port_rings(tmp_path_factory):
    """Each topology's cases in one spawn: ``{(data, seq): {name: (out,
    dq, dk, dv)}}`` reassembled into global arrays."""
    res = {}
    for (data, seq), names in TOPOLOGIES.items():
        cases = [(n, *_ring_inputs(n), RING_CASES[n][2]) for n in names]
        ranks = _torch_dist.run_ranks(
            "ring_cases", data * seq,
            tmp_path_factory.mktemp(f"ring_{data}x{seq}"), seq, cases)
        res[(data, seq)] = {
            n: tuple(np.concatenate([np.concatenate(
                [ranks[d * seq + s][n][i] for s in range(seq)], axis=1)
                for d in range(data)], axis=0) for i in range(4))
            for n in names}
    return res


def _jax_ring(name, data, seq):
    q, k, v = _ring_inputs(name)
    kw = dict(RING_CASES[name][2])
    dtype = jnp.bfloat16 if kw.pop("dtype", None) == "bfloat16" \
        else jnp.float32
    mesh = jax_mesh.build_mesh(JaxParallelConfig(data_axis=data,
                                                 seq_axis=seq),
                               devices=jax.devices()[:data * seq])
    use_pallas = name == "flash_engine"

    @jax.jit
    def value_and_grads(q, k, v):
        out, vjp = jax.vjp(lambda *a: jax_ring.ring_attention(
            *a, mesh, use_pallas=use_pallas, **kw), q, k, v)
        # d sum(sin(out)) / d out, as the port's backward receives it
        return (out, *vjp(jnp.cos(out.astype(jnp.float32))
                          .astype(out.dtype)))

    res = value_and_grads(*(jnp.asarray(a, dtype) for a in (q, k, v)))
    return [np.asarray(t, np.float32) for t in res]


@pytest.mark.parametrize("topology,name", [
    (t, n) for t, names in TOPOLOGIES.items() for n in names],
    ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else x)
def test_ring_matches_jax(port_rings, topology, name):
    got = port_rings[topology][name]
    want = _jax_ring(name, *topology)
    tol = RING_CASES[name][3]
    assert np.isfinite(got[0]).all()
    for what, g, w, t in zip(("out", "dq", "dk", "dv"), got, want,
                             (tol,) + (max(tol, GRAD_TOL),) * 3):
        np.testing.assert_allclose(g, w, rtol=t, atol=t,
                                   err_msg=f"{topology} {name} {what}")


def test_ring_rejects_indivisible_seq_and_wide_windows():
    mesh = mesh_lib.Mesh(world=2, seq=2, seq_rank=1)
    with pytest.raises(ValueError, match="divisible"):
        ring.seq_shard(torch.zeros(1, 61, 2, 16), mesh)
    q = ring.seq_shard(torch.zeros(1, 64, 2, 16), mesh)
    assert q.shape == (1, 32, 2, 16)
    with pytest.raises(ValueError, match="exceeds the local shard"):
        ring.ring_attention_local(q, q, q, mesh, window=40)
