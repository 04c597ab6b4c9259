"""PyTorch port, Ulysses sequence parallelism against the JAX package on
the CPU.

- The port's ``ulysses_attention_local`` over 2 and 4 spawned gloo ranks
  (seq only, and data 2 x seq 2; ``tests/_torch_dist.py``) against JAX
  ``ulysses_attention`` on the same global q/k/v, value and gradients of
  ``sum(sin(out))``: out 2e-5 and grads 5e-5 (the pins of
  ``tests/test_torch_ring_attention.py``), 0.05 for bf16. Heads 4 (one a
  rank at seq 4, so a wrong head or chunk order shows), head dim 16 or 32;
  full, causal, window and segment-id masks; one case with 256 tokens
  after the all-to-all, where the port's flash wrappers run (their plain
  versions here) and JAX its Pallas kernels in interpret mode.
- Indivisible heads raise the JAX package's ``ValueError``; an
  indivisible sequence raises too.
- A 5-step ViT train with ``sp_mode="ulysses"`` over 2 ranks (4 heads,
  128 tokens a rank) against the one-rank port run (rtol 2e-5, atol 2e-6:
  JAX ``tests/test_ulysses.py``'s pins) and against JAX's Ulysses train
  step on a (data 4, seq 2) mesh, the same global batch (params 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from dml_cnn_cifar10_tpu.config import ParallelConfig as JaxParallelConfig
from dml_cnn_cifar10_tpu.parallel import mesh as jax_mesh
from dml_cnn_cifar10_tpu.parallel import ulysses as jax_ulysses
from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
from dml_cnn_cifar10_tpu_torch.models.vit import ViT
from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
from dml_cnn_cifar10_tpu_torch.parallel import ulysses
from test_torch_parallel import VIT_DATA, _check_against_jax, _jax_train

torch.set_num_threads(2)

OUT_TOL, GRAD_TOL, BF16_TOL = 2e-5, 5e-5, 0.05


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _segments(b, s, seed):
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        for c in np.sort(rng.choice(np.arange(1, s), 2, replace=False)):
            seg[i, c:] += 1
    return seg


# name -> (global [B, S, H, D], port kwargs, segment ids?, tol)
CASES = {
    "full": ((2, 64, 4, 16), dict(), False, OUT_TOL),
    "causal": ((2, 64, 4, 16), dict(causal=True), False, OUT_TOL),
    "window": ((2, 64, 4, 32), dict(window=12), False, OUT_TOL),
    "segments": ((2, 64, 4, 16), dict(causal=True), True, OUT_TOL),
    "bf16": ((2, 64, 4, 16), dict(dtype="bfloat16"), False, BF16_TOL),
    "flash_engine": ((1, 256, 4, 16), dict(), False, OUT_TOL),
}
# (data, seq) topology -> cases it runs
TOPOLOGIES = {
    (1, 2): list(CASES),
    (1, 4): ["full", "causal", "window", "segments"],
    (2, 2): ["full", "segments"],
}


def _inputs(name):
    shape, _, with_seg, _ = CASES[name]
    seed = sorted(CASES).index(name)
    q, k, v = (_normal(shape, 10 * i + seed) for i in (1, 2, 3))
    seg = _segments(shape[0], shape[1], 40 + seed) if with_seg else None
    return q, k, v, seg


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Each topology's cases in one spawn, reassembled into global
    arrays: ``{(data, seq): {name: (out, dq, dk, dv)}}``."""
    res = {}
    for (data, seq), names in TOPOLOGIES.items():
        cases = [(n, *_inputs(n), CASES[n][1]) for n in names]
        ranks = _torch_dist.run_ranks(
            "ulysses_cases", data * seq,
            tmp_path_factory.mktemp(f"ulysses_{data}x{seq}"), seq, cases)
        res[(data, seq)] = {
            n: tuple(np.concatenate([np.concatenate(
                [ranks[d * seq + s][n][i] for s in range(seq)], axis=1)
                for d in range(data)], axis=0) for i in range(4))
            for n in names}
    return res


def _jax_ulysses(name, data, seq):
    q, k, v, seg = _inputs(name)
    kw = dict(CASES[name][1])
    dtype = jnp.bfloat16 if kw.pop("dtype", None) == "bfloat16" \
        else jnp.float32
    mesh = jax_mesh.build_mesh(JaxParallelConfig(data_axis=data,
                                                 seq_axis=seq),
                               devices=jax.devices()[:data * seq])
    use_pallas = name == "flash_engine"
    if seg is not None:
        kw["segment_ids"] = jnp.asarray(seg)

    @jax.jit
    def value_and_grads(q, k, v):
        out, vjp = jax.vjp(lambda *a: jax_ulysses.ulysses_attention(
            *a, mesh, use_pallas=use_pallas, **kw), q, k, v)
        return (out, *vjp(jnp.cos(out.astype(jnp.float32))
                          .astype(out.dtype)))

    res = value_and_grads(*(jnp.asarray(a, dtype) for a in (q, k, v)))
    return [np.asarray(t, np.float32) for t in res]


@pytest.mark.parametrize("topology,name", [
    (t, n) for t, names in TOPOLOGIES.items() for n in names],
    ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else x)
def test_ulysses_matches_jax(port_runs, topology, name):
    got = port_runs[topology][name]
    want = _jax_ulysses(name, *topology)
    tol = CASES[name][3]
    assert np.isfinite(got[0]).all()
    for what, g, w, t in zip(("out", "dq", "dk", "dv"), got, want,
                             (tol,) + (max(tol, GRAD_TOL),) * 3):
        np.testing.assert_allclose(g, w, rtol=t, atol=t,
                                   err_msg=f"{topology} {name} {what}")


def test_indivisible_heads_raise_the_jax_error():
    """The port's message is JAX ``ulysses_attention``'s, raised before any
    collective; a ViT whose heads or tokens the seq ranks cannot split
    refuses to build."""
    q = jnp.zeros((1, 64, 2, 16))
    jmesh = jax_mesh.build_mesh(JaxParallelConfig(seq_axis=4),
                                devices=jax.devices()[:4])
    with pytest.raises(ValueError) as jerr:
        jax_ulysses.ulysses_attention(q, q, q, jmesh)
    mesh = mesh_lib.Mesh(world=4, seq=4, seq_rank=1)
    t = torch.zeros(1, 16, 2, 16)
    with pytest.raises(ValueError) as err:
        ulysses.ulysses_attention_local(t, t, t, mesh)
    assert str(err.value) == str(jerr.value)
    mesh3 = mesh_lib.Mesh(world=3, seq=3)
    data = DataConfig(crop_height=32, crop_width=32)
    with pytest.raises(ValueError, match="per-device heads not divisible"):
        ViT(ModelConfig(vit_dim=64, vit_heads=4, pool="mean",
                        sp_mode="ulysses"), data, mesh=mesh3)
    with pytest.raises(ValueError, match="not divisible by seq axis 3"):
        ViT(ModelConfig(vit_dim=48, vit_heads=3, pool="mean",
                        sp_mode="ulysses"), data, mesh=mesh3)
    with pytest.raises(ValueError, match="unknown sp_mode"):
        ViT(ModelConfig(vit_dim=64, vit_heads=4, pool="mean",
                        sp_mode="tree"), data, mesh=mesh_lib.Mesh(
                            world=2, seq=2))


# The ViT at 64x64, patch 4: 256 tokens, 128 a seq rank, 4 heads of 16.
VIT = dict(name="vit_tiny", pool="mean", logit_relu=False, vit_depth=2,
           vit_dim=64, vit_heads=4, patch_size=4, sp_mode="ulysses")


def test_ulysses_vit_train_matches_one_rank_and_jax(tmp_path):
    rng = np.random.default_rng(3)
    batches = [(rng.normal(0.5, 0.25, (4, 64, 64, 3)).astype(np.float32),
                rng.integers(0, 10, 4).astype(np.int32)) for _ in range(5)]
    optim = dict(learning_rate=0.01)
    params0, jm, jfinal = _jax_train(
        dict(VIT, use_pallas_attention=False), VIT_DATA, optim, (4, 1, 2),
        batches)
    ranks = _torch_dist.run_ranks("train_steps", 2, tmp_path, 2, VIT,
                                  VIT_DATA, optim, params0, batches)
    one, _ = _torch_dist.train_steps(0, 1, 1, VIT, VIT_DATA, optim, params0,
                                     batches)
    for metrics, _ in ranks:
        np.testing.assert_allclose([m[0] for m in metrics],
                                   [m[0] for m in one], rtol=2e-5,
                                   atol=2e-6)
    _check_against_jax(ranks, jm, jfinal, 2e-5, 2e-6)
