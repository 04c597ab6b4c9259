"""PyTorch port, ``parallel/pipeline.py``: the three schedules against the
JAX package's ``pipeline_blocks`` and against the port's plain version.

One spawn of 4 gloo ranks (``tests/_torch_dist.py:pipeline_cases``) runs
the port's ``pipeline_blocks`` at pipe 4 (data 1) and pipe 2 (data 2):

- on the toy stack of ``tests/test_pp.py`` (depth 4, dim 8, ``tanh(h @ w
  + b)``) at batch 16, for each of ``1f1b``, ``1f1b_ring`` and ``gpipe``
  at ``M = P`` and ``M = 2P``: the output, ``dx`` and the stacked
  parameters' gradients of ``sum(sin(out))`` against JAX
  ``pipeline.pipeline_blocks`` on the 8-virtual-device mesh at ``data =
  8 // P`` (rtol 1e-5, atol 1e-6);
- on ViT blocks (depth 4, dim 64, 2 heads, 16 tokens) for each schedule
  at ``M = 2P``: the same three against the port's sequential plain
  version, one process, the whole stack (rtol 1e-5; atol 1e-6 of the
  largest value of each).

Without ranks: the ``ValueError`` texts for a depth the stages do not
divide and a batch the data ranks and microbatches do not divide.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from dml_cnn_cifar10_tpu.config import ParallelConfig as JaxParallelConfig
from dml_cnn_cifar10_tpu.parallel import mesh as jax_mesh
from dml_cnn_cifar10_tpu.parallel import pipeline as jax_pipeline
from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
from dml_cnn_cifar10_tpu_torch.models.vit import ViT
from dml_cnn_cifar10_tpu_torch.parallel import pipeline
from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh

PIN = dict(rtol=1e-5, atol=1e-6)
PIPES = (2, 4)
VIT = dict(name="vit_tiny", pool="mean", logit_relu=False, vit_depth=4,
           vit_dim=64, vit_heads=2, patch_size=8)
VIT_DATA = DataConfig(crop_height=32, crop_width=32)     # 16 tokens


def _toy_stack(depth=4, dim=8):
    rng = np.random.default_rng(0)
    return {"w": (rng.normal(size=(depth, dim, dim)) * 0.3).astype(
        np.float32), "b": np.zeros((depth, dim), np.float32)}


def _vit_stack():
    net = ViT(ModelConfig(**VIT), VIT_DATA)
    net.reset_parameters(torch.Generator().manual_seed(0))
    leaves = {n[len("blocks."):]: p.detach().numpy().copy()
              for n, p in net.named_parameters() if n.startswith("blocks.")}
    return net, leaves


def _jax_toy(x, stacked, pipe, m, schedule):
    mesh = jax_mesh.build_mesh(JaxParallelConfig(data_axis=8 // pipe,
                                                 pipe_axis=pipe))

    def block(h, p):
        return jnp.tanh(h @ p["w"] + p["b"])

    def loss(x, params):
        out = jax_pipeline.pipeline_blocks(x, params, block, mesh,
                                           num_microbatches=m,
                                           schedule=schedule)
        return jnp.sum(jnp.sin(out)), out

    (_, out), (dx, dp) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jax.tree.map(
            jnp.asarray, stacked))
    return np.asarray(out), np.asarray(dx), {k: np.asarray(v)
                                             for k, v in dp.items()}


def _plain_vit(net, x, stacked):
    xt = torch.tensor(x, requires_grad=True)
    st = {k: torch.tensor(v, requires_grad=True) for k, v in stacked.items()}
    out = pipeline.sequential_blocks(
        xt, st, lambda h, p: net._block(h, p)[0])
    torch.sin(out).sum().backward()
    return (out.detach().numpy(), xt.grad.numpy(),
            {k: v.grad.numpy() for k, v in st.items()})


def _cases():
    rng = np.random.default_rng(1)
    toy_x = rng.normal(size=(16, 6, 8)).astype(np.float32)
    vit_x = rng.normal(size=(8, 16, 64)).astype(np.float32)
    _, vit_stack = _vit_stack()
    cases = []
    for pipe in PIPES:
        for schedule in pipeline.SCHEDULES:
            for m in (pipe, 2 * pipe):
                cases.append((f"toy_p{pipe}_{schedule}_m{m}", pipe, schedule,
                              m, toy_x, _toy_stack(), None))
            cases.append((f"vit_p{pipe}_{schedule}", pipe, schedule,
                          2 * pipe, vit_x, vit_stack, VIT))
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = _cases()
    got = _torch_dist.run_ranks("pipeline_cases", 4,
                                tmp_path_factory.mktemp("pipeline"), cases)
    return {c[0]: c for c in cases}, got


def _assembled(ranks, name, pipe):
    """The port's output and ``dx`` over the data ranks, and each stacked
    leaf's gradient over the stages."""
    outs, dxs, grads = {}, {}, {}
    for r in ranks:
        d, p = r["coords"][pipe]
        out, dx, g = r[name]
        if p == 0:
            outs[d], dxs[d] = out, dx
        for k, v in g.items():
            grads.setdefault(k, {})[p] = v
    return (np.concatenate([outs[d] for d in sorted(outs)]),
            np.concatenate([dxs[d] for d in sorted(dxs)]),
            {k: np.concatenate([v[p] for p in range(pipe)])
             for k, v in grads.items()})


def _every_stage_same(ranks, name, pipe):
    """The output and ``dx`` are the same on every stage of a data row."""
    by_data = {}
    for r in ranks:
        d, _ = r["coords"][pipe]
        by_data.setdefault(d, []).append(r[name][:2])
    for rows in by_data.values():
        for out, dx in rows[1:]:
            np.testing.assert_array_equal(out, rows[0][0])
            np.testing.assert_array_equal(dx, rows[0][1])


@pytest.mark.parametrize("pipe", PIPES)
@pytest.mark.parametrize("schedule", pipeline.SCHEDULES)
@pytest.mark.parametrize("micro", [1, 2], ids=["m=P", "m=2P"])
def test_schedules_match_jax_pipeline_blocks(ranks, pipe, schedule, micro):
    cases, got = ranks
    name = f"toy_p{pipe}_{schedule}_m{micro * pipe}"
    _, _, _, m, x, stacked, _ = cases[name]
    want = _jax_toy(x, stacked, pipe, m, schedule)
    out, dx, grads = _assembled(got, name, pipe)
    np.testing.assert_allclose(out, want[0], err_msg="out", **PIN)
    np.testing.assert_allclose(dx, want[1], err_msg="dx", **PIN)
    for k in ("w", "b"):
        np.testing.assert_allclose(grads[k], want[2][k], err_msg=k, **PIN)
    _every_stage_same(got, name, pipe)


@pytest.mark.parametrize("pipe", PIPES)
@pytest.mark.parametrize("schedule", pipeline.SCHEDULES)
def test_vit_blocks_match_the_plain_version(ranks, pipe, schedule):
    cases, got = ranks
    name = f"vit_p{pipe}_{schedule}"
    _, _, _, _, x, stacked, _ = cases[name]
    net, _ = _vit_stack()
    want = _plain_vit(net, x, stacked)
    out, dx, grads = _assembled(got, name, pipe)

    def close(a, b, what):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max(),
                                   err_msg=what)

    close(out, want[0], "out")
    close(dx, want[1], "dx")
    assert set(grads) == set(want[2])
    for k in grads:
        close(grads[k], want[2][k], k)
    _every_stage_same(got, name, pipe)


def test_indivisible_depth_and_batch_raise():
    vit = dict(VIT, vit_depth=6)
    with pytest.raises(ValueError, match="depth 6 not divisible by pipe "
                                         "axis 4"):
        ViT(ModelConfig(**vit), VIT_DATA, mesh=Mesh(world=4, pipe=4))
    two = Mesh(world=4, data=2, pipe=2)
    rows = {k: torch.tensor(v[:2]) for k, v in _toy_stack().items()}
    fn = functools.partial(pipeline.sequential_blocks,
                           block_fn=_torch_dist._toy_block)
    with pytest.raises(ValueError, match=r"global batch 12 not divisible "
                                         r"by data axis \* microbatches = "
                                         r"2\*4"):
        pipeline.pipeline_blocks(torch.zeros(6, 3, 8), rows, fn, two,
                                 num_microbatches=4)
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        pipeline.pipeline_blocks(torch.zeros(8, 3, 8), rows, fn, two,
                                 schedule="zb")
