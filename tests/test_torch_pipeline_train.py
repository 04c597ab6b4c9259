"""PyTorch port, the pipelined ViT's training step, its checkpoints and its
refusals, on the CPU.

One spawn of 4 gloo ranks (``tests/_torch_dist.py:axis_runs``) trains
``VIT_PP`` of ``tests/test_pp.py:26-27`` (depth 4, dim 64, 2 heads, patch
8, mean pool; 24 px, 9 tokens; batch 16, plain SGD lr 0.01, from the JAX
package's init) for 3 steps at data 2 x pipe 2 and at pipe 4, under each
schedule, with ``grad_accum`` 2, with ``remat``, and as one chunk of K =
2: losses and parameters against JAX ``make_train_step`` on a ``data``
mesh at the pins of ``tests/test_pp.py:129`` (rtol 2e-5, atol 2e-6). Each
stage holds ``depth / P`` rows of every stacked block leaf.

Checkpoints: a data 2 x pipe 2 run saved at step 2 in both codecs. The
msgpack file is byte-equal to the JAX package's save of the same state
(restored into a JAX state and saved again); it and the ``.sharded`` one
restore bit for bit into pipe 4, which trains step 3 within the pins of
JAX's, and the msgpack one into one process, which does the same. The
JAX package's ``.sharded`` save of its own data 2 x pipe 2 state restores
into the port's stages bit for bit.

Without ranks: pipe x seq, pipe x model and pipe x MoE raise the JAX
package's ``ValueError``s, the CNN and the ResNet its rule-table one,
``async_staleness`` its own, zero1 and fsdp under pipe and a rule that
puts ``pipe`` off the depth axis ``NotImplementedError``, and the CLI's
two pipe-flag guards their ``SystemExit`` texts.
"""

import os

import jax
import numpy as np
import pytest
import torch

import _torch_dist
from dml_cnn_cifar10_tpu.ckpt import checkpoint as jax_ckpt
from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.config import ModelConfig as JaxModelConfig
from dml_cnn_cifar10_tpu.config import OptimConfig as JaxOptimConfig
from dml_cnn_cifar10_tpu.config import ParallelConfig as JaxParallelConfig
from dml_cnn_cifar10_tpu.models.registry import get_model as jax_get_model
from dml_cnn_cifar10_tpu.parallel import mesh as jax_mesh
from dml_cnn_cifar10_tpu.parallel import step as jax_step
from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                config_from_args)
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              OptimConfig, ParallelConfig)
from dml_cnn_cifar10_tpu_torch.models.registry import get_model
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
from dml_cnn_cifar10_tpu_torch.parallel import zero
from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh
from test_torch_tp import _batches, _close, _np

PIN = dict(rtol=2e-5, atol=2e-6)
VIT_PP = dict(name="vit_tiny", pool="mean", logit_relu=False, vit_depth=4,
              vit_dim=64, vit_heads=2, patch_size=8)
SGD = dict(learning_rate=0.01)
RUNS = {
    "d2p2": dict(pipe=2),
    "p4": dict(pipe=4),
    "d2p2_ring": dict(pipe=2, model=dict(pipe_schedule="1f1b_ring",
                                         pipe_microbatches=4)),
    "d2p2_gpipe": dict(pipe=2, model=dict(pipe_schedule="gpipe",
                                          pipe_microbatches=4)),
    "p4_ring": dict(pipe=4, model=dict(pipe_schedule="1f1b_ring")),
    "p4_gpipe": dict(pipe=4, model=dict(pipe_schedule="gpipe",
                                        pipe_microbatches=8)),
    "d2p2_accum": dict(pipe=2, optim=dict(grad_accum=2)),
    "d2p2_remat": dict(pipe=2, model=dict(remat=True)),
    "d2p2_chunk": dict(pipe=2, chunk=True),
}


def jax_steps(optim_kw, batches, data=2, pipe=1):
    """JAX steps of ``VIT_PP`` on a ``data x pipe`` mesh: ``(initial
    params, per-step losses, params after each step, final state)``."""
    mcfg = JaxModelConfig(**VIT_PP)
    dcfg = JaxDataConfig(normalize="scale")
    ocfg = JaxOptimConfig(**optim_kw)
    mesh = jax_mesh.build_mesh(
        JaxParallelConfig(data_axis=data, pipe_axis=pipe),
        devices=jax.devices()[:data * pipe])
    model_def = jax_get_model(mcfg.name)
    sh = jax_step.train_state_shardings(mesh, model_def, mcfg, dcfg, ocfg)
    state = jax_step.init_train_state(jax.random.key(0), model_def, mcfg,
                                      dcfg, ocfg, mesh, state_sharding=sh)
    params0 = _np(state.params)
    train = jax_step.make_train_step(model_def, mcfg, ocfg, mesh,
                                     state_sharding=sh)
    losses, params = [], []
    for images, labels in batches:
        state, m = train(state, *jax_mesh.shard_batch(mesh, images, labels))
        losses.append(float(m["loss"]))
        params.append(_np(state.params))
    return params0, losses, params, state


@pytest.fixture(scope="module")
def pp(tmp_path_factory):
    batches = _batches(17)
    jax_res = {"sgd": jax_steps(SGD, batches),
               "accum": jax_steps(dict(SGD, grad_accum=2), batches)}
    params0 = jax_res["sgd"][0]
    runs = {}
    for name, kw in RUNS.items():
        runs[name] = dict(model=dict(VIT_PP, **kw.get("model", {})),
                          optim=dict(SGD, **kw.get("optim", {})),
                          params=params0, pipe=kw["pipe"],
                          chunk=kw.get("chunk", False),
                          batches=batches[:2] if kw.get("chunk")
                          else batches)
    work = tmp_path_factory.mktemp("pp_ckpt")
    jax_pp = jax_steps(SGD, batches, data=2, pipe=2)
    jax_ckpt.save_checkpoint(str(work / "jax_pp"), jax_pp[3], 3,
                             fmt="sharded", shard_io_threads=1)
    ckpt = dict(work=str(work), run=dict(runs["d2p2"], batches=batches[:2]),
                next=batches[2:], jax=str(work / "jax_pp"))
    ranks = _torch_dist.run_ranks("axis_runs", 4, work / "ranks", runs,
                                  ckpt)
    return ranks, jax_res, jax_pp, work, batches


@pytest.mark.parametrize("name", list(RUNS))
def test_pipelined_steps_match_jax_data_parallel(pp, name):
    ranks, jax_res, _, _, _ = pp
    _, losses, params, _ = jax_res["accum" if "accum" in name else "sgd"]
    n = 2 if name.endswith("chunk") else 3
    for r in ranks:
        got = r[name]
        want = losses[n - 1:n] if name.endswith("chunk") else losses
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                                   want, **PIN)
        _close(got["tree"]["params"], params[n - 1], f"{name} vs JAX",
               **PIN)
    pipe = RUNS[name]["pipe"]
    for r in ranks:
        assert r[name]["local"]["blocks.qkv.kernel"] == (4 // pipe, 64, 192)
        assert r[name]["local"]["head.kernel"] == (64, 10)


def test_every_stage_holds_its_rows_and_gathers_the_same_tree(pp):
    ranks, *_ = pp
    for name in ("d2p2", "p4"):
        for r in ranks[1:]:
            _close(r[name]["tree"], ranks[0][name]["tree"],
                   f"{name}: gathered tree", rtol=0, atol=0)
    # pipe is fastest in the rank order: rank = data_rank * P + stage.
    assert [r["coords"]["2x1"] for r in ranks] == [
        (0, 0, 0), (0, 0, 1), (1, 0, 0), (1, 0, 1)]
    assert [r["coords"]["4x1"] for r in ranks] == [
        (0, 0, p) for p in range(4)]


def test_msgpack_save_is_jax_packages_save_and_resumes_at_pipe_4_and_1(
        pp, tmp_path):
    ranks, jax_res, _, work, batches = pp
    _, losses, params, _ = jax_res["sgd"]
    saved = ranks[0]["ckpt"]["saved"]
    path = os.path.join(work, "msgpack", "ckpt_2.msgpack")
    with open(path, "rb") as f:
        data = f.read()
    _close(ckpt_lib.from_bytes(data), saved, "file vs gathered", rtol=0,
           atol=0)
    # The JAX package restores the file and saves the same bytes.
    _, _, _, jstate = jax_steps(SGD, batches[:1])
    back = jax_ckpt.restore_checkpoint(os.path.dirname(path), jstate)
    again = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), back, 2)
    with open(again, "rb") as f:
        assert f.read() == data
    # Resumed over 4 stages (both codecs) and in one process.
    for r in ranks:
        for fmt in ("msgpack", "sharded"):
            res = r["ckpt"]["resumed"][fmt]
            _close(res["restored"], saved, f"{fmt} restored", rtol=0,
                   atol=0)
            assert res["local"]["blocks.mlp1.kernel"] == (1, 64, 256)
            np.testing.assert_allclose(res["metrics"][0]["loss"], losses[2],
                                       **PIN)
            _close(res["tree"]["params"], params[2], f"{fmt} resumed",
                   **PIN)
    net = get_model("vit_tiny")(ModelConfig(**VIT_PP), DataConfig())
    ocfg = OptimConfig(**SGD)
    state = step_lib.init_train_state(net, ocfg, torch.device("cpu"),
                                      torch.Generator().manual_seed(0))
    ckpt_lib.restore_checkpoint(os.path.dirname(path), state)
    images, labels = batches[2]
    _, m = step_lib.make_train_step(net, ocfg)(
        state, torch.from_numpy(images),
        torch.from_numpy(labels.astype(np.int64)))
    np.testing.assert_allclose(float(m["loss"]), losses[2], **PIN)
    _close(ckpt_lib.state_to_tree(state)["params"], params[2],
           "one process resumed", **PIN)


def test_jax_sharded_save_of_data_x_pipe_restores_into_the_stages(pp):
    ranks, _, jax_pp, work, _ = pp
    _, _, params, jstate = jax_pp
    for r in ranks:
        got = r["ckpt"]["jax_restored"]
        _close(got["params"], params[-1], "JAX .sharded -> port", rtol=0,
               atol=0)
        assert int(got["opt"]["step"]) == int(jstate.step)
    # The JAX package wrote each block leaf as its two stages' rows.
    path = os.path.join(work, "jax_pp", "ckpt_3.sharded")
    rows = set()
    for name in os.listdir(path):
        if name.endswith(".msgpack"):
            with open(os.path.join(path, name), "rb") as f:
                part = ckpt_lib.from_bytes(f.read())
            entries = part.get(".params/blocks/qkv/kernel", {})
            entries = entries.values() if isinstance(entries, dict) \
                else entries
            rows |= {tuple(np.asarray(e["index"])[0]) for e in entries}
    assert rows == {(0, 2), (2, 4)}


# ---------------------------------------------------------------------------
# Refusals, without ranks.
# ---------------------------------------------------------------------------


def _mesh(**kw):
    return Mesh(world=4, **kw)


@pytest.mark.parametrize("kw,model,match", [
    (dict(seq=2, pipe=2), VIT_PP, "seq and pipe parallelism cannot both be "
                                  "active in one stack"),
    (dict(model=2, pipe=2), VIT_PP, r"pipe and model \(tensor\) parallelism "
                                    r"cannot combine"),
    (dict(data=2, pipe=2), dict(VIT_PP, name="vit_moe", moe_experts=4),
     "pipe parallelism does not compose with MoE"),
    (dict(data=2, pipe=2), dict(name="cnn"),
     r"pipeline parallelism is not supported for 'cnn' \(supported: "
     r"\['vit_tiny'\]\)"),
    (dict(data=2, pipe=2), dict(name="resnet18"),
     "pipeline parallelism is not supported for 'resnet18'"),
], ids=["seq", "model", "moe", "cnn", "resnet"])
def test_pipe_refusals_raise_jax_texts(kw, model, match):
    mcfg = ModelConfig(**model)
    with pytest.raises(ValueError, match=match):
        get_model(mcfg.name)(mcfg, DataConfig(), mesh=_mesh(**kw))


def test_async_staleness_and_sharded_state_refused_under_pipe():
    mesh = _mesh(data=2, pipe=2)
    net = get_model("vit_tiny")(ModelConfig(**VIT_PP), DataConfig(),
                                mesh=mesh)
    with pytest.raises(ValueError, match="async_staleness does not compose "
                                         "with pipeline parallelism"):
        step_lib.make_train_step(net, OptimConfig(async_staleness=2), mesh)
    for ocfg, par in ((OptimConfig(optimizer_sharding="zero1"),
                       ParallelConfig(pipe_axis=2)),
                      (OptimConfig(), ParallelConfig(pipe_axis=2,
                                                     fsdp=True)),
                      (OptimConfig(), ParallelConfig(
                          pipe_axis=2, partition_rules="^blocks/=pipe"))):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md Queue 1, the open sharding "
                                 "items"):
            zero.build_layout(net, "vit_tiny", ocfg, par, mesh)
    # The pipeline table itself is honoured: no layout, no refusal.
    assert zero.build_layout(net, "vit_tiny", OptimConfig(),
                             ParallelConfig(pipe_axis=2), mesh) is None


@pytest.mark.parametrize("flags,match", [
    (["--pipe_microbatches", "4"], "--pipe_microbatches=4 requires "
                                   "--pipe_axis > 1 .got 1.; without a pipe "
                                   "axis there is no schedule to microbatch"),
    (["--pipe_schedule", "gpipe"], "--pipe_schedule=gpipe requires "
                                   "--pipe_axis > 1 .got 1.; without a pipe "
                                   "axis there is no schedule to select"),
])
def test_cli_pipe_guards(flags, match):
    with pytest.raises(SystemExit, match=match):
        config_from_args(build_parser().parse_args(
            ["--device", "cpu", "--model", "vit_tiny"] + flags))
    cfg = config_from_args(build_parser().parse_args(
        ["--device", "cpu", "--model", "vit_tiny", "--pipe_axis", "2"]
        + flags))
    assert cfg.parallel.pipe_axis == 2
    assert (cfg.model.pipe_microbatches, cfg.model.pipe_schedule) in (
        (4, "1f1b"), (0, "gpipe"))
