"""PyTorch port, chunked dispatch over several ranks against the JAX
package and within itself, on the CPU: ranks are spawned gloo processes
(``tests/_torch_dist.py``), whose chunks run their eager body (the card's
CUDA graph of the same body, its NCCL collectives captured, is held to it
by ``chip_smoke.py`` phase 31); the JAX side runs on the 8-virtual-device
mesh of ``conftest.py``, on the same seeded inputs and initial params.

- The DP CNN over 2 ranks, K = 2 steps a chunk at global batch 16, two
  dispatches: the resident chunk on the device index stream against JAX
  ``make_train_chunk_resident(..., index_stream=...)`` on ``data=8``, and
  the resident chunk on host indices (each rank's shard rows mapped to
  rows of the whole split, ``shard + idx * num_shards``) against JAX on
  the same global rows: params within 1e-5, losses rtol 2e-5 (the pins of
  ``tests/test_torch_parallel.py``), bit-equal on both ranks. The
  host-fed raw chunk (augmented) against K single DP steps on the same
  rows, each image drawing at its column of the global batch: 1e-6. The
  resident full-test eval over 2 ranks counts what one rank counts.
- Ring and Ulysses chunks (seq 2) of a small ViT against the port's own
  SP steps on the same batches (params 1e-5, phase 19's pin) and against
  JAX ``make_train_chunk`` on a (data 4, seq 2) mesh.
- A 2-rank CLI run at ``--steps_per_dispatch 2`` stopped and resumed ends
  bit-equal to the run without a stop; the chief's checkpoint restores in
  a one-process ``--mode eval`` that prints the 2-rank run's accuracy.
- A rank's card from hand-written ``--worker_hosts`` lists.
"""

import json
import re

import jax
import numpy as np
import pytest
import torch

import _torch_dist
from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.config import ModelConfig as JaxModelConfig
from dml_cnn_cifar10_tpu.config import OptimConfig as JaxOptimConfig
from dml_cnn_cifar10_tpu.config import ParallelConfig as JaxParallelConfig
from dml_cnn_cifar10_tpu.models.registry import get_model as jax_get_model
from dml_cnn_cifar10_tpu.parallel import mesh as jax_mesh
from dml_cnn_cifar10_tpu.parallel import step as jax_step
from dml_cnn_cifar10_tpu_torch import ckpt, convert
from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint
from dml_cnn_cifar10_tpu_torch.cli.main import main
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              OptimConfig)
from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
from dml_cnn_cifar10_tpu_torch.utils import platform

torch.set_num_threads(2)

B, K, WORLD, SEED = 16, 2, 2, 4
DATA = dict(normalize="scale")
AUG = dict(random_crop=True, random_flip=True, normalize="standardize")
OPTIM = dict(learning_rate=0.02, momentum=0.9, dead_lr_decay=False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(ranks, losses, params, loss_rtol=2e-5, atol=1e-5):
    """Every rank's (per-dispatch losses, final params) against the
    reference's, and the ranks bit-equal."""
    for runs, final in ranks:
        np.testing.assert_allclose([r[0] for r in runs], losses,
                                   rtol=loss_rtol)
        assert sorted(final) == sorted(params)
        for name, value in final.items():
            np.testing.assert_allclose(value, params[name], rtol=0,
                                       atol=atol, err_msg=name)
    (runs0, p0), (runs1, p1) = ranks
    assert runs0 == runs1
    for name in p0:
        np.testing.assert_array_equal(p0[name], p1[name], err_msg=name)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The JAX references on ``data=8`` and the port's 2 ranks."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (96, 24, 24, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 96).astype(np.int32)
    t_images = rng.integers(0, 256, (21, 24, 24, 3), dtype=np.uint8)
    t_labels = rng.integers(0, 10, 21).astype(np.int32)
    # Host rows: data rank r's columns come from its shard [r::2].
    host_idx = []
    for _ in range(2):
        idx = rng.integers(0, 48, (K, B)) * WORLD
        idx[:, B // WORLD:] += 1
        host_idx.append(idx)

    mesh = jax_mesh.build_mesh(JaxParallelConfig(data_axis=8))
    model_def, mcfg = jax_get_model("cnn"), JaxModelConfig(logit_relu=False)
    jdata, jopt = JaxDataConfig(use_native_loader=False, **DATA), \
        JaxOptimConfig(**OPTIM)
    repl = jax_mesh.replicated(mesh)
    ds = (jax.device_put(images, repl), jax.device_put(labels, repl))
    ref = {}
    params0 = None
    for name, kw in (("stream", dict(index_stream=(SEED, B, K))),
                     ("host_idx", {})):
        state = jax_step.init_train_state(jax.random.key(1), model_def,
                                          mcfg, jdata, jopt, mesh)
        params0 = _np(state.params)
        chunk = jax_step.make_train_chunk_resident(
            model_def, mcfg, jopt, mesh, *ds, data_cfg=jdata, **kw)
        losses = []
        for idx in host_idx:
            args = () if kw else (jax_mesh.place_local(
                jax_mesh.batch_sharding(mesh, 2, leading_dims=1),
                idx.astype(np.int32)),)
            state, m = chunk(state, *args)
            losses.append(float(m["loss"]))
        ref[name] = (losses, {k: v.numpy() for k, v in
                              convert.params_from_jax(
                                  _np(state.params)).items()})
    ranks = _torch_dist.run_ranks(
        "dp_chunks", WORLD, tmp_path_factory.mktemp("dp"), DATA, OPTIM,
        params0, (images, labels), (t_images, t_labels), K, B, host_idx,
        SEED)
    return ref, ranks, (images, labels, t_images, t_labels, host_idx,
                        params0)


def test_dp_resident_stream_chunk_matches_jax(dp):
    ref, ranks, _ = dp
    _close([r["stream"] for r in ranks], *ref["stream"])


def test_dp_host_indexed_chunk_matches_jax(dp):
    ref, ranks, _ = dp
    _close([r["host_idx"] for r in ranks], *ref["host_idx"])


def test_dp_host_fed_chunk_equals_single_steps(tmp_path):
    """Augmented: each rank decodes its columns at their place in the
    global batch, in the chunk and in the single steps alike."""
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (64, 28, 28, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 64).astype(np.int32)
    t = (images[:9], labels[:9])
    idx = [rng.integers(0, 32, (K, B)) * WORLD for _ in range(2)]
    for i in idx:
        i[:, B // WORLD:] += 1
    model = CNN(ModelConfig(logit_relu=False), DataConfig(**AUG))
    state = step_lib.init_train_state(model, OptimConfig(**OPTIM),
                                      torch.device("cpu"),
                                      torch.Generator().manual_seed(2))
    params0 = convert.params_to_jax({k: v.detach() for k, v in
                                     state.params.items()})
    ranks = _torch_dist.run_ranks("dp_chunks", WORLD, tmp_path, AUG, OPTIM,
                                  params0, (images, labels), t, K, B, idx,
                                  SEED)
    for r in ranks:
        fed_runs, fed = r["host_fed"]
        one_runs, one = r["single"]
        np.testing.assert_allclose([x[0] for x in fed_runs],
                                   [x[0] for x in one_runs], rtol=1e-6)
        for name in fed:
            np.testing.assert_allclose(fed[name], one[name], rtol=0,
                                       atol=1e-6, err_msg=name)
    _close([r["host_fed"] for r in ranks], [x[0] for x in one_runs], one,
           loss_rtol=1e-6, atol=1e-6)


def test_dp_resident_full_eval_equals_one_rank(dp):
    _, ranks, (_, _, t_images, t_labels, _, _) = dp
    final = ranks[0]["stream"][1]
    model = CNN(ModelConfig(logit_relu=False), DataConfig(**DATA))
    state = step_lib.init_train_state(model, OptimConfig(**OPTIM),
                                      torch.device("cpu"))
    with torch.no_grad():
        for name, p in state.params.items():
            p.copy_(torch.from_numpy(final[name]))
    ev, total = step_lib.make_eval_resident(
        model, t_images, t_labels, DataConfig(**DATA), torch.device("cpu"),
        batch_size=B)
    one = int(ev(state))
    assert [r["eval"] for r in ranks] == [(one, total)] * WORLD
    assert total == len(t_labels) and 0 < one < total
    with pytest.raises(ValueError, match="total_records"):
        step_lib.make_eval_resident(
            model, t_images[::2], t_labels[::2], DataConfig(**DATA),
            torch.device("cpu"), mesh=step_lib.Mesh(world=2, data=2))


# A small ViT: 32x32 crop, patch 4 = 64 tokens, 32 a seq rank; 2 heads,
# so Ulysses gives one to each seq rank.
VIT = dict(name="vit_tiny", pool="mean", logit_relu=False, vit_depth=2,
           vit_dim=32, vit_heads=2, patch_size=4)


def test_sp_chunks_match_steps_and_jax(tmp_path):
    rng = np.random.default_rng(6)
    images = rng.normal(0.5, 0.25, (K, 4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (K, 4)).astype(np.int32)
    optim = dict(learning_rate=0.01)
    mesh = jax_mesh.build_mesh(JaxParallelConfig(data_axis=4, seq_axis=2))
    model_def = jax_get_model("vit_tiny")
    jdata = JaxDataConfig(crop_height=32, crop_width=32)
    jopt = JaxOptimConfig(**optim)
    refs, params0 = {}, None
    for mode in ("ring", "ulysses"):
        mcfg = JaxModelConfig(**VIT, sp_mode=mode, use_pallas_attention=False)
        sh = jax_step.train_state_shardings(mesh, model_def, mcfg, jdata,
                                            jopt)
        state = jax_step.init_train_state(jax.random.key(0), model_def,
                                          mcfg, jdata, jopt, mesh,
                                          state_sharding=sh)
        params0 = _np(state.params)
        chunk = jax_step.make_train_chunk(model_def, mcfg, jopt, mesh,
                                          state_sharding=sh)
        bsh = jax_mesh.batch_sharding(mesh, 5, leading_dims=1)
        lsh = jax_mesh.batch_sharding(mesh, 2, leading_dims=1)
        state, m = chunk(state, jax_mesh.place_local(bsh, images),
                         jax_mesh.place_local(lsh, labels))
        refs[mode] = (float(m["loss"]), {k: v.numpy() for k, v in
                                         convert.params_from_jax(
                                             _np(state.params)).items()})
    ranks = _torch_dist.run_ranks("sp_chunks", WORLD, tmp_path, 2, VIT,
                                  optim, params0, images, labels)
    for mode in ("ring", "ulysses"):
        loss, want = refs[mode]
        per_rank = []
        for r in ranks:
            (c_metrics, chunk), (s_metrics, steps) = r[mode]
            np.testing.assert_allclose(c_metrics[0], s_metrics[0],
                                       rtol=2e-5)
            np.testing.assert_allclose(c_metrics[0], loss, rtol=2e-5)
            for name in chunk:
                np.testing.assert_allclose(chunk[name], steps[name],
                                           rtol=0, atol=1e-5, err_msg=name)
                np.testing.assert_allclose(chunk[name], want[name], rtol=0,
                                           atol=1e-5, err_msg=name)
            per_rank.append(chunk)
        for name in per_rank[0]:
            np.testing.assert_array_equal(per_rank[0][name],
                                          per_rank[1][name], err_msg=name)


TRAIN_LINE = re.compile(r"^global_step (\d+), ")
EVAL_LINE = re.compile(r"^ --- Test Accuracy = (\d+\.\d\d)%\.$")


def test_two_rank_cli_chunked_resume_is_exact(tmp_path, capsys):
    def args(log, total):
        hosts = ",".join(f"localhost:{p}"
                         for p in _torch_dist.free_ports(WORLD))
        return ["--device", "cpu", "--dataset", "synthetic",
                "--data_dir", str(tmp_path / "data"),
                "--log_dir", str(tmp_path / log),
                "--synthetic_train_records", "160",
                "--fidelity", "fixed",
                "--learning_rate", "0.02", "--batch_size", "16",
                "--steps_per_dispatch", "2", "--output_every", "4",
                "--eval_every", "4", "--checkpoint_every", "4",
                "--total_steps", str(total), "--worker_hosts", hosts,
                "--dist_backend", "gloo", "--metrics_jsonl",
                str(tmp_path / log / f"m{total}.jsonl")]

    rcs = _torch_dist.run_ranks("cli_runs", WORLD, tmp_path / "ranks", [
        args("full", 8), args("split", 4), args("split", 8)])
    assert rcs == [[0, 0, 0]] * WORLD
    params = {}
    for log in ("full", "split"):
        with open(ckpt.latest_checkpoint(str(tmp_path / log)), "rb") as f:
            params[log] = checkpoint.from_bytes(f.read())
    assert int(np.asarray(params["full"]["opt"]["step"])) == 8
    full = convert.params_from_jax(params["full"]["params"])
    split = convert.params_from_jax(params["split"]["params"])
    for name in full:
        assert torch.equal(full[name], split[name]), name
    with open(tmp_path / "full" / "m8.jsonl") as f:
        recs = [json.loads(l) for l in f]
    accs = [r["test_accuracy"] for r in recs if r["kind"] == "eval"]
    assert len(accs) == 2
    one = args("full", 8)
    one = one[:one.index("--worker_hosts")] + ["--mode", "eval"]
    capsys.readouterr()
    assert main(one) == 0
    out = capsys.readouterr().out.splitlines()
    assert any("eval at step 8" in l for l in out)
    got = [float(EVAL_LINE.match(l)[1]) for l in out if EVAL_LINE.match(l)]
    assert got == [round(accs[-1] * 100, 2)]


@pytest.mark.parametrize("hosts,cards,want", [
    ((), 2, [0, 1, 0, 1]),
    (("a:1", "a:2", "b:1", "b:2"), 2, [0, 1, 0, 1]),
    (("a:1", "b:1", "a:2", "a:3", "b:2"), 4, [0, 0, 1, 2, 1]),
    (("a:1", "b:1", "a:2", "a:3", "b:2"), 2, [0, 0, 1, 0, 1]),
    (("h1:9", "h2:9", "h10:9"), 1, [0, 0, 0]),
], ids=["one-host", "contiguous", "interleaved", "more-ranks-than-cards",
        "prefix-names"])
def test_rank_card_from_worker_hosts(monkeypatch, hosts, cards, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    got = [platform.rank_device("cuda", r, hosts).index
           for r in range(len(want))]
    assert got == want
    assert platform.rank_device("cuda:1", 0, hosts) == torch.device("cuda",
                                                                     1)
    assert platform.rank_device("cpu", 3, hosts).type == "cpu"
