"""PyTorch port, the ``.sharded`` checkpoint codec and checkpoints across
state layouts, against the JAX package's ``ckpt/sharded.py`` on the CPU.

- One process: the port's files of a whole state (one shard-IO thread)
  are the JAX package's, byte for byte; each package restores the other's
  bit for bit; a JAX zero1 checkpoint of a ``data=2`` mesh (two shards a
  leaf, two part files) restores into the port; ``--mode export``'s
  restore reads a ``.sharded`` checkpoint.
- Two spawned gloo ranks (``tests/_torch_dist.py:sharded_ckpt``): a zero1
  state saved in both codecs (each rank writing its own shards) restores
  into none, zero1 and fsdp bit for bit; JAX restores the port's 2-rank
  files, and a JAX-written ``.sharded`` checkpoint restores into the
  port's fsdp ranks; the manifest lists every rank's files; every shard
  read and write is a ``shard_io`` event; a corrupt newer shard falls
  back to the older checkpoint.
- A 2-rank CLI run with ``--optimizer_sharding zero1 --ckpt_format
  sharded`` resumes under ``--fsdp`` and writes ``shard_io`` records that
  pass ``tools/check_jsonl_schema.py --strict``.
"""

import json
import os
import subprocess
import sys

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
from dml_cnn_cifar10_tpu_torch import convert
from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              OptimConfig)
from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
from test_torch_zero1 import _batches, _close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNN_KW = dict(name="cnn", logit_relu=False)
OPTIM = dict(learning_rate=0.01, momentum=0.9, ema_decay=0.9)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state(data=None, zero1=False, steps=1):
    """A JAX CNN state (momentum, EMA) after ``steps`` steps, replicated on
    one device or, with ``data``, on a ``data``-device mesh (zero1 or
    not); returns ``(state, sharding, mesh)``."""
    mcfg, dcfg = JaxModelConfig(**CNN_KW), JaxDataConfig()
    ocfg = JaxOptimConfig(**OPTIM, optimizer_sharding=(
        "zero1" if zero1 else "none"))
    model_def = jax_get_model("cnn")
    mesh = sh = None
    if data:
        mesh = jax_mesh.build_mesh(JaxParallelConfig(data_axis=data),
                                   devices=jax.devices()[:data])
        sh = jax_step.train_state_shardings(mesh, model_def, mcfg, dcfg,
                                            ocfg, zero1=zero1)
    state = jax_step.init_train_state(jax.random.key(0), model_def, mcfg,
                                      dcfg, ocfg, mesh, state_sharding=sh)
    train = jax_step.make_train_step(model_def, mcfg, ocfg, mesh,
                                     state_sharding=sh)
    for images, labels in _batches(5, n=steps):
        batch = (images, labels) if mesh is None else \
            jax_mesh.shard_batch(mesh, images, labels)
        state, _ = train(state, *batch)
    return state, sh, mesh


def _tree(state):
    return {"params": _np(state.params), "opt": _np(state.opt)}


def _port_state():
    ocfg = OptimConfig(**OPTIM)
    return step_lib.init_train_state(CNN(ModelConfig(**CNN_KW),
                                         DataConfig()), ocfg,
                                     torch.device("cpu"),
                                     torch.Generator().manual_seed(0))


def test_whole_state_files_are_the_jax_packages_byte_for_byte(tmp_path):
    jstate, _, _ = _jax_state()
    jdir = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), jstate, 1,
                                    fmt="sharded", shard_io_threads=1)
    port = ckpt_lib.load_tree_into(_port_state(), {
        **_tree(jstate), "model_state": {}})
    pdir = ckpt_lib.save_checkpoint(str(tmp_path / "port"), port, 1,
                                    fmt="sharded", shard_io_threads=1)
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names == [
        "MANIFEST.json", "shard_0.files.json", "shard_0.msgpack",
        "shard_0.msgpack.sha256"]
    for name in names + ["../ckpt_1.sharded.sha256"]:
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(pdir, name), "rb") as b:
            assert a.read() == b.read(), name
    # Each package restores the other's files bit for bit.
    back = jax_ckpt.restore_checkpoint(str(tmp_path / "port"), jstate)
    _close(_tree(back), _tree(jstate), 0, "JAX <- port")
    fresh = ckpt_lib.restore_checkpoint(str(tmp_path / "jax"), _port_state())
    _close(ckpt_lib.state_to_tree(fresh), {**_tree(jstate),
                                           "model_state": {}}, 0,
           "port <- JAX")


def test_jax_zero1_data2_checkpoint_restores_into_one_port_process(
        tmp_path):
    jstate, _, _ = _jax_state(data=2, zero1=True)
    path = jax_ckpt.save_checkpoint(str(tmp_path), jstate, 1, fmt="sharded",
                                    shard_io_threads=2)
    assert sorted(n for n in os.listdir(path) if n.endswith(".msgpack")) \
        == ["shard_0_0.msgpack", "shard_0_1.msgpack"]
    events = []
    fresh = ckpt_lib.restore_checkpoint(
        str(tmp_path), _port_state(), shard_io_threads=2,
        on_event=lambda kind, **f: events.append((kind, f["op"])))
    _close(ckpt_lib.state_to_tree(fresh), {**_tree(jstate),
                                           "model_state": {}}, 0,
           "port <- JAX zero1")
    assert events == [("shard_io", "restore")] * 2


def test_a_sharded_dir_counts_once_its_manifest_is_committed(tmp_path):
    state = _port_state()
    for step in (1, 2):
        state.opt["step"].fill_(step)
        ckpt_lib.save_checkpoint(str(tmp_path), state, step, fmt="sharded")
    # A crash before the manifest: the directory is no candidate.
    os.remove(tmp_path / "ckpt_2.sharded" / "MANIFEST.json")
    assert ckpt_lib.latest_checkpoint(str(tmp_path)).endswith(
        "ckpt_1.sharded")
    fresh = ckpt_lib.restore_checkpoint(str(tmp_path), _port_state())
    assert int(fresh.step) == 1


def test_export_restores_from_a_sharded_checkpoint(tmp_path):
    from dml_cnn_cifar10_tpu_torch import export as export_lib
    from dml_cnn_cifar10_tpu_torch.config import fixed_config

    jstate, _, _ = _jax_state(steps=2)
    jax_ckpt.save_checkpoint(str(tmp_path), jstate, 2, fmt="sharded")
    cfg = fixed_config(log_dir=str(tmp_path))
    cfg.model.logit_relu = False
    cfg.optim.momentum, cfg.optim.ema_decay = 0.9, 0.9
    _, params, step = export_lib.restore_serving_params(
        cfg, torch.device("cpu"))
    assert step == 2
    # The EMA serves, as --mode eval scores.
    _close(convert.params_to_jax(params), _np(jstate.opt["ema"]), 0,
           "served EMA")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("sharded_ckpt")
    jstate, _, _ = _jax_state(data=2, zero1=True)
    jax_dir = str(work / "jax")
    jax_ckpt.save_checkpoint(jax_dir, jstate, 1, fmt="sharded")
    run = dict(mode="zero1", model=CNN_KW, optim=OPTIM,
               params=_np(jstate.params), batches=_batches(6, n=2))
    res = _torch_dist.run_ranks("sharded_ckpt", 2, work / "ranks", run,
                                str(work), {"jax_zero1": jax_dir})
    return res, work, _tree(jstate)


def test_both_codecs_restore_into_every_layout(ranks):
    res, _, _ = ranks
    for r in res:
        for label in ("msgpack->none", "msgpack->zero1", "msgpack->fsdp",
                      "sharded->none", "sharded->zero1", "sharded->fsdp"):
            _close(r["restored"][label], r["tree"], 0, label)
    _close(res[0]["tree"], res[1]["tree"], 0, "rank 0 vs rank 1")


def test_jax_checkpoint_restores_into_port_fsdp_ranks(ranks):
    res, _, jtree = ranks
    for r in res:
        _close(r["restored"]["jax_zero1"], {**jtree, "model_state": {}}, 0,
               "port fsdp <- JAX zero1")


def test_port_two_rank_checkpoint_restores_into_jax(ranks):
    res, work, _ = ranks
    target, sh, _ = _jax_state(data=2, zero1=True, steps=0)
    back = jax_ckpt.restore_checkpoint(str(work / "sharded"), target,
                                       sharding=sh)
    _close(_tree(back), {k: res[0]["tree"][k] for k in ("params", "opt")},
           0, "JAX <- port")
    assert "data" in str(back.opt["momentum"]["full1"]["kernel"]
                         .sharding.spec)


def test_manifest_lists_every_ranks_shard_files(ranks):
    res, work, _ = ranks
    path = work / "sharded" / "ckpt_1.sharded"
    with open(path / "MANIFEST.json") as f:
        meta = json.load(f)
    listed = []
    for rank in (0, 1):
        with open(path / f"shard_{rank}.files.json") as f:
            listed += json.load(f)["files"]
    assert meta["process_count"] == 2
    assert meta["shard_files"] == listed
    assert listed[0].startswith("shard_0_") and listed[-1].startswith(
        "shard_1_")
    assert all((path / (n + ".sha256")).is_file() for n in listed)
    assert meta["leaves"][".params/full1/kernel"] == {
        "shape": [2304, 384], "dtype": "float32"}
    # Every rank wrote and read its files through the events.
    for rank, r in enumerate(res):
        saves = [s for k, op, s in r["events"] if op == "save"]
        assert sorted(saves) == sorted(n for n in listed
                                       if n.startswith(f"shard_{rank}_"))
        assert {op for _, op, _ in r["events_all"]} == {"save", "restore"}


def test_corrupt_newer_shard_falls_back(ranks):
    res, _, _ = ranks
    assert [r["fallback_step"] for r in res] == [1, 1]


def test_cli_zero1_sharded_then_fsdp_resume_streams_lint(tmp_path):
    data = ["--device", "cpu", "--dataset", "synthetic",
            "--data_dir", str(tmp_path / "data"),
            "--log_dir", str(tmp_path / "logs"),
            "--synthetic_train_records", "96", "--fidelity", "fixed",
            "--learning_rate", "0.02", "--batch_size", "16",
            "--output_every", "2", "--eval_every", "4",
            "--checkpoint_every", "2", "--ckpt_format", "sharded",
            "--shard_io_threads", "2", "--momentum", "0.9",
            "--dist_backend", "gloo"]
    jsonl = str(tmp_path / "m.jsonl")
    runs = []
    for steps, extra in (("4", ["--optimizer_sharding", "zero1"]),
                         ("6", ["--fsdp", "true"])):
        hosts = ",".join(f"localhost:{p}" for p in
                         _torch_dist.free_ports(2))
        runs.append(data + extra + ["--total_steps", steps,
                                    "--worker_hosts", hosts,
                                    "--metrics_jsonl", jsonl])
    assert _torch_dist.run_ranks("cli_runs", 2, tmp_path / "ranks",
                                 runs) == [[0, 0], [0, 0]]
    logs = sorted(os.listdir(tmp_path / "logs"))
    assert [n for n in logs if n.startswith("ckpt_")] == [
        "ckpt_2.sharded", "ckpt_2.sharded.sha256", "ckpt_4.sharded",
        "ckpt_4.sharded.sha256", "ckpt_6.sharded", "ckpt_6.sharded.sha256"]
    with open(jsonl) as f:
        recs = [json.loads(line) for line in f]
    io = [r for r in recs if r["kind"] == "shard_io"]
    assert {r["op"] for r in io} == {"save", "restore"}
    assert all(r["source"] == "disk" and r["bytes"] > 0 for r in io)
    # The resumed run starts at step 4 (its first record is step 6).
    train = [r["step"] for r in recs if r["kind"] == "train"]
    assert train == [2, 4, 6]
    lint = subprocess.run([sys.executable, os.path.join(
        ROOT, "tools", "check_jsonl_schema.py"), "--strict", jsonl],
        capture_output=True, text=True)
    assert lint.returncode == 0, lint.stdout + lint.stderr
