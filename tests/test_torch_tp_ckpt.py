"""PyTorch port, checkpoints under tensor parallelism, on the CPU.

One spawn of 4 gloo ranks (data 2 x model 2, ``tests/_torch_dist.py:
tp_runs``): the CNN at published widths with momentum 0.9, 2 steps at
batch 16, as TP+fsdp and as TP, each saved in both codecs, then restored
across layouts. Against a one-process replicated run of the same steps:

- a msgpack save under TP holds every leaf whole: its bytes are the save
  of a one-process state holding the same values, and its tree the
  gathered state, bit for bit;
- ``.sharded`` restores TP+fsdp -> TP, replicated -> TP (a one-process
  save) and TP -> replicated (restored here), and the TP+fsdp msgpack
  save restores into TP+zero1, each bit for bit;
- each piece is written once: under TP the model ranks of data rank 0
  write their slices (the JAX package's ``replica_id == 0``) and rank 0
  the replicated leaves; under TP+fsdp every rank writes its shard of a
  slice, with its index range in both dims.
"""

import json
import os

import numpy as np
import pytest
import torch

import _torch_dist
from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              OptimConfig)
from dml_cnn_cifar10_tpu_torch.models.registry import get_model
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
from test_torch_tp import CNN, MOM, _batches, _close, replicated

STEPS = 2


def _fresh():
    net = get_model("cnn")(ModelConfig(**CNN), DataConfig())
    return step_lib.init_train_state(net, OptimConfig(**MOM),
                                     torch.device("cpu"),
                                     torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def ck(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_ckpt")
    params0 = ckpt_lib.state_to_tree(_fresh())["params"]
    run = dict(model=CNN, optim=MOM, params=params0,
               batches=_batches(7, n=STEPS))
    _, rep_tree, rep_state = replicated(run)
    ckpt_lib.save_checkpoint(str(work / "replicated"), rep_state, STEPS,
                             fmt="sharded")
    ranks = _torch_dist.run_ranks(
        "tp_runs", 4, tmp_path_factory.mktemp("tp_ckpt_ranks"), 2, {},
        dict(work=str(work), run=run, replicated=str(work / "replicated")))
    return work, rep_tree, [r["ckpt"] for r in ranks]


def test_tp_trains_as_replicated_before_saving(ck):
    _, rep_tree, ranks = ck
    for r in ranks:
        for mode in ("none", "fsdp"):
            _close(r["saved"][mode], rep_tree, f"{mode} vs replicated",
                   rtol=2e-5, atol=2e-6)


def test_msgpack_save_is_the_replicated_save(ck, tmp_path):
    work, _, ranks = ck
    path = os.path.join(work, "msgpack_none", f"ckpt_{STEPS}.msgpack")
    with open(path, "rb") as f:
        data = f.read()
    tree = ckpt_lib.from_bytes(data)
    for r in ranks:
        _close(tree, r["saved"]["none"], "file vs gathered", rtol=0, atol=0)
    state = ckpt_lib.load_tree_into(_fresh(), tree)
    again = ckpt_lib.save_checkpoint(str(tmp_path), state, STEPS)
    with open(again, "rb") as f:
        assert f.read() == data


def test_sharded_restores_across_layouts(ck):
    work, rep_tree, ranks = ck
    for r in ranks:
        got = r["restored"]
        _close(got["fsdp->tp"], r["saved"]["fsdp"], "fsdp->tp", rtol=0,
               atol=0)
        _close(got["replicated->tp"], rep_tree, "replicated->tp", rtol=0,
               atol=0)
        _close(got["msgpack fsdp->zero1"], r["saved"]["fsdp"],
               "msgpack fsdp->zero1", rtol=0, atol=0)
    # TP -> one process, replicated.
    state = ckpt_lib.restore_checkpoint(os.path.join(work, "sharded_none"),
                                        _fresh())
    _close(ckpt_lib.state_to_tree(state), ranks[0]["saved"]["none"],
           "tp->replicated", rtol=0, atol=0)


def _pieces(path):
    """``{rank: {leaf path: [index, ...]}}`` of a sharded checkpoint."""
    with open(os.path.join(path, "MANIFEST.json")) as f:
        files = json.load(f)["shard_files"]
    out = {}
    for name in files:
        rank = int(name.split("_")[1].split(".")[0])
        with open(os.path.join(path, name), "rb") as f:
            part = ckpt_lib.from_bytes(f.read())
        for leaf, entries in part.items():
            entries = entries.values() if isinstance(entries, dict) \
                else entries
            out.setdefault(rank, {}).setdefault(leaf, []).extend(
                np.asarray(e["index"]).tolist() for e in entries)
    return out


def test_each_piece_written_once(ck):
    work, _, _ = ck
    tp = _pieces(os.path.join(work, f"sharded_none/ckpt_{STEPS}.sharded"))
    # Ranks (data, model): 0 (0, 0), 1 (0, 1), 2 (1, 0), 3 (1, 1).
    assert set(tp) <= {0, 1}
    assert tp[0][".params/full1/kernel"] == [[[0, 2304], [0, 192]]]
    assert tp[1][".params/full1/kernel"] == [[[0, 2304], [192, 384]]]
    assert tp[1][".opt/momentum/full2/kernel"] == [[[192, 384], [0, 192]]]
    assert ".params/conv1/kernel" in tp[0]
    assert ".params/conv1/kernel" not in tp[1]
    fsdp = _pieces(os.path.join(work,
                                f"sharded_fsdp/ckpt_{STEPS}.sharded"))
    for rank, (d, m) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        # JAX layout [2304, 384]: model on dim 1, fsdp's data on dim 0.
        assert fsdp[rank][".params/full1/kernel"] == [
            [[d * 1152, (d + 1) * 1152], [m * 192, (m + 1) * 192]]]
        # full1's bias: model claims its one dim, so data rank 0 writes.
        assert (".params/full1/bias" in fsdp[rank]) == (d == 0)
