"""PyTorch port, cli/main.py + train/loop.py: the slice's entry point,
driven on the CPU as a user would drive it on the card.
"""

import json
import os
import re

import pytest
import torch

from dml_cnn_cifar10_tpu_torch.cli.main import main
from dml_cnn_cifar10_tpu_torch.utils.platform import resolve_device

torch.set_num_threads(2)

TRAIN_LINE = re.compile(
    r"^global_step (\d+), task:0_step (\d+), training accuracy [0-9.e+-]+$")
EVAL_LINE = re.compile(r"^ --- Test Accuracy = (\d+\.\d\d)%\.$")


def _args(tmp_path, *extra):
    return ["--device", "cpu", "--dataset", "synthetic",
            "--data_dir", str(tmp_path / "data"),
            "--log_dir", str(tmp_path / "logs"),
            "--synthetic_train_records", "320",
            "--fidelity", "fixed", "--learning_rate", "0.02",
            "--batch_size", "32", "--output_every", "10",
            "--eval_every", "20", "--checkpoint_every", "20", *extra]


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_train_resume_and_eval(tmp_path, capsys):
    jsonl = str(tmp_path / "m.jsonl")
    assert main(_args(tmp_path, "--total_steps", "40",
                      "--metrics_jsonl", jsonl)) == 0
    out = _lines(capsys)
    assert out[0] == "Starting Training"
    train = [TRAIN_LINE.match(l) for l in out if l.startswith("global_step")]
    assert all(train) and [(int(m[1]), int(m[2])) for m in train] == \
        [(10, 9), (20, 19), (30, 29), (40, 39)]
    evals = [EVAL_LINE.match(l) for l in out if "Test Accuracy" in l]
    assert len(evals) == 2 and all(evals)
    assert float(evals[-1][1]) > 50.0     # separable classes, chance is 10%
    logs = tmp_path / "logs"
    for name in ("ckpt_40.msgpack", "ckpt_40.msgpack.sha256", "checkpoint"):
        assert (logs / name).is_file(), name
    assert (logs / "checkpoint").read_text() == "ckpt_40.msgpack\n"
    with open(jsonl) as f:
        records = [json.loads(l) for l in f]
    assert [r["kind"] for r in records].count("train") == 4
    assert {r["kind"] for r in records} == {"train", "eval", "done"}
    assert all(r["loss"] is not None for r in records
               if r["kind"] == "train")

    # Resume: the global step continues from the checkpoint.
    assert main(_args(tmp_path, "--total_steps", "60")) == 0
    out = _lines(capsys)
    steps = [int(TRAIN_LINE.match(l)[1]) for l in out
             if l.startswith("global_step")]
    assert steps == [50, 60]
    evals = [EVAL_LINE.match(l)[1] for l in out if "Test Accuracy" in l]
    assert len(evals) == 1                 # at local step 20 = global 60
    assert (logs / "ckpt_60.msgpack").is_file()

    # --mode eval restores ckpt_60 and sweeps the same split.
    assert main(_args(tmp_path, "--mode", "eval")) == 0
    out = _lines(capsys)
    assert [EVAL_LINE.match(l)[1] for l in out if "Test Accuracy" in l] \
        == evals
    assert any("eval at step 60" in l for l in out)


def test_faithful_momentum_and_unfused_flags_run(tmp_path, capsys):
    args = _args(tmp_path, "--total_steps", "10", "--momentum", "0.9",
                 "--weight_decay", "5e-4", "--fused_optimizer", "false")
    args[args.index("fixed")] = "faithful"
    assert main(args) == 0
    out = _lines(capsys)
    assert [l for l in out if l.startswith("global_step")] and \
        not [l for l in out if "Test Accuracy" in l]


def test_cuda_is_the_default_and_never_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda")
    args = [a for a in _args(tmp_path, "--total_steps", "1")]
    del args[:2]                           # drop "--device cpu"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(args)
    assert resolve_device("cpu") == torch.device("cpu")


def test_reference_cluster_flags(tmp_path, capsys):
    assert main(["--job_name=ps", "--ps_hosts=x:1",
                 "--worker_hosts=y:2"]) == 0
    assert "obsolete" in capsys.readouterr().out
    # Several workers start a torch.distributed world (tests/
    # test_torch_parallel.py); a host list that cannot form one is refused
    # before anything is written.
    for hosts, task in (("a:1,b:2", 2), ("a:1,a:1", 0), ("a:1,", 0)):
        with pytest.raises(ValueError):
            main(_args(tmp_path, "--worker_hosts", hosts, "--task_index",
                       str(task)))
    assert not os.path.exists(tmp_path / "logs")


def _vit_args(tmp_path, *extra):
    """A small ViT (depth 2, dim 64, 2 heads; 48x48 crop = 145 tokens, so
    the flash path runs) with the ViT recipe's AdamW + cosine schedule."""
    return _args(tmp_path, "--model", "vit_tiny", "--image_size", "52",
                 "--crop_size", "48", "--vit_depth", "2", "--vit_dim", "64",
                 "--vit_heads", "2", "--optimizer", "adamw",
                 "--learning_rate", "1e-3", "--schedule", "cosine",
                 "--warmup_steps", "2", "--batch_size", "8",
                 "--synthetic_train_records", "64", "--output_every", "3",
                 "--eval_every", "6", "--checkpoint_every", "3", *extra)


def test_vit_trains_resumes_and_evaluates(tmp_path, capsys):
    assert main(_vit_args(tmp_path, "--total_steps", "6")) == 0
    out = _lines(capsys)
    assert [int(TRAIN_LINE.match(l)[1]) for l in out
            if l.startswith("global_step")] == [3, 6]
    evals = [EVAL_LINE.match(l)[1] for l in out if "Test Accuracy" in l]
    assert len(evals) == 1
    # Resume: the step and the AdamW moments come back from ckpt_6.
    assert main(_vit_args(tmp_path, "--total_steps", "12")) == 0
    out = _lines(capsys)
    assert [int(TRAIN_LINE.match(l)[1]) for l in out
            if l.startswith("global_step")] == [9, 12]
    evals = [EVAL_LINE.match(l)[1] for l in out if "Test Accuracy" in l]
    assert main(_vit_args(tmp_path, "--mode", "eval")) == 0
    out = _lines(capsys)
    assert [EVAL_LINE.match(l)[1] for l in out if "Test Accuracy" in l] \
        == evals
    assert any("eval at step 12" in l for l in out)


def test_vit_flags_reach_the_model(tmp_path, capsys):
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    args = _vit_args(tmp_path, "--total_steps", "3", "--pool", "mean",
                     "--remat", "true", "--attn_causal", "true",
                     "--attn_window", "32", "--compute_dtype", "bfloat16")
    cfg = config_from_args(build_parser().parse_args(args))
    m, o = cfg.model, cfg.optim
    assert (m.name, m.vit_depth, m.vit_dim, m.vit_heads, m.pool, m.remat,
            m.attn_causal, m.attn_window, m.compute_dtype) == \
        ("vit_tiny", 2, 64, 2, "mean", True, True, 32, "bfloat16")
    assert (cfg.data.image_height, cfg.data.crop_height) == (52, 48)
    # cosine with no --cosine_decay_steps decays over total_steps
    assert (o.optimizer, o.schedule, o.warmup_steps,
            o.cosine_decay_steps) == ("adamw", "cosine", 2, 3)
    assert main(args) == 0
    assert [int(TRAIN_LINE.match(l)[1]) for l in _lines(capsys)
            if l.startswith("global_step")] == [3]
