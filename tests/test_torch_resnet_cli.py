"""PyTorch port, the ResNet rungs through the entry point
(``python -m dml_cnn_cifar10_tpu_torch``), on the CPU with ``--device
cpu`` as a user drives them on the card:

- ``--model resnet18 --dataset synthetic`` trains (momentum, weight
  decay, the cosine schedule), resumes, evaluates on the running stats,
  exports an artifact that carries them and serves a request from it over
  HTTP; the live engine swaps params with their ``model_state`` and
  rejects a candidate without it;
- ``--model resnet50 --dataset imagenet_synth --image_size 80
  --crop_size 72`` (the ImageNet stem, 1000 classes) trains 2 steps;
- the README recipe's flag set parses (``--use_native_loader false``
  included; ``true`` raises ``NotImplementedError`` naming the ROADMAP);
- every JSONL stream passes ``tools/check_jsonl_schema.py --strict``.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                config_from_args, main)
from dml_cnn_cifar10_tpu_torch.serve.server import resolve_engine

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lint(path):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "check_jsonl_schema.py"),
         "--strict", str(path)], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def _r18(tmp_path, *extra):
    return ["--device", "cpu", "--model", "resnet18", "--dataset",
            "synthetic", "--data_dir", str(tmp_path / "data"),
            "--log_dir", str(tmp_path / "logs"),
            "--synthetic_train_records", "64", "--fidelity", "fixed",
            "--batch_size", "8", "--learning_rate", "0.05",
            "--momentum", "0.9", "--weight_decay", "5e-4",
            "--schedule", "cosine", "--warmup_steps", "1",
            "--output_every", "2", "--eval_every", "4",
            "--checkpoint_every", "2", *extra]


def test_resnet18_trains_evaluates_exports_and_serves(tmp_path, capsys):
    jsonl = tmp_path / "m.jsonl"
    assert main(_r18(tmp_path, "--total_steps", "4", "--metrics_jsonl",
                     str(jsonl), "--peak_tflops", "1")) == 0
    assert main(_r18(tmp_path, "--total_steps", "6",
                     "--cosine_decay_steps", "4")) == 0
    out = capsys.readouterr().out
    assert "global_step 6, task:0_step 1" in out
    assert main(_r18(tmp_path, "--mode", "eval")) == 0
    assert "eval at step 6" in capsys.readouterr().out
    _lint(jsonl)
    recs = [json.loads(line) for line in open(jsonl)]
    train = [r for r in recs if r["kind"] == "train"]
    assert train[0]["flops_stack"] == "convs_gemms"

    assert main(_r18(tmp_path, "--mode", "export")) == 0
    artifact = tmp_path / "logs" / "model.pt2"
    assert artifact.is_file()
    # The artifact scores with the running stats the eval step reads.
    cfg = config_from_args(build_parser().parse_args(_r18(tmp_path)))
    images = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                               dtype=np.uint8)
    cfg.serve.artifact_path = str(artifact)
    baked, _ = resolve_engine(cfg).forward_timed(images)
    cfg.serve.artifact_path = None
    os.rename(artifact, tmp_path / "aside.pt2")
    live = resolve_engine(cfg)            # the checkpoint's live weights
    got, _ = live.forward_timed(images)
    np.testing.assert_allclose(got, baked, rtol=1e-5, atol=1e-5)
    os.rename(tmp_path / "aside.pt2", artifact)

    # Hot swap: params with their model_state, or rejected.
    params = {n: t.clone() for n, t in live._params.items()
              if not n.endswith((".mean", ".var"))}
    mstate = {n: t.clone() + 0.5 for n, t in live._params.items()
              if n.endswith((".mean", ".var"))}
    assert len(mstate) == 40
    ok, why = live.try_swap(params, version="no_state")
    assert not ok and "missing" in why
    ok, _ = live.try_swap(params, mstate, version="7")
    assert ok and live.version == "7"
    assert torch.equal(live._params["stem.bn.mean"], mstate["stem.bn.mean"])

    proc = subprocess.Popen(
        [sys.executable, "-m", "dml_cnn_cifar10_tpu_torch",
         *_r18(tmp_path, "--mode", "serve", "--serve_port", "0",
               "--serve_buckets", "1,4", "--metrics_jsonl",
               str(tmp_path / "serve.jsonl"))],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        port, lines = None, []
        for line in proc.stdout:
            lines.append(line)
            if "listening on :" in line:
                port = int(line.split("listening on :")[1].split()[0])
                break
        assert port, "".join(lines)
        reply = json.loads(urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=images[0].tobytes()),
            timeout=60).read())
        assert reply["version"] == "artifact"
        np.testing.assert_allclose(reply["logits"], baked[0], rtol=1e-4,
                                   atol=1e-4)
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, rest
    _lint(tmp_path / "serve.jsonl")


def test_resnet50_imagenet_synth_trains_two_steps(tmp_path, capsys):
    jsonl = tmp_path / "m.jsonl"
    assert main(["--device", "cpu", "--model", "resnet50", "--dataset",
                 "imagenet_synth", "--image_size", "80", "--crop_size", "72",
                 "--synthetic_train_records", "16", "--data_dir",
                 str(tmp_path / "data"), "--log_dir", str(tmp_path / "logs"),
                 "--fidelity", "fixed", "--batch_size", "4",
                 "--learning_rate", "0.01", "--momentum", "0.9",
                 "--total_steps", "2", "--output_every", "1",
                 "--eval_every", "2", "--checkpoint_every", "2",
                 "--metrics_jsonl", str(jsonl)]) == 0
    out = capsys.readouterr().out
    assert "global_step 2, task:0_step 1" in out and "Test Accuracy" in out
    _lint(jsonl)
    files = os.listdir(tmp_path / "data" / "imagenet-synth-bin")
    assert "train_1.bin" in files and "val.bin" in files


README_RECIPE = (
    "--fidelity fixed --model resnet18 --batch_size 1024 --total_steps 2500 "
    "--learning_rate 0.4 --momentum 0.9 --weight_decay 5e-4 --schedule "
    "cosine --warmup_steps 200 --output_every 500 --eval_every 500 "
    "--checkpoint_every 2500 --steps_per_dispatch 100 --use_native_loader "
    "false --synthetic_train_records 50000").split()


def test_readme_recipe_parses():
    args, unparsed = build_parser().parse_known_args(README_RECIPE)
    assert not unparsed
    cfg = config_from_args(args)
    assert cfg.model.name == "resnet18" and cfg.steps_per_dispatch == 100
    assert cfg.optim.cosine_decay_steps == 2500
    assert cfg.data.crop_height == 24 and cfg.model.resnet_norm == "bn"
    cfg = config_from_args(build_parser().parse_args(
        ["--dataset", "imagenet_synth", "--model", "resnet50",
         "--resnet_s2d", "true", "--resnet_norm", "nf"]))
    assert (cfg.data.image_height, cfg.data.crop_height) == (256, 224)
    assert cfg.data.num_classes == cfg.model.num_classes == 1000
    assert cfg.model.resnet_s2d and cfg.model.resnet_norm == "nf"
    cfg = config_from_args(build_parser().parse_args(
        ["--dataset", "cifar100"]))
    assert cfg.data.num_classes == cfg.model.num_classes == 100
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        config_from_args(build_parser().parse_args(
            README_RECIPE + ["--use_native_loader", "true"]))
