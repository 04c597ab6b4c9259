"""PyTorch port, exact-resume data order on the host streams:
``data/pipeline.py:skip_batches``, ``ckpt/checkpoint.py``'s
``data_state_{step}.json`` sidecar and the trainer's use of both
(``train/loop.py``), against the JAX package on the CPU where it has the
same piece (JAX ``tests/test_exact_resume.py`` pins the same).

- ``skip_batches(n)`` leaves a stream where consuming ``n`` batches does,
  with crop and flip on (the host decode's augmentation draws replayed),
  and where the JAX iterator of the same seed skipped to; index chunks
  align too.
- The sidecar is the JAX writer's file, byte for byte, and is pruned with
  its checkpoint.
- A run of 2N steps, and a run of N steps resumed to 2N, log the same
  losses and accuracies and end with the same parameters, bit for bit:
  on the eager path (fixed: augmented host decode and the full-split
  eval; faithful: the single-batch test stream), and on the chunked
  paths whose host ships indices or raw uint8 chunks.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu.ckpt import checkpoint as jax_ckpt
from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.data import pipeline as jax_pipe
from dml_cnn_cifar10_tpu_torch import ckpt
from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
from dml_cnn_cifar10_tpu_torch.cli.main import main
from dml_cnn_cifar10_tpu_torch.config import DataConfig
from dml_cnn_cifar10_tpu_torch.data import pipeline as pipe

torch.set_num_threads(2)

AUG = dict(dataset="synthetic", normalize="scale", random_crop=True,
           random_flip=True, synthetic_train_records=200,
           synthetic_test_records=40)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("synth"))


def test_skip_batches_matches_the_consumed_stream_and_jax(data_dir):
    cfg = DataConfig(data_dir=data_dir, **AUG)
    a = pipe.input_pipeline(cfg, 16, train=True, seed=3)
    b = pipe.input_pipeline(cfg, 16, train=True, seed=3)
    j = jax_pipe.input_pipeline(
        JaxDataConfig(data_dir=data_dir, use_native_loader=False, **AUG),
        16, train=True, seed=3)
    for _ in range(5):
        next(a)
    b.skip_batches(5, aug=True)
    j.skip_batches(5, aug=True)
    for _ in range(3):       # stays aligned across further draws
        ba, bb, bj = next(a), next(b), next(j)
        np.testing.assert_array_equal(ba.images, bb.images)
        np.testing.assert_array_equal(ba.labels, bb.labels)
        np.testing.assert_array_equal(bb.images, bj.images)
        np.testing.assert_array_equal(bb.labels, bj.labels)
    # A chunked index draw is cursor-equivalent to single draws, across
    # an epoch boundary (200 records, 16 a batch).
    c = pipe.input_pipeline(cfg, 16, train=True, seed=9)
    d = pipe.input_pipeline(cfg, 16, train=True, seed=9)
    c.next_index_chunk(14)
    d.skip_batches(14, aug=False)
    np.testing.assert_array_equal(c.next_index_chunk(2),
                                  d.next_index_chunk(2))
    # Without augmentation the host decode draws nothing but indices.
    plain = dataclasses.replace(cfg, random_crop=False, random_flip=False)
    e = pipe.input_pipeline(plain, 16, train=True, seed=4)
    f = pipe.input_pipeline(plain, 16, train=True, seed=4)
    for _ in range(3):
        next(e)
    f.skip_batches(3, aug=True)
    np.testing.assert_array_equal(next(e).images, next(f).images)


def test_data_state_sidecar_is_the_jax_file_and_pruned_with_its_ckpt(
        tmp_path):
    counts = {"train": 40, "acc": 4, "test": 2}
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_data_state(jdir, 40, counts)
    ckpt.save_data_state(pdir, 40, counts)
    name = "data_state_40.json"
    with open(os.path.join(jdir, name), "rb") as x, \
            open(os.path.join(pdir, name), "rb") as y:
        assert x.read() == y.read()
    assert ckpt.load_data_state(jdir, 40) == jax_ckpt.load_data_state(
        pdir, 40) == counts
    assert ckpt.load_data_state(pdir, 41) is None
    # A checkpoint's sidecar goes when retention prunes the checkpoint.
    from dml_cnn_cifar10_tpu_torch.config import ModelConfig, OptimConfig
    from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
    state = step_lib.init_train_state(CNN(ModelConfig(), DataConfig()),
                                      OptimConfig(), torch.device("cpu"),
                                      torch.Generator().manual_seed(0))
    mdir = str(tmp_path / "managed")
    mgr = ckpt.CheckpointManager(mdir, every_steps=10, keep=1)
    for step in (50, 60):
        assert mgr.maybe_save(state, step, data_state={"train": step})
    assert sorted(f for f in os.listdir(mdir) if f.startswith("data")) == \
        ["data_state_60.json"]
    assert ckpt_lib.load_data_state(mdir, 60) == {"train": 60}


# name -> (extra CLI args, N steps): the eager path in fixed mode
# (augmented host decode, full-split eval) and faithful mode (the
# single-batch test stream), and the chunked paths whose host ships each
# chunk's indices or its raw uint8 rows.
PATHS = {
    "eager_fixed": (["--fidelity", "fixed"], 10),
    "eager_faithful": (["--fidelity", "faithful",
                        "--learning_rate", "0.001"], 10),
    "host_index": (["--fidelity", "fixed", "--steps_per_dispatch", "5",
                    "--device_index_stream", "false"], 10),
    "host_fed": (["--fidelity", "fixed", "--steps_per_dispatch", "5",
                  "--resident_data", "false"], 10),
}


def _run(tmp_path, data, log, extra, steps):
    jsonl = str(tmp_path / f"{log}_{steps}.jsonl")
    args = ["--device", "cpu", "--dataset", "synthetic", "--data_dir", data,
            "--log_dir", str(tmp_path / log), "--synthetic_train_records",
            "320", "--learning_rate", "0.02", "--batch_size", "32",
            "--output_every", "5", "--eval_every", "5",
            "--checkpoint_every", "10", "--total_steps", str(steps),
            "--metrics_jsonl", jsonl, *extra]
    assert main(args) == 0
    with open(jsonl) as f:
        recs = [json.loads(line) for line in f]
    return [(r["kind"], r["step"], r.get("loss"), r.get("train_accuracy"),
             r.get("test_accuracy")) for r in recs
            if r["kind"] in ("train", "eval")]


def _final(tmp_path, log, step):
    with open(tmp_path / log / f"ckpt_{step}.msgpack", "rb") as f:
        return f.read()


@pytest.mark.parametrize("path", list(PATHS))
def test_resumed_run_continues_the_host_streams_bit_for_bit(tmp_path, path):
    extra, n = PATHS[path]
    data = str(tmp_path / "data")
    whole = _run(tmp_path, data, "whole", extra, 2 * n)
    first = _run(tmp_path, data, "split", extra, n)
    second = _run(tmp_path, data, "split", extra, 2 * n)
    assert first + second == whole
    assert ckpt.load_data_state(str(tmp_path / "split"), n)["train"] == n
    assert _final(tmp_path, "split", 2 * n) == _final(tmp_path, "whole",
                                                      2 * n)
