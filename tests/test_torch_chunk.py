"""PyTorch port, the chunked and resident path of parallel/step.py and
train/loop.py, against the JAX package and within itself, on the CPU
(where every ``make_train_chunk*`` runs its body eagerly; the card's CUDA
graph of the same body is held to it by ``chip_smoke.py`` phase 9b).

Against JAX: ``make_train_chunk_resident`` with the device index stream,
K = 3 steps of batch 8 on the full-width CNN, weights carried over with
``convert.py``, two dispatches: the loss of each (its last step's) within
rtol 1e-5 and the params after each within atol 1e-5, the pins of
``tests/test_torch_step.py`` (f32 convolutions sum in other orders). The
resident evals count what JAX's count and what the host sweep counts.
Within the port: a chunk is bit-equal to K single steps on the same rows,
the host-fed raw chunk to the resident one, two chunks of 2 to one of 4
(the exact resume), and a resumed CLI run to an uninterrupted one.
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
from dml_cnn_cifar10_tpu_torch.data import pipeline
from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
from dml_cnn_cifar10_tpu_torch.ops.preprocess import device_preprocess
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

torch.set_num_threads(2)

CPU = torch.device("cpu")
B, K = 8, 3
TRAIN_LINE = re.compile(r"^global_step (\d+), task:0_step (\d+), ")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The synthetic train and test splits as uint8 arrays."""
    cfg = DataConfig(dataset="synthetic",
                     data_dir=str(tmp_path_factory.mktemp("synth")),
                     synthetic_train_records=96, synthetic_test_records=20)
    train = pipeline.input_pipeline(cfg, B, train=True)
    test = pipeline.input_pipeline(cfg, B, train=False)
    return train.images, train.labels, test.images, test.labels


def _state(params_np=None, seed=0, **optim):
    """A port CNN and its state, holding ``params_np`` (a JAX-layout tree)
    when given."""
    model = CNN(ModelConfig(logit_relu=False), DataConfig())
    state = step_lib.init_train_state(model, OptimConfig(**optim), CPU,
                                      torch.Generator().manual_seed(seed))
    if params_np is not None:
        with torch.no_grad():
            for name, value in convert.params_from_jax(params_np).items():
                state.params[name].copy_(value)
    return model, state


def _ds(images, labels):
    return torch.from_numpy(images), torch.from_numpy(
        labels.astype(np.int64))


def _params_equal(a, b):
    return all(torch.equal(a.params[n], b.params[n]) for n in a.params)


def test_resident_stream_chunk_matches_jax(split):
    images, labels, _, _ = split
    optim = dict(learning_rate=0.01)
    data = dict(normalize="scale")
    mesh = jax_mesh.build_mesh(JaxParallelConfig(),
                               devices=jax.devices()[:1])
    model_def, mcfg = jax_get_model("cnn"), JaxModelConfig(logit_relu=False)
    jdata = JaxDataConfig(use_native_loader=False, **data)
    jstate = jax_step.init_train_state(jax.random.key(0), model_def, mcfg,
                                       jdata, JaxOptimConfig(**optim), mesh)
    repl = jax_mesh.replicated(mesh)
    jchunk = jax_step.make_train_chunk_resident(
        model_def, mcfg, JaxOptimConfig(**optim), mesh,
        jax.device_put(images, repl),
        jax.device_put(labels.astype(np.int32), repl), data_cfg=jdata,
        index_stream=(0, B, K))
    model, state = _state(jax.tree.map(np.asarray, jstate.params), **optim)
    chunk = step_lib.make_train_chunk_resident(
        model, OptimConfig(**optim), *_ds(images, labels),
        data_cfg=DataConfig(**data), index_stream=(0, B, K))
    for _ in range(2):
        jstate, jm = jchunk(jstate)
        state, m = chunk(state)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        want = convert.params_from_jax(jax.tree.map(np.asarray,
                                                    jstate.params))
        for name, p in state.params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)
    assert int(state.step) == int(jstate.step) == 2 * K


@pytest.mark.parametrize("aug", [dict(normalize="scale"),
                                 dict(random_crop=True, random_flip=True,
                                      normalize="standardize")],
                         ids=["scale", "augmented"])
def test_chunk_equals_single_steps_and_host_fed(split, aug):
    """One resident chunk (host indices) == K single steps on the same
    rows, each batch decoded alone at its own step == the host-fed raw
    chunk of those rows: bit for bit."""
    images, labels, _, _ = split
    data = DataConfig(**aug)
    optim = dict(learning_rate=0.02, momentum=0.9)
    ds_images, ds_labels = _ds(images, labels)
    idx = torch.from_numpy(np.random.default_rng(1).integers(
        0, len(images), (K, B)))
    model, s_chunk = _state(**optim)
    resident = step_lib.make_train_chunk_resident(
        model, OptimConfig(**optim), ds_images, ds_labels, data_cfg=data)
    s_chunk, m_chunk = resident(s_chunk, idx)

    model, s_steps = _state(**optim)
    one = step_lib.make_train_step(model, OptimConfig(**optim))
    for k in range(K):
        batch = device_preprocess(ds_images[idx[k]], data, s_steps.step)
        s_steps, m_steps = one(s_steps, batch, ds_labels[idx[k]])

    model, s_fed = _state(**optim)
    host_fed = step_lib.make_train_chunk(model, OptimConfig(**optim),
                                         data_cfg=data)
    s_fed, m_fed = host_fed(s_fed, ds_images[idx], ds_labels[idx])

    assert int(s_chunk.step) == int(s_steps.step) == int(s_fed.step) == K
    assert torch.equal(m_chunk["loss"], m_steps["loss"])
    assert torch.equal(m_chunk["loss"], m_fed["loss"])
    assert _params_equal(s_chunk, s_steps) and _params_equal(s_chunk, s_fed)
    for name, m in s_chunk.opt["momentum"].items():
        assert torch.equal(m, s_fed.opt["momentum"][name])


def test_two_chunks_of_two_equal_one_chunk_of_four(split):
    """The device stream's position is state.step: a resumed chunk
    continues the data order exactly, with no sidecar."""
    images, labels, _, _ = split
    data = DataConfig(random_crop=True, random_flip=True,
                      normalize="standardize")
    optim = OptimConfig(learning_rate=0.02)

    def build(k):
        model, state = _state()
        return state, step_lib.make_train_chunk_resident(
            model, optim, *_ds(images, labels), data_cfg=data,
            index_stream=(5, B, k))

    s_a, chunk2 = build(2)
    s_a, _ = chunk2(s_a)
    s_a, m_a = chunk2(s_a)
    s_b, chunk4 = build(4)
    s_b, m_b = chunk4(s_b)
    assert int(s_a.step) == int(s_b.step) == 4
    assert torch.equal(m_a["loss"], m_b["loss"])
    assert _params_equal(s_a, s_b)


def test_resident_evals_count_as_jax_and_the_host_sweep(split):
    _, _, t_images, t_labels = split
    data = dict(normalize="scale")
    mesh = jax_mesh.build_mesh(JaxParallelConfig(),
                               devices=jax.devices()[:1])
    model_def, mcfg = jax_get_model("cnn"), JaxModelConfig(logit_relu=False)
    jdata = JaxDataConfig(use_native_loader=False, **data)
    jstate = jax_step.init_train_state(jax.random.key(3), model_def, mcfg,
                                       jdata, JaxOptimConfig(), mesh)
    model, state = _state(jax.tree.map(np.asarray, jstate.params))
    m = -(-len(t_images) // B)

    jfull, jtotal = jax_step.make_eval_resident(
        model_def, mcfg, mesh, t_images, t_labels.astype(np.int32), jdata,
        batch_size=B, expected_batches=m)
    full, total = step_lib.make_eval_resident(
        model, t_images, t_labels, DataConfig(**data), CPU, batch_size=B,
        expected_batches=m)
    count = int(full(state))
    assert total == jtotal == len(t_images)
    assert count == int(jax.device_get(jfull(jstate)))

    # The host-fed sweep (numpy decode, padded batches) on the same state.
    cfg = DataConfig(**data)
    it = pipeline.ShuffleBatchIterator([], cfg, B, train=False,
                                       _arrays=(t_images, t_labels))
    ev = step_lib.make_eval_step(model)
    host = sum(int(ev(state, *pipeline.to_device(b, CPU))["correct"])
               for b in it.full_sweep_padded())
    assert count == host

    repl = jax_mesh.replicated(mesh)
    jbatch = jax_step.make_batch_eval_resident(
        model_def, mcfg, mesh, jax.device_put(t_images, repl),
        jax.device_put(t_labels.astype(np.int32), repl), jdata)
    batch = step_lib.make_batch_eval_resident(
        model, *_ds(t_images, t_labels), cfg)
    idx = np.random.default_rng(2).integers(0, len(t_images), B)
    assert float(batch(state, torch.from_numpy(idx))) == float(
        jbatch(jstate, idx.astype(np.int32)))

    with pytest.raises(ValueError, match="padded batches"):
        step_lib.make_eval_resident(model, t_images, t_labels, cfg, CPU,
                                    batch_size=B, expected_batches=m + 1)
    with pytest.raises(ValueError, match="data_cfg"):
        step_lib.make_train_chunk_resident(model, OptimConfig(),
                                           *_ds(t_images, t_labels))


def _args(tmp_path, log="logs", *extra):
    return ["--device", "cpu", "--dataset", "synthetic",
            "--data_dir", str(tmp_path / "data"),
            "--log_dir", str(tmp_path / log),
            "--synthetic_train_records", "160",
            "--fidelity", "fixed", "--learning_rate", "0.02",
            "--batch_size", "16", "--output_every", "10",
            "--eval_every", "10", "--checkpoint_every", "10", *extra]


def _final_params(tmp_path, log):
    """The newest checkpoint's params (port layouts) and the step the
    metrics stream ended at."""
    with open(tmp_path / log / "m.jsonl") as f:
        done = [json.loads(l) for l in f][-1]
    assert done["kind"] == "done"
    path = ckpt.latest_checkpoint(str(tmp_path / log))
    with open(path, "rb") as f:
        tree = checkpoint.from_bytes(f.read())
    return convert.params_from_jax(tree["params"]), done["step"]


def test_cli_chunked_trains_and_resumes_exactly(tmp_path, capsys):
    """``--steps_per_dispatch 5`` trains through the resident device
    stream; a run stopped at step 10 and resumed to 20 ends bit-equal to
    an uninterrupted 20-step run."""
    def run(log, total):
        assert main(_args(tmp_path, log, "--steps_per_dispatch", "5",
                          "--total_steps", str(total), "--metrics_jsonl",
                          str(tmp_path / log / "m.jsonl"))) == 0
        return [TRAIN_LINE.match(l) for l in capsys.readouterr().out
                .splitlines() if l.startswith("global_step")]

    lines = run("full", 20)
    assert [(int(m[1]), int(m[2])) for m in lines] == [(10, 9), (20, 19)]
    run("resumed", 10)
    assert [int(m[1]) for m in run("resumed", 20)] == [20]
    full, step = _final_params(tmp_path, "full")
    resumed, step2 = _final_params(tmp_path, "resumed")
    assert step == step2 == 20 and full.keys() == resumed.keys()
    for name in full:
        assert torch.equal(full[name], resumed[name]), name


def test_cli_chunk_cadence_and_multi_rank_raise(tmp_path):
    with pytest.raises(ValueError, match="multiple of steps_per_dispatch"):
        main(_args(tmp_path, "logs", "--steps_per_dispatch", "3",
                   "--total_steps", "9"))
    # Steps left after a resume must be a multiple too.
    with pytest.raises(ValueError, match="remaining steps"):
        main(_args(tmp_path, "logs", "--steps_per_dispatch", "5",
                   "--total_steps", "12"))
    # Several processes: a 2-rank chunked run trains (its parity with JAX
    # and with one rank is tests/test_torch_chunk_dist.py's).
    hosts = ",".join(f"localhost:{p}" for p in _torch_dist.free_ports(2))
    jsonl = str(tmp_path / "two" / "m.jsonl")
    rcs = _torch_dist.run_ranks(
        "cli_rank", 2, tmp_path / "ranks", _args(
            tmp_path, "two", "--steps_per_dispatch", "5", "--total_steps",
            "10", "--worker_hosts", hosts, "--dist_backend", "gloo",
            "--metrics_jsonl", jsonl))
    assert rcs == [0, 0]
    with open(jsonl) as f:
        recs = [json.loads(l) for l in f]
    train = [r for r in recs if r["kind"] == "train"]
    assert [r["step"] for r in train] == [10]
    assert np.isfinite(train[0]["loss"]) and recs[-1]["kind"] == "done"
