"""PyTorch port, export.py + the serving engine against the JAX package's
``export.make_serving_fn`` on the CPU.

The same numpy-seeded uint8 images go through the JAX serving function
and through the port's exported artifact and its live-weights engine,
with the JAX weights carried across by ``convert.params_from_jax``:

- the reference CNN at full width (1,068,298 params, 24×24 crop of 32×32
  images), batch 8;
- the small ViT of ``tests/test_torch_vit.py`` (depth 2, dim 64, 2 heads,
  48×48 crop of 52×52 images: 145 tokens), so the JAX function runs its
  Pallas flash kernel in interpret mode and the port its registered flash
  operator on the plain version.

Logits agree within 1e-4 (the pin of ``test_torch_vit.py``: f32 sums in
another order, and the per-image standardization's f32 std rounded
differently); the artifact and the live engine run the same PyTorch ops
and agree within 1e-6.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu import export as jax_export
from dml_cnn_cifar10_tpu.ckpt import checkpoint as jax_ckpt
from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.config import ModelConfig as JaxModelConfig
from dml_cnn_cifar10_tpu.config import OptimConfig as JaxOptimConfig
from dml_cnn_cifar10_tpu.models.registry import get_model as jax_get_model
from dml_cnn_cifar10_tpu.parallel import step as jax_step
from dml_cnn_cifar10_tpu_torch import convert
from dml_cnn_cifar10_tpu_torch import export as export_lib
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              TrainConfig)
from dml_cnn_cifar10_tpu_torch.models.registry import get_model
from dml_cnn_cifar10_tpu_torch.serve.engine import ServingEngine
from dml_cnn_cifar10_tpu_torch.serve.server import resolve_engine

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOL, SAME_TOL = 1e-4, 1e-6
FLASH_OP = torch.ops.dml_torch.flash_attention_out.default


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_exp():
    """One ``torch.exp`` before the module's tests: with torch 2.13.0+cpu
    (MKL 2024.2, AVX-512) the first ``exp`` of a freshly started worker
    process can be off by 1.5e-4 relative when several workers start
    together, and is exact from the second call on (ROADMAP.md Queue 3)."""
    torch.exp(torch.linspace(-10.0, 0.0, 1 << 16))

# name -> (model config, data config): the CNN at full width and the
# small ViT whose 145 tokens take the flash path.
CASES = {
    "cnn": (dict(name="cnn", logit_relu=False),
            dict(normalize="standardize")),
    "vit": (dict(name="vit_tiny", vit_dim=64, vit_depth=2, vit_heads=2,
                 logit_relu=False),
            dict(image_height=52, image_width=52, crop_height=48,
                 crop_width=48, normalize="standardize")),
}


def _images(n, dkw, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, dkw.get("image_height", 32),
                                 dkw.get("image_width", 32), 3),
                        dtype=np.uint8)


def _jax_setup(case, seed=0):
    mkw, dkw = CASES[case]
    mcfg, dcfg = JaxModelConfig(**mkw), JaxDataConfig(**dkw)
    model_def = jax_get_model(mcfg.name)
    params = jax.tree.map(np.asarray, model_def.init(
        jax.random.key(seed), mcfg, dcfg))
    return model_def, mcfg, dcfg, params


def _jax_logits(model_def, mcfg, dcfg, params, images):
    fn = jax_export.make_serving_fn(model_def, mcfg, dcfg, params)
    return np.asarray(jax.jit(fn)(images))


def _port_model(case, params_np=None):
    mkw, dkw = CASES[case]
    mcfg, dcfg = ModelConfig(**mkw), DataConfig(**dkw)
    model = get_model(mcfg.name)(mcfg, dcfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = None if params_np is None else convert.params_from_jax(params_np)
    return model, dcfg, params


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Per case: the JAX weights and reference logits on 8 images, and
    the port's artifact path and live engine over the same weights."""
    out = {}
    for case in CASES:
        model_def, mcfg, dcfg, params = _jax_setup(case)
        images = _images(8, CASES[case][1], seed=1)
        model, pdcfg, pparams = _port_model(case, params)
        path = str(tmp_path_factory.mktemp(case) / "model.pt2")
        program = export_lib.export_forward(model, pdcfg, pparams)
        export_lib.save_exported(path, program)
        out[case] = dict(
            want=_jax_logits(model_def, mcfg, dcfg, params, images),
            images=images, path=path, program=program,
            live=ServingEngine.from_params(model, pdcfg, pparams, "cpu"))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_and_live_engine_match_jax_serving_fn(exported, case):
    ex = exported[case]
    art = ServingEngine.from_artifact(ex["path"], "cpu")
    got_art, _ = art.forward_timed(ex["images"])
    got_live, _ = ex["live"].forward_timed(ex["images"])
    assert got_art.shape == got_live.shape == (8, 10)
    assert got_art.dtype == np.float32
    np.testing.assert_allclose(got_art, ex["want"], rtol=0, atol=JAX_TOL)
    np.testing.assert_allclose(got_live, ex["want"], rtol=0, atol=JAX_TOL)
    np.testing.assert_allclose(got_art, got_live, rtol=0, atol=SAME_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_reads_its_own_input_contract(exported, case):
    dkw = CASES[case][1]
    want = (dkw.get("image_height", 32), dkw.get("image_width", 32), 3)
    assert export_lib.artifact_image_shape(exported[case]["program"]) == want
    art = ServingEngine.from_artifact(exported[case]["path"], "cpu")
    assert art.image_shape == want and art.version == "artifact"
    assert not art.swappable


def test_vit_artifact_graph_holds_the_flash_operator(exported):
    """The ViT's attention is one opaque node a block: the artifact
    launches K3 on the card, not a decomposed plain attention."""
    for case, want in (("vit", 2), ("cnn", 0)):
        program = export_lib.load_program(exported[case]["path"])
        calls = [n for n in program.graph.nodes
                 if n.op == "call_function" and n.target == FLASH_OP]
        assert len(calls) == want, case
    vit = exported["vit"]["program"]
    assert not any("softmax" in str(n.target) for n in vit.graph.nodes)


@pytest.mark.parametrize("mask", [dict(), dict(causal=True, window=20),
                                  dict(segments=True)],
                         ids=["full", "causal_window", "segments"])
def test_flash_operator_registration_and_jax_parity(mask):
    """``dml_torch::flash_attention_out`` passes torch's operator checks
    (schema, fake kernel, dynamic shapes) and its CPU kernel gives the JAX
    package's flash kernel (interpret mode) within the flash out pin."""
    from dml_cnn_cifar10_tpu.ops import flash_attention as jax_fa

    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, 130, 2, 32)).astype(np.float32)
               for _ in range(3))
    seg = None
    if mask.get("segments"):
        seg = np.repeat((np.arange(130) >= 60)[None], 2, 0).astype(np.int32)
    causal, window = mask.get("causal", False), mask.get("window")
    tseg = None if seg is None else torch.from_numpy(seg)
    args = (*map(torch.from_numpy, (q, k, v)), tseg, tseg, 32 ** -0.5,
            causal, window)
    checks = torch.library.opcheck(FLASH_OP, args)
    assert set(checks.values()) == {"SUCCESS"}, checks
    want = np.asarray(jax_fa.flash_attention(
        q, k, v, causal=causal, window=window,
        segment_ids=None if seg is None else jax.numpy.asarray(seg)))
    np.testing.assert_allclose(FLASH_OP(*args).numpy(), want, rtol=0,
                               atol=5e-6)


@pytest.mark.parametrize("b", [1, 3, 8, 128])
def test_one_cnn_artifact_serves_every_batch_size(exported, b):
    """The batch dimension stays symbolic: one artifact at b = 1 (no 0/1
    specialization), odd sizes and the largest bucket, equal to the
    eager serving forward row for row."""
    fn = export_lib.load_exported(exported["cnn"]["path"])
    images = _images(b, {}, seed=10 + b)
    with torch.no_grad():
        got = fn(torch.from_numpy(images))
    want, _ = exported["cnn"]["live"].forward_timed(images)
    assert got.shape == (b, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SAME_TOL)


def test_vit_artifact_serves_batch_of_one(exported):
    ex = exported["vit"]
    fn = export_lib.load_exported(ex["path"])
    with torch.no_grad():
        one = fn(torch.from_numpy(ex["images"][:1]))
    np.testing.assert_allclose(one.numpy(), ex["want"][:1], rtol=0,
                               atol=JAX_TOL)


def _jax_checkpoint(tmp_path, case, **optim):
    """A JAX-package run stepped twice and saved as its msgpack
    checkpoint; returns (dir, state, model_def, mcfg, dcfg)."""
    model_def, mcfg, dcfg, _ = _jax_setup(case, seed=3)
    ocfg = JaxOptimConfig(learning_rate=0.01, **optim)
    state = jax_step.init_train_state(jax.random.key(3), model_def, mcfg,
                                      dcfg, ocfg)
    train = jax_step.make_train_step(model_def, mcfg, ocfg)
    rng = np.random.default_rng(4)
    h = dcfg.crop_height
    for _ in range(2):
        state, _ = train(state, rng.normal(size=(4, h, h, 3)).astype(
            np.float32), rng.integers(0, 10, 4).astype(np.int32))
    path = str(tmp_path / "jax_run")
    jax_ckpt.save_checkpoint(path, state, step=2)
    return path, state, model_def, mcfg, dcfg


@pytest.mark.parametrize("case,optim", [
    ("cnn", dict(momentum=0.9, ema_decay=0.9)),
    ("vit", dict(optimizer="adamw")),
], ids=["cnn-ema", "vit-adamw"])
def test_jax_checkpoint_served_live_matches_jax(tmp_path, case, optim):
    """``resolve_engine`` with no artifact restores the newest checkpoint
    (a JAX-package msgpack file, read byte for byte) and serves it live,
    versioned with its step: the EMA weights when the run kept them, as
    the JAX export does."""
    path, state, model_def, mcfg, dcfg = _jax_checkpoint(tmp_path, case,
                                                         **optim)
    served = state.opt.get("ema", state.params)
    images = _images(4, CASES[case][1], seed=5)
    want = _jax_logits(model_def, mcfg, dcfg,
                       jax.tree.map(np.asarray, served), images)
    mkw, dkw = CASES[case]
    cfg = TrainConfig(log_dir=path, device="cpu")
    cfg.model, cfg.data = ModelConfig(**mkw), DataConfig(**dkw)
    for k, v in optim.items():
        setattr(cfg.optim, k, v)
    engine = resolve_engine(cfg)
    assert engine.swappable and engine.version == "2"
    got, _ = engine.forward_timed(images)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)


def test_mode_export_then_serve_through_the_cli(tmp_path):
    """``--mode export`` then ``--mode serve`` as a user runs them on the
    CPU: the server finds ``<log_dir>/model.pt2``, answers a request, and
    drains and exits 0 on SIGTERM."""
    from dml_cnn_cifar10_tpu_torch.cli.main import main

    args = ["--device", "cpu", "--log_dir", str(tmp_path / "logs"),
            "--fidelity", "fixed"]
    assert main(args + ["--mode", "export"]) == 0
    artifact = tmp_path / "logs" / "model.pt2"
    assert artifact.is_file()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dml_cnn_cifar10_tpu_torch", *args,
         "--mode", "serve", "--serve_port", "0", "--serve_buckets", "1,4",
         "--metrics_jsonl", str(tmp_path / "serve.jsonl")],
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
        assert any(str(artifact) in l for l in lines), "".join(lines)
        body = np.zeros((32, 32, 3), np.uint8).tobytes()
        reply = json.loads(urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=body),
            timeout=60).read())
        assert reply["version"] == "artifact" and len(reply["logits"]) == 10
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, rest
    assert "signal 15" in rest and "exiting cleanly (drained)" in rest
    kinds = [json.loads(l)["kind"] for l in open(tmp_path / "serve.jsonl")]
    assert kinds.count("compile") == 2 and kinds[-1] == "serve_done"
