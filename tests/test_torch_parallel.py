"""PyTorch port, multi-process training against the JAX package on the CPU.

Ranks are spawned gloo processes (``tests/_torch_dist.py``), the JAX side
runs in this process on the 8-virtual-device mesh of ``conftest.py``, on
the same seeded numpy inputs and the same initial params:

- ViT sequence parallelism: two SGD steps on data 2 x seq 2 ranks against
  JAX ``make_train_step`` on a ``(data 4, model 1, seq 2)`` mesh — a pure
  layout change of the same global batch, held to the pins of
  ``tests/test_sp_train.py`` (loss rtol 2e-5, atol 2e-6) and params 1e-5.
- CNN data parallelism: three steps on 2 ranks against JAX on ``data=8``,
  params 1e-5, and bit-equal on both ranks.
- the differentiable all-reduce, the mesh's world check, the host-list
  validation, and a 2-rank CLI run whose chief-written checkpoint a
  one-process ``--mode eval`` restores.
"""

import os
import re

import jax
import numpy as np
import pytest

import _torch_dist
from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.config import ModelConfig as JaxModelConfig
from dml_cnn_cifar10_tpu.config import OptimConfig as JaxOptimConfig
from dml_cnn_cifar10_tpu.config import ParallelConfig as JaxParallelConfig
from dml_cnn_cifar10_tpu.models.registry import get_model as jax_get_model
from dml_cnn_cifar10_tpu.parallel import mesh as jax_mesh
from dml_cnn_cifar10_tpu.parallel import step as jax_step
from dml_cnn_cifar10_tpu_torch import convert
from dml_cnn_cifar10_tpu_torch.cli.main import main
from dml_cnn_cifar10_tpu_torch.config import ParallelConfig
from dml_cnn_cifar10_tpu_torch.parallel import multihost


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_train(model_kw, data_kw, optim_kw, axes, batches):
    """JAX train steps on a ``(data, model, seq)`` mesh → (initial params,
    per-step (loss, accuracy), final params), numpy trees."""
    mcfg, dcfg = JaxModelConfig(**model_kw), JaxDataConfig(**data_kw)
    ocfg = JaxOptimConfig(**optim_kw)
    data, model, seq = axes
    mesh = jax_mesh.build_mesh(JaxParallelConfig(
        data_axis=data, model_axis=model, seq_axis=seq))
    model_def = jax_get_model(mcfg.name)
    sh = jax_step.train_state_shardings(mesh, model_def, mcfg, dcfg, ocfg)
    state = jax_step.init_train_state(jax.random.key(0), model_def, mcfg,
                                      dcfg, ocfg, mesh, state_sharding=sh)
    params0 = _np(state.params)
    train = jax_step.make_train_step(model_def, mcfg, ocfg, mesh,
                                     state_sharding=sh)
    metrics = []
    for images, labels in batches:
        state, m = train(state, *jax_mesh.shard_batch(mesh, images, labels))
        metrics.append((float(m["loss"]), float(m["accuracy"])))
    return params0, metrics, _np(state.params)


def _check_against_jax(ranks, jax_metrics, jax_final, loss_rtol, loss_atol):
    want = convert.params_from_jax(jax_final)
    for metrics, final in ranks:
        np.testing.assert_allclose([m[0] for m in metrics],
                                   [m[0] for m in jax_metrics],
                                   rtol=loss_rtol, atol=loss_atol)
        assert [m[1] for m in metrics] == [m[1] for m in jax_metrics]
        assert sorted(final) == sorted(want)
        for name, value in final.items():
            np.testing.assert_allclose(value, want[name].numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)


# ViT at 64x64, patch 4: 256 tokens, 128 a seq rank — the flash engine's
# length (the port's K5/K6/K7 wrappers, on their plain versions here). The
# JAX side runs its ring on the jnp engine, the same math.
VIT = dict(name="vit_tiny", pool="mean", logit_relu=False, vit_depth=2,
           vit_dim=64, vit_heads=2, patch_size=4)
VIT_DATA = dict(crop_height=64, crop_width=64)


def test_sp_vit_train_steps_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    batches = [(rng.normal(0.5, 0.25, (8, 64, 64, 3)).astype(np.float32),
                rng.integers(0, 10, 8).astype(np.int32)) for _ in range(2)]
    optim = dict(learning_rate=0.01)
    params0, jm, jfinal = _jax_train(
        dict(VIT, use_pallas_attention=False), VIT_DATA, optim, (4, 1, 2),
        batches)
    ranks = _torch_dist.run_ranks("train_steps", 4, tmp_path, 2, VIT,
                                  VIT_DATA, optim, params0, batches)
    _check_against_jax(ranks, jm, jfinal, 2e-5, 2e-6)


def test_dp_cnn_train_steps_match_jax_and_agree_bitwise(tmp_path):
    rng = np.random.default_rng(1)
    batches = [(rng.uniform(0, 1, (16, 24, 24, 3)).astype(np.float32),
                rng.integers(0, 10, 16).astype(np.int32)) for _ in range(3)]
    model = dict(name="cnn", logit_relu=False)
    optim = dict(learning_rate=0.01, dead_lr_decay=False)
    params0, jm, jfinal = _jax_train(model, {}, optim, (8, 1, 1), batches)
    ranks = _torch_dist.run_ranks("train_steps", 2, tmp_path, 1, model, {},
                                  optim, params0, batches)
    _check_against_jax(ranks, jm, jfinal, 1e-5, 0)
    (m0, p0), (m1, p1) = ranks
    assert m0 == m1
    for name in p0:
        np.testing.assert_array_equal(p0[name], p1[name], err_msg=name)


def test_all_reduce_sums_both_ways_and_mesh_checks_world(tmp_path):
    for y, grad, errors in _torch_dist.run_ranks("all_reduce_grad", 2,
                                                 tmp_path):
        np.testing.assert_array_equal(y, [3.0, 3.0, 3.0])     # 1 + 2
        np.testing.assert_array_equal(grad, [3.0, 3.0, 3.0])  # 1 + 2
        assert len(errors) == 2
        assert all("does not split into seq_axis" in e for e in errors)


@pytest.mark.parametrize("hosts,task,match", [
    ([], 0, "empty"),
    (["a:1", ""], 0, "trailing/doubled comma"),
    (["a:1", "b"], 0, "not host:port"),
    (["a:1", "a:1"], 1, "duplicated"),
    (["a:1", "b:2"], 2, "out of range"),
])
def test_validate_hosts_errors(hosts, task, match):
    with pytest.raises(ValueError, match=match):
        multihost.validate_hosts(hosts, task)


def test_hosts_fill_the_parallel_config():
    cfg = multihost.parallel_from_hosts(["h:1", "h:2", "h:3"], 2,
                                        ParallelConfig(seq_axis=3))
    assert (cfg.coordinator_address, cfg.num_processes, cfg.process_id,
            cfg.seq_axis) == ("h:1", 3, 2, 3)
    assert multihost.is_chief(ParallelConfig()) and not \
        multihost.is_chief(cfg)


EVAL_LINE = re.compile(r"^ --- Test Accuracy = (\d+\.\d\d)%\.$")


def test_two_rank_cli_checkpoint_restores_in_one_process(tmp_path, capsys):
    args = ["--device", "cpu", "--dataset", "synthetic",
            "--data_dir", str(tmp_path / "data"),
            "--log_dir", str(tmp_path / "logs"),
            "--synthetic_train_records", "320", "--fidelity", "fixed",
            "--learning_rate", "0.02", "--batch_size", "32",
            "--output_every", "10", "--eval_every", "20",
            "--checkpoint_every", "20"]
    hosts = ",".join(f"localhost:{p}" for p in _torch_dist.free_ports(2))
    jsonl = str(tmp_path / "m.jsonl")
    rcs = _torch_dist.run_ranks(
        "cli_rank", 2, tmp_path / "ranks", args + [
            "--total_steps", "20", "--worker_hosts", hosts,
            "--dist_backend", "gloo", "--metrics_jsonl", jsonl])
    assert rcs == [0, 0]
    logs = sorted(os.listdir(tmp_path / "logs"))
    assert logs == ["checkpoint", "ckpt_20.msgpack", "ckpt_20.msgpack.sha256",
                    "data_state_20.json"]
    with open(jsonl) as f:
        lines = f.read().splitlines()
    assert lines and all('"task": 0' in l for l in lines)   # chief only
    assert main(args + ["--mode", "eval"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert any("eval at step 20" in l for l in out)
    acc = [float(EVAL_LINE.match(l)[1]) for l in out if EVAL_LINE.match(l)]
    assert len(acc) == 1 and acc[0] > 50.0      # chance is 10%
