"""PyTorch port, ``--pipe_axis`` and the CNN's ``--seq_axis`` through the
command line, on the CPU.

One spawn of 4 gloo ranks (``tests/_torch_dist.py:cli_traced_runs``) runs
``cli.main`` on the same synthetic data, seed and global batch of 16, 3
steps each:

- the README recipe's ViT (24 px, 37 tokens, plain SGD; depth 4, dim 64,
  2 heads) at ``--pipe_axis 2`` on 2 ranks (saving at step 3) and on one
  rank;
- the CNN at published widths at ``--seq_axis 2`` on 2 ranks and on one.

Both stages (both seq ranks) feed the same images every step and report
the same loss; the logged losses of each split run agree with its
one-rank run at the pins of ``tests/test_pp.py:129`` (rtol 2e-5, atol
2e-6) and ``tests/test_spatial.py:66`` (rtol 1e-5, atol 1e-6); the
``[dist]`` and ``[shardings]`` lines show the axis; the first train
record counts a rank's FLOPs (``pipe_stage_x2``, ``spatial_share_x2``).
Then ``--mode eval`` and ``--mode export`` read the pipelined run's
checkpoint whole in one process.
"""

import json

import numpy as np
import pytest

import _torch_dist

STEPS = 3


def _argv(tmp_path, name, world, *extra, vit=False):
    hosts = ",".join(f"localhost:{p}" for p in _torch_dist.free_ports(world))
    model = ["--model", "vit_tiny", "--vit_depth", "4", "--vit_dim", "64",
             "--vit_heads", "2"] if vit else []
    return ["--device", "cpu", "--dataset", "synthetic",
            "--data_dir", str(tmp_path / "data"),
            "--log_dir", str(tmp_path / name),
            "--synthetic_train_records", "160", "--fidelity", "fixed",
            "--learning_rate", "0.02", "--batch_size", "16",
            "--total_steps", str(STEPS), "--output_every", "1",
            "--eval_every", "1000", "--checkpoint_every", str(STEPS),
            "--worker_hosts", hosts, "--dist_backend", "gloo",
            "--metrics_jsonl", str(tmp_path / f"{name}.jsonl"),
            *model, *extra]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_cli")
    runs = {"pp2": _argv(tmp, "pp2", 2, "--pipe_axis", "2", vit=True),
            "pp1": _argv(tmp, "pp1", 1, vit=True),
            "sp2": _argv(tmp, "sp2", 2, "--seq_axis", "2"),
            "sp1": _argv(tmp, "sp1", 1)}
    ranks = _torch_dist.run_ranks("cli_traced_runs", 4, tmp / "ranks",
                                  list(runs.values()))
    out = {name: [r[i] for r in ranks] for i, name in enumerate(runs)}
    logs = {}
    for name in runs:
        with open(tmp / f"{name}.jsonl") as f:
            logs[name] = [r for r in map(json.loads, f)
                          if r["kind"] == "train"]
    return out, logs, tmp


@pytest.mark.parametrize("split,one,pin,axis,label", [
    ("pp2", "pp1", dict(rtol=2e-5, atol=2e-6), "pipe 1/2",
     "pipe_stage_x2"),
    ("sp2", "sp1", dict(rtol=1e-5, atol=1e-6), "seq 1/2",
     "spatial_share_x2")], ids=["pipe", "spatial"])
def test_cli_split_runs_match_one_rank(cli, split, one, pin, axis, label):
    out, logs, _ = cli
    assert [r and r["rc"] for r in out[split]] == [0, 0, None, None]
    assert out[one][0]["rc"] == 0
    fed = [r["fed"] for r in out[split][:2]]
    assert len(fed[0]) == STEPS and fed[0] == fed[1]
    assert [h for h, _ in fed[0]] == [h for h, _ in out[one][0]["fed"]]
    assert f"{axis}) on cpu" in out[split][1]["stdout"]
    np.testing.assert_allclose([r["loss"] for r in logs[split]],
                               [r["loss"] for r in logs[one]], **pin)
    assert logs[split][0]["flops_stack"] == label
    assert logs[one][0]["flops_stack"] == "exact"


def test_cli_pipe_stage_line(cli):
    out, _, _ = cli
    for stage in (0, 1):
        assert (f"[shardings] pipe_axis=2: stage {stage} holds 2 of 4 "
                f"blocks (12 stacked leaves), schedule 1f1b, 2 "
                f"microbatches") in out["pp2"][stage]["stdout"]


def test_eval_and_export_read_the_pipelined_checkpoint(cli, capsys):
    from dml_cnn_cifar10_tpu_torch.cli.main import main
    _, _, tmp = cli
    argv = _argv(tmp, "pp2", 1, vit=True)
    hosts = argv.index("--worker_hosts")
    del argv[hosts:hosts + 2]
    assert main(argv + ["--mode", "eval"]) == 0
    assert "Test Accuracy" in capsys.readouterr().out
    assert main(argv + ["--mode", "export"]) == 0
    assert "exported step-3 forward" in capsys.readouterr().out
