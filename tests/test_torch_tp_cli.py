"""PyTorch port, ``--model_axis`` through the command line, on the CPU.

One spawn of 4 gloo ranks (``tests/_torch_dist.py:cli_traced_runs``)
trains the CNN at published widths through ``cli.main`` twice on the same
synthetic data, seed and global batch of 16: data 2 x model 2 on the 4
ranks, then replicated data parallelism on the first 2. The trainer
shards the records by data rank, so both model ranks of a data row feed
the same images every step, the data rows feed different ones, and each
data row feeds what the same data rank of the 2-rank run feeds. The
logged losses of the two runs agree at the pins of
``tests/test_tp.py:104-121`` (rtol 1e-5, atol 1e-6); the ``[dist]`` and
``[shardings]`` lines and ``--partition_report`` show the model axis, and
the first train record counts a model rank's FLOPs
(``model_share_x2``).
"""

import json

import numpy as np
import pytest

import _torch_dist

STEPS = 3


def _argv(tmp_path, name, world, model_axis):
    hosts = ",".join(f"localhost:{p}" for p in _torch_dist.free_ports(world))
    return ["--device", "cpu", "--dataset", "synthetic",
            "--data_dir", str(tmp_path / "data"),
            "--log_dir", str(tmp_path / name),
            "--synthetic_train_records", "160", "--fidelity", "fixed",
            "--learning_rate", "0.02", "--momentum", "0.9",
            "--batch_size", "16", "--total_steps", str(STEPS),
            "--output_every", "1", "--eval_every", "1000",
            "--checkpoint_every", "1000", "--partition_report", "true",
            "--model_axis", str(model_axis), "--worker_hosts", hosts,
            "--dist_backend", "gloo",
            "--metrics_jsonl", str(tmp_path / f"{name}.jsonl")]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_cli")
    ranks = _torch_dist.run_ranks("cli_traced_runs", 4, tmp / "ranks", [
        _argv(tmp, "tp", 4, 2), _argv(tmp, "dp", 2, 1)])
    logs = {}
    for name in ("tp", "dp"):
        with open(tmp / f"{name}.jsonl") as f:
            logs[name] = [r for r in map(json.loads, f)
                          if r["kind"] == "train"]
    return ranks, logs


def test_cli_model_axis_runs_every_rank(cli):
    ranks, _ = cli
    assert [r[0]["rc"] for r in ranks] == [0] * 4
    assert [r[1] and r[1]["rc"] for r in ranks] == [0, 0, None, None]
    for rank, r in enumerate(ranks):
        out = r[0]["stdout"]
        assert (f"[dist] rank {rank}/4 (data {rank // 2}/2, model "
                f"{rank % 2}/2, seq 0/1) on cpu") in out
        assert (f"[shardings] model_axis=2: model rank {rank % 2} holds 3 "
                f"leaves' slices (full1.kernel, full1.bias, full2.kernel)"
                in out)
    # The chief's partition report places `model` on the Megatron pair.
    assert "full1/kernel  (2304, 384)" in ranks[0][0]["stdout"]


def test_cli_model_ranks_of_a_data_row_feed_the_same_batch(cli):
    ranks, _ = cli
    fed = [[h for h, _ in r[0]["fed"]] for r in ranks]
    assert all(len(f) == STEPS for f in fed)
    assert fed[0] == fed[1] and fed[2] == fed[3]
    assert all(a != b for a, b in zip(fed[0], fed[2]))
    # Each data row reads what the same data rank of the DP run reads.
    assert fed[0] == [h for h, _ in ranks[0][1]["fed"]]
    assert fed[2] == [h for h, _ in ranks[1][1]["fed"]]
    # Every rank's step reports the same loss: the mean over the data.
    losses = [[l for _, l in r[0]["fed"]] for r in ranks]
    assert losses[0] == losses[1] == losses[2] == losses[3]


def test_cli_model_axis_losses_match_data_parallel(cli):
    _, logs = cli
    assert [r["step"] for r in logs["tp"]] == list(range(1, STEPS + 1))
    assert [r["step"] for r in logs["dp"]] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([r["loss"] for r in logs["tp"]],
                               [r["loss"] for r in logs["dp"]],
                               rtol=1e-5, atol=1e-6)
    assert logs["tp"][0]["flops_stack"] == "model_share_x2"
    assert logs["dp"][0]["flops_stack"] != "model_share_x2"
