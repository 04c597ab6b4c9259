"""PyTorch port, data/device_stream.py, against the JAX package.

The port computes the JAX module's uint32 Feistel stream in int64 tensors
masked to 32 bits. Its rows must be BIT-EXACT against the JAX module's for
every tested (seed, start position, count, n), including positions that
wrap at 2^32, in both of its walk forms: the exact cycle walk (the CPU and
any eager caller) and the epoch table a captured CUDA graph gathers from.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu.data import device_stream as jax_ds
from dml_cnn_cifar10_tpu_torch.data import device_stream as ds

torch.set_num_threads(2)

CPU = torch.device("cpu")
SEEDS = (0, 7, 2**31 + 5)
# A start at 0, one mid-stream, and one just below 2^32 (the position
# wraps inside the window).
STARTS = (0, 123457, 2**32 - 50)


def test_mul32_is_the_uint32_product():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 1000, dtype=np.uint64)
    for c in (0, 1, 0xFFFF, 0x10000, ds._C0, ds._MIX2, 2**32 - 1):
        got = ds._mul32(torch.from_numpy(x.astype(np.int64)), c)
        want = (x * np.uint64(c)) & np.uint64(2**32 - 1)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", [2, 4097, 10000, 50000])
def test_positions_to_rows_bit_exact_against_jax(n):
    count = 200
    for seed in SEEDS:
        for j0 in STARTS:
            want = np.asarray(jax_ds._positions_to_rows(
                seed, jnp.uint32(j0), count, n))
            got = ds._positions_to_rows(seed, j0, count, n)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"seed {seed} j0 {j0}")
            # The graph's form: a table of whole epochs, gathered from by
            # a device step (batch 1, so position = step).
            rows = ds.EpochRows(seed, 1, count, n, CPU)
            rows.prepare(j0)
            table = rows.lookup(torch.tensor(j0, dtype=torch.int64))
            np.testing.assert_array_equal(table.reshape(-1).numpy(), want)
            rows.check()


@pytest.mark.parametrize("seed", [3, 11])
def test_step_and_chunk_indices_match_jax(seed):
    n, b, k = 777, 32, 5
    for step in (0, 3, 40, 100):
        want = np.asarray(jax_ds.epoch_shuffle_indices(
            seed, jnp.uint32(step), b, n))
        got = ds.epoch_shuffle_indices(
            seed, torch.tensor(step, dtype=torch.int32), b, n)
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(jax_ds.chunk_shuffle_indices(
            seed, jnp.uint32(step), b, k, n))
        got = ds.chunk_shuffle_indices(seed, step, b, k, n)
        np.testing.assert_array_equal(got.numpy(), want)
        rows = ds.EpochRows(seed, b, k, n, CPU)
        rows.prepare(step)
        np.testing.assert_array_equal(
            rows.lookup(torch.tensor(step, dtype=torch.int32)).numpy(), want)


@pytest.mark.parametrize("n", [1, 3, 640, 4097])
def test_epoch_is_exact_permutation(n):
    b = 64
    steps = (n + b - 1) // b + 1
    rows = torch.cat([ds.epoch_shuffle_indices(3, s, b, n)
                      for s in range(steps)])[:n]
    assert rows.min() >= 0 and rows.max() < n
    assert len(torch.unique(rows)) == n


def test_epochs_differ_and_seed_matters():
    n, b = 1000, 50

    def epoch(seed, e):
        return torch.cat([ds.epoch_shuffle_indices(seed, s, b, n)
                          for s in range(e * n // b, (e + 1) * n // b)])

    e0 = epoch(7, 0)
    assert not torch.equal(e0, epoch(7, 1))
    assert not torch.equal(e0, epoch(8, 0))
    assert torch.equal(e0, epoch(7, 0))


def test_table_refreshes_per_epoch_and_counts_misses():
    n, b, k = 100, 16, 5          # 80 rows a chunk: at most 2 epochs
    rows = ds.EpochRows(1, b, k, n, CPU)
    assert rows.slots == 2
    for step in range(0, 40, k):
        rows.prepare(step)
        np.testing.assert_array_equal(
            rows.lookup(torch.tensor(step)).numpy(),
            ds.chunk_shuffle_indices(1, step, b, k, n).numpy())
    # Steps 0-39 cover positions 0-639: epochs 0-6, each built once.
    assert rows.epochs_built == 7 and rows.host_reads >= 7
    rows.check()
    # A chunk whose epochs the table does not hold is counted, and the
    # boundary check raises.
    rows.lookup(torch.tensor(200))
    assert int(rows.misses) > 0
    with pytest.raises(RuntimeError, match="did not hold their epoch"):
        rows.check()


def test_range_guard_rejects_wrapping_runs():
    ds.check_supported_range(20000, 512)
    ds.check_supported_range((1 << 32) // 512 - 1, 512)
    with pytest.raises(ValueError, match="uint32"):
        ds.check_supported_range((1 << 32) // 512, 512)
    with pytest.raises(ValueError, match="positive"):
        ds.epoch_shuffle_indices(0, 0, 8, 0)
