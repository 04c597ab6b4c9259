"""Spawned gloo ranks on the CPU for the port's distributed tests.

:func:`run_ranks` starts ``world`` processes (multiprocessing ``spawn``),
each of which joins a gloo process group through a ``file://`` rendezvous,
runs one of the worker bodies below with one torch thread, and leaves its
result in a pickle file. Every join has a timeout, and gloo's own timeout
bounds every collective, so a deadlock fails the test instead of hanging
the suite. This module imports no JAX: the bodies run the port alone, and
the tests compare their results with the JAX package in the pytest
process.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
import traceback

import numpy as np
import torch

COLLECTIVE_TIMEOUT_S = 60


def _entry(fn_name, rank, world, init_file, out_dir, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        result = globals()[fn_name](rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn_name: str, world: int, tmp_dir, *args,
              timeout_s: float = 150.0):
    """Run ``fn_name(rank, world, *args)`` on ``world`` gloo ranks; returns
    the ranks' results in rank order. Raises if a rank fails or any is
    still running after ``timeout_s``."""
    import multiprocessing as mp
    out_dir = os.fspath(tmp_dir)
    os.makedirs(out_dir, exist_ok=True)
    init_file = os.path.join(out_dir, f"rendezvous_{time.time_ns()}")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn_name, r, world, init_file,
                                              out_dir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        raise AssertionError(f"ranks {hung} of {fn_name} still running "
                             f"after {timeout_s} s (deadlock?)")
    errors = []
    for r, p in enumerate(procs):
        if p.exitcode != 0:
            path = os.path.join(out_dir, f"rank{r}.err")
            msg = open(path).read() if os.path.isfile(path) else ""
            errors.append(f"rank {r} exit {p.exitcode}:\n{msg}")
    if errors:
        raise AssertionError("\n".join(errors))
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# Worker bodies (port only).
# ---------------------------------------------------------------------------


def ring_cases(rank, world, seq, cases):
    """Each case: ``(name, q, k, v, kw)`` global ``[B, S, H, D]`` arrays
    (float32, or with ``kw["dtype"] == "bfloat16"`` cast to bf16). This
    rank takes its data rank's batch rows and its seq shard, runs the
    ring forward and backward of ``sum(sin(out))``, and returns
    ``{name: (out, dq, dk, dv)}`` of its shard as float32 arrays."""
    from dml_cnn_cifar10_tpu_torch.config import ParallelConfig
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import ring_attention as ring

    mesh = mesh_lib.build_mesh(ParallelConfig(seq_axis=seq))
    res = {}
    for name, q, k, v, kw in cases:
        kw = dict(kw)
        dtype = getattr(torch, kw.pop("dtype", "float32"))
        b = q.shape[0] // mesh.data
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        s = q.shape[1] // seq
        cols = slice(mesh.seq_rank * s, (mesh.seq_rank + 1) * s)
        shards = [torch.tensor(a[rows, cols]).to(dtype).requires_grad_()
                  for a in (q, k, v)]
        out = ring.ring_attention_local(*shards, mesh, **kw)
        torch.sin(out.float()).sum().backward()
        res[name] = tuple(t.detach().float().numpy()
                          for t in (out, *(x.grad for x in shards)))
    return res


def ulysses_cases(rank, world, seq, cases):
    """Each case: ``(name, q, k, v, seg, kw)`` global ``[B, S, H, D]``
    arrays and ``[B, S]`` segment ids or None (float32, or with
    ``kw["dtype"] == "bfloat16"`` cast to bf16). This rank takes its data
    rank's batch rows and its seq shard, runs Ulysses attention forward
    and the backward of ``sum(sin(out))``, and returns ``{name: (out, dq,
    dk, dv)}`` of its shard as float32 arrays."""
    from dml_cnn_cifar10_tpu_torch.config import ParallelConfig
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import ulysses

    mesh = mesh_lib.build_mesh(ParallelConfig(seq_axis=seq))
    res = {}
    for name, q, k, v, seg, kw in cases:
        kw = dict(kw)
        dtype = getattr(torch, kw.pop("dtype", "float32"))
        b = q.shape[0] // mesh.data
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        s = q.shape[1] // seq
        cols = slice(mesh.seq_rank * s, (mesh.seq_rank + 1) * s)
        shards = [torch.tensor(a[rows, cols]).to(dtype).requires_grad_()
                  for a in (q, k, v)]
        if seg is not None:
            kw["segment_ids"] = torch.tensor(seg[rows, cols])
        out = ulysses.ulysses_attention_local(*shards, mesh, **kw)
        torch.sin(out.float()).sum().backward()
        res[name] = tuple(t.detach().float().numpy()
                          for t in (out, *(x.grad for x in shards)))
    return res


def all_reduce_grad(rank, world):
    """The differentiable all-reduce: forward sum, backward sum."""
    from dml_cnn_cifar10_tpu_torch.config import ParallelConfig
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.build_mesh(ParallelConfig())
    x = torch.full((3,), float(rank + 1), requires_grad=True)
    y = mesh_lib.all_reduce_sum(x, mesh, "world")
    (y * (rank + 1)).sum().backward()
    errors = []
    for seq in (3, 4):
        try:
            mesh_lib.build_mesh(ParallelConfig(seq_axis=seq))
        except ValueError as e:
            errors.append(str(e))
    return y.detach().numpy(), x.grad.numpy(), errors


def train_steps(rank, world, seq, model, data, optim, params, batches):
    """``len(batches)`` port train steps from ``params`` (JAX-layout numpy
    tree) over a ``data x seq`` mesh; each batch is the GLOBAL
    ``(images, labels)``, of which this rank takes its data rank's rows.
    Returns the per-step metrics, the final params and the launch
    counts."""
    from dml_cnn_cifar10_tpu_torch import convert
    from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                                  OptimConfig,
                                                  ParallelConfig)
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    mesh = mesh_lib.build_mesh(ParallelConfig(seq_axis=seq))
    mcfg = ModelConfig(**model)
    net = get_model(mcfg.name)(mcfg, DataConfig(**data), mesh=mesh)
    ocfg = OptimConfig(**optim)
    cpu = torch.device("cpu")
    state = step_lib.init_train_state(net, ocfg, cpu,
                                      torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, value in convert.params_from_jax(params).items():
            state.params[name].copy_(value)
    train = step_lib.make_train_step(net, ocfg, mesh)
    metrics = []
    for images, labels in batches:
        b = images.shape[0] // mesh.data
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        state, m = train(state, torch.from_numpy(images[rows]),
                         torch.from_numpy(labels[rows].astype(np.int64)))
        metrics.append((float(m["loss"]), float(m["accuracy"])))
    final = {k: v.detach().numpy().copy() for k, v in state.params.items()}
    return metrics, final


def cli_rank(rank, world, argv):
    """``cli.main.main(argv)`` as this rank, on its own rendezvous (the
    CLI initializes the process group from --worker_hosts), so the gloo
    group made by :func:`_entry` is dropped first."""
    import torch.distributed as dist

    from dml_cnn_cifar10_tpu_torch.cli.main import main
    dist.destroy_process_group()
    return main(list(argv) + ["--task_index", str(rank)])
