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


def free_ports(n):
    """``n`` free TCP ports on the loopback interface."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


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


def _port_state(net, ocfg, params):
    """A port train state on the CPU holding ``params`` (a JAX-layout
    numpy tree)."""
    from dml_cnn_cifar10_tpu_torch import convert
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    state = step_lib.init_train_state(net, ocfg, torch.device("cpu"),
                                      torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, value in convert.params_from_jax(params).items():
            state.params[name].copy_(value)
    return state


def _final(state):
    return {k: v.detach().numpy().copy() for k, v in state.params.items()}


def dp_chunks(rank, world, data, optim, params, split, test_split, k,
              batch, host_idx, seed):
    """The DP CNN's chunked paths over ``world`` data ranks, each from
    ``params``: the resident chunk on the device index stream (seed
    ``seed``, global ``batch``), the resident chunk on host indices
    (``host_idx``: per dispatch the global ``[k, batch]`` rows, whose
    columns of data rank r all lie in shard r; this rank takes its
    columns as shard rows, which ``global_rows`` maps back), the host-fed
    raw chunk of the same rows beside ``k`` single DP steps decoded at
    their columns, and the resident full-test eval of this rank's shard
    at the final stream state. Returns each path's per-dispatch (loss,
    accuracy) and final params, and the eval count."""
    from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                                  OptimConfig,
                                                  ParallelConfig)
    from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
    from dml_cnn_cifar10_tpu_torch.ops.preprocess import device_preprocess
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    mesh = mesh_lib.build_mesh(ParallelConfig())
    dcfg, ocfg = DataConfig(**data), OptimConfig(**optim)
    images = torch.from_numpy(split[0])
    labels = torch.from_numpy(split[1].astype(np.int64))
    b = batch // mesh.data
    cols = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    out = {}

    def metrics(m):
        return float(m["loss"]), float(m["accuracy"])

    net = CNN(ModelConfig(logit_relu=False), dcfg)
    state = _port_state(net, ocfg, params)
    chunk = step_lib.make_train_chunk_resident(
        net, ocfg, images, labels, data_cfg=dcfg,
        index_stream=(seed, batch, k), mesh=mesh)
    runs = [metrics(chunk(state)[1]) for _ in range(len(host_idx))]
    out["stream"] = (runs, _final(state))
    stream_state = state

    net = CNN(ModelConfig(logit_relu=False), dcfg)
    state = _port_state(net, ocfg, params)
    chunk = step_lib.make_train_chunk_resident(
        net, ocfg, images, labels, data_cfg=dcfg, mesh=mesh)
    runs = []
    for idx in host_idx:
        local = (idx[:, cols] - mesh.data_rank) // mesh.data
        rows = torch.from_numpy(step_lib.global_rows(local, mesh))
        runs.append(metrics(chunk(state, rows)[1]))
    out["host_idx"] = (runs, _final(state))

    net = CNN(ModelConfig(logit_relu=False), dcfg)
    state = _port_state(net, ocfg, params)
    fed = step_lib.make_train_chunk(net, ocfg, data_cfg=dcfg, mesh=mesh)
    runs = [metrics(fed(state, images[idx[:, cols]],
                        labels[idx[:, cols]])[1]) for idx in host_idx]
    out["host_fed"] = (runs, _final(state))

    net = CNN(ModelConfig(logit_relu=False), dcfg)
    state = _port_state(net, ocfg, params)
    one = step_lib.make_train_step(net, ocfg, mesh)
    runs = []
    for idx in host_idx:
        for i in range(k):
            rows = idx[i, cols]
            _, m = one(state, device_preprocess(
                images[rows], dcfg, state.step, mesh.data_rank * b),
                labels[rows])
        runs.append(metrics(m))
    out["single"] = (runs, _final(state))

    t_images, t_labels = test_split
    ev, total = step_lib.make_eval_resident(
        net, t_images[mesh.data_rank::mesh.data],
        t_labels[mesh.data_rank::mesh.data], dcfg, torch.device("cpu"),
        batch_size=b, mesh=mesh, total_records=len(t_labels))
    out["eval"] = (int(ev(stream_state)), total)
    return out


def sp_chunks(rank, world, seq, model, optim, params, images, labels):
    """A ViT chunk of ``len(images)`` steps over a ``data x seq`` mesh on
    decoded images (global ``[K, B, H, W, C]``, this rank takes its data
    rank's columns), and the same steps one at a time, each from
    ``params``, for ``sp_mode`` ring and ulysses. Returns per mode the
    chunk's last (loss, accuracy) and final params, and the steps'."""
    from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                                  OptimConfig,
                                                  ParallelConfig)
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    mesh = mesh_lib.build_mesh(ParallelConfig(seq_axis=seq))
    ocfg = OptimConfig(**optim)
    dcfg = DataConfig(crop_height=images.shape[2],
                      crop_width=images.shape[3])
    b = images.shape[1] // mesh.data
    cols = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    ims = torch.from_numpy(images[:, cols])
    lbs = torch.from_numpy(labels[:, cols].astype(np.int64))
    out = {}
    for mode in ("ring", "ulysses"):
        mcfg = ModelConfig(**model, sp_mode=mode)
        net = get_model(mcfg.name)(mcfg, dcfg, mesh=mesh)
        state = _port_state(net, ocfg, params)
        _, m = step_lib.make_train_chunk(net, ocfg, mesh=mesh)(state, ims,
                                                               lbs)
        chunk = ((float(m["loss"]), float(m["accuracy"])), _final(state))
        net = get_model(mcfg.name)(mcfg, dcfg, mesh=mesh)
        state = _port_state(net, ocfg, params)
        one = step_lib.make_train_step(net, ocfg, mesh)
        for i in range(len(ims)):
            _, m = one(state, ims[i], lbs[i])
        out[mode] = (chunk, ((float(m["loss"]), float(m["accuracy"])),
                             _final(state)))
    return out


def cli_runs(rank, world, runs):
    """``cli.main.main`` once for each argv of ``runs``, in order, as this
    rank (each run joins its own rendezvous, named by its --worker_hosts,
    and leaves it); returns the exit codes."""
    import torch.distributed as dist

    from dml_cnn_cifar10_tpu_torch.cli.main import main
    dist.destroy_process_group()
    return [main(list(argv) + ["--task_index", str(rank)]) for argv in runs]


def cli_traced_runs(rank, world, runs):
    """``cli.main.main`` once for each argv of ``runs``, in order, as this
    rank, when the run's ``--worker_hosts`` names this rank (the others
    go on to the next run). Per run: the exit code, the console output,
    and for each train step the SHA-1 of the images this rank fed and the
    step's loss; ``None`` for a run this rank is not in."""
    import contextlib
    import hashlib
    import io

    import torch.distributed as dist

    from dml_cnn_cifar10_tpu_torch.cli.main import main
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
    dist.destroy_process_group()
    make = step_lib.make_train_step
    fed = []

    def traced(*args, **kwargs):
        fn = make(*args, **kwargs)

        def step(state, images, labels):
            state, m = fn(state, images, labels)
            fed.append((hashlib.sha1(images.detach().cpu().numpy()
                                     .tobytes()).hexdigest(),
                        float(m["loss"])))
            return state, m

        return step

    step_lib.make_train_step = traced
    out = []
    for argv in runs:
        hosts = argv[argv.index("--worker_hosts") + 1].split(",")
        if rank >= len(hosts):
            out.append(None)
            continue
        fed.clear()
        console = io.StringIO()
        with contextlib.redirect_stdout(console):
            rc = main(list(argv) + ["--task_index", str(rank)])
        out.append({"rc": rc, "stdout": console.getvalue(),
                    "fed": list(fed)})
    return out


def health_ranks(rank, world, params, images, labels, raw, raw_labels):
    """One eager train step with ``health_metrics`` on this data rank's
    rows of the global batch ``(images, labels)``, then one host-fed chunk
    of the global raw uint8 ``[K, B, H, W, C]`` chunk (this rank's
    columns, decoded with scale normalization and crop/flip), from
    ``params`` (JAX-layout numpy tree); returns each one's health
    scalars."""
    from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                                  OptimConfig,
                                                  ParallelConfig)
    from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    mesh = mesh_lib.build_mesh(ParallelConfig())
    ocfg = OptimConfig(learning_rate=0.01)
    out = []
    for chunked in (False, True):
        net = CNN(ModelConfig(logit_relu=False), DataConfig(), mesh=mesh)
        state = _port_state(net, ocfg, params)
        if chunked:
            fn = step_lib.make_train_chunk(
                net, ocfg, data_cfg=DataConfig(normalize="scale",
                                               random_crop=True,
                                               random_flip=True),
                mesh=mesh, health_metrics=True)
            b = raw.shape[1] // world
            cols = slice(rank * b, (rank + 1) * b)
            _, m = fn(state, torch.from_numpy(raw[:, cols]),
                      torch.from_numpy(raw_labels[:, cols].astype(np.int64)))
        else:
            fn = step_lib.make_train_step(net, ocfg, mesh,
                                          health_metrics=True)
            b = images.shape[0] // world
            rows = slice(rank * b, (rank + 1) * b)
            _, m = fn(state, torch.from_numpy(images[rows]),
                      torch.from_numpy(labels[rows].astype(np.int64)))
        out.append({k: float(v) for k, v in m.items()
                    if k.startswith("health_")})
    return out


def fit_ranks(rank, world, runs):
    """``Trainer.fit`` on the CLI's config of ``argvs[rank]`` for each
    ``argvs`` of ``runs``, in order, as this rank (each run on its own
    rendezvous, from its --worker_hosts); returns, for each run, the final
    step, whether it was preempted, the steps this rank's checkpoint
    manager saved at (rank 0 writes the files) and whether the final
    parameters are finite."""
    import torch.distributed as dist

    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer

    dist.destroy_process_group()
    saved = []
    save = ckpt_lib.CheckpointManager.maybe_save

    def spy(self, state, step, force=False, data_state=None):
        did = save(self, state, step, force=force, data_state=data_state)
        if did:
            saved.append(step)
        return did

    ckpt_lib.CheckpointManager.maybe_save = spy
    out = []
    for argvs in runs:
        saved.clear()
        cfg = config_from_args(build_parser().parse_args(
            list(argvs[rank]) + ["--task_index", str(rank)]))
        trainer = Trainer(cfg, task_index=rank)
        try:
            result = trainer.fit()
        finally:
            trainer.close()
            if dist.is_initialized():
                dist.destroy_process_group()
        out.append({"final_step": result.final_step,
                    "preempted": result.preempted, "saved": list(saved),
                    "finite": all(bool(torch.isfinite(p).all())
                                  for p in result.state.params.values())})
    return out


# ---------------------------------------------------------------------------
# Sharded state (ZeRO-1 / FSDP over the data ranks).
# ---------------------------------------------------------------------------


def sharded_state(rank, world, run, mesh):
    """``(net, optim cfg, state)`` of ``run`` (a dict: ``mode`` none |
    zero1 | fsdp, ``model``/``data``/``optim`` config kwargs, ``params``
    a JAX-layout numpy tree) over ``mesh``: the layout built as the
    Trainer builds it, the params (and the EMA, when kept) set to
    ``params`` on this rank's shards."""
    from dml_cnn_cifar10_tpu_torch import convert
    from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                                  OptimConfig,
                                                  ParallelConfig)
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
    from dml_cnn_cifar10_tpu_torch.parallel import zero

    mode = run["mode"]
    mcfg = ModelConfig(**run["model"])
    net = get_model(mcfg.name)(mcfg, DataConfig(**run.get("data", {})),
                               mesh=mesh)
    ocfg = OptimConfig(**run["optim"], optimizer_sharding=(
        "zero1" if mode == "zero1" else "none"))
    layout = zero.build_layout(net, mcfg.name, ocfg,
                               ParallelConfig(fsdp=mode == "fsdp"), mesh)
    state = step_lib.init_train_state(net, ocfg, torch.device("cpu"),
                                      torch.Generator().manual_seed(0),
                                      layout)
    entries = [("params", state.params)] + (
        [("ema", state.opt["ema"])] if "ema" in state.opt else [])
    with torch.no_grad():
        for key, dst in entries:
            for name, value in convert.params_from_jax(
                    run["params"]).items():
                if layout is not None and key in layout.keys \
                        and layout.is_split(name):
                    value = layout.shard_of(value, name)
                dst[name].copy_(value)
    return net, ocfg, state


def _entry_bytes(values) -> int:
    return sum(t.numel() * t.element_size() for t in values.values())


def sharded_runs(rank, world, runs):
    """Each run of ``runs`` (see :func:`sharded_state`; ``batches`` the
    GLOBAL ``(images, labels)`` of each step, this rank takes its data
    rank's rows; ``chunk`` runs them as one chunk instead; ``eval`` a
    global batch scored after training): returns per run the per-step
    metrics, the whole state tree (``state_to_tree``: gathered), this
    rank's bytes of params and of the moments, and the eval accuracy.
    Then the mesh's reduce-scatter and all-gather on a known input."""
    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    from dml_cnn_cifar10_tpu_torch.config import ParallelConfig
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    mesh = mesh_lib.build_mesh(ParallelConfig())
    out = {}
    for name, run in runs.items():
        net, ocfg, state = sharded_state(rank, world, run, mesh)
        b = run["batches"][0][0].shape[0] // mesh.data
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        ims = [torch.from_numpy(i[rows]) for i, _ in run["batches"]]
        lbs = [torch.from_numpy(l[rows].astype(np.int64))
               for _, l in run["batches"]]
        metrics = []
        if run.get("chunk"):
            chunk = step_lib.make_train_chunk(net, ocfg, mesh=mesh)
            _, m = chunk(state, torch.stack(ims), torch.stack(lbs))
            metrics.append({k: float(v) for k, v in m.items()})
        else:
            train = step_lib.make_train_step(net, ocfg, mesh,
                                             health_metrics=True)
            for im, lb in zip(ims, lbs):
                _, m = train(state, im, lb)
                metrics.append({k: float(v) for k, v in m.items()})
        res = {"metrics": metrics, "tree": ckpt_lib.state_to_tree(state),
               "param_bytes": _entry_bytes(state.params),
               "moment_bytes": sum(_entry_bytes(state.opt[k]) for k in
                                   ("momentum", "mu", "nu")
                                   if k in state.opt)}
        if "eval" in run:
            images, labels = run["eval"]
            res["eval"] = float(step_lib.make_eval_step(net, mesh)(
                state, torch.from_numpy(images[rows]),
                torch.from_numpy(labels[rows].astype(np.int64)))["accuracy"])
        out[name] = res
    send = torch.arange(world * 3, dtype=torch.float32) * (rank + 1)
    got = torch.empty(3)
    mesh.reduce_scatter_(got, send, "data")
    gathered = torch.empty(world * 3)
    mesh.all_gather_(gathered, got, "data")
    out["collectives"] = (got.numpy(), gathered.numpy())
    return out


def sharded_ckpt(rank, world, run, work, jax_dirs):
    """Checkpoints of a sharded state over 2 ranks: ``run`` (see
    :func:`sharded_state`, mode zero1) trains its ``batches``, then saves
    ``work/<fmt>`` in both codecs at step 1 (sharded with 2 shard-IO
    threads); each is restored into every layout (none, zero1, fsdp) and
    the whole trees returned; each of ``jax_dirs`` (JAX-written
    checkpoints) is restored into an fsdp state; then a corrupt newer
    shard falls back to the older checkpoint."""
    import os

    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    from dml_cnn_cifar10_tpu_torch.config import ParallelConfig
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    mesh = mesh_lib.build_mesh(ParallelConfig())
    net, ocfg, state = sharded_state(rank, world, run, mesh)
    b = run["batches"][0][0].shape[0] // mesh.data
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    train = step_lib.make_train_step(net, ocfg, mesh)
    for images, labels in run["batches"]:
        train(state, torch.from_numpy(images[rows]),
              torch.from_numpy(labels[rows].astype(np.int64)))
    events = []

    def on_event(kind, **fields):
        events.append((kind, fields["op"], fields["shard"]))

    saved = {"tree": ckpt_lib.state_to_tree(state)}
    for fmt in ("msgpack", "sharded"):
        ckpt_lib.CheckpointManager(
            os.path.join(work, fmt), 1, mesh=mesh, fmt=fmt,
            shard_io_threads=2, on_event=on_event).maybe_save(state, 1)
    saved["events"] = list(events)
    restored = {}
    for fmt in ("msgpack", "sharded"):
        for mode in ("none", "zero1", "fsdp"):
            _, _, fresh = sharded_state(rank, world, dict(run, mode=mode),
                                        mesh)
            ckpt_lib.restore_checkpoint(os.path.join(work, fmt), fresh,
                                        on_event=on_event)
            restored[f"{fmt}->{mode}"] = ckpt_lib.state_to_tree(fresh)
    for label, path in jax_dirs.items():
        _, _, fresh = sharded_state(rank, world, dict(run, mode="fsdp"),
                                    mesh)
        ckpt_lib.restore_checkpoint(path, fresh)
        restored[label] = ckpt_lib.state_to_tree(fresh)
    # A newer checkpoint whose shard is corrupt: the walk falls back.
    d = os.path.join(work, "fallback")
    for step in (1, 2):
        state.opt["step"].fill_(step)
        ckpt_lib.save_checkpoint(d, state, step, fmt="sharded", mesh=mesh)
    if rank == 0:
        top = os.path.join(d, "ckpt_2.sharded")
        shard = os.path.join(top, sorted(
            n for n in os.listdir(top)
            if n.startswith("shard_1_") and n.endswith(".msgpack"))[0])
        with open(shard, "r+b") as f:
            f.seek(os.path.getsize(shard) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
    mesh.barrier()
    _, _, fresh = sharded_state(rank, world, dict(run, mode="zero1"), mesh)
    fresh.opt["step"].fill_(7)
    ckpt_lib.restore_checkpoint(d, fresh)
    saved["fallback_step"] = int(fresh.step)
    saved["restored"] = restored
    saved["events_all"] = list(events)
    return saved


def peer_payloads(rank, world, runs, cluster_dir):
    """Peer replicas of sharded states: each run of ``runs`` (see
    :func:`sharded_state`; a mode zero1 or fsdp) trains its ``batches``,
    then every rank pushes its shard payload (``collect_local_shards``:
    its own shards with their index ranges) at step 1 into a
    ``PeerReplicaStore`` under ``cluster_dir/<run>`` and waits for the
    commit. Returns per run the whole state tree (``state_to_tree``:
    gathered) to hold the assembled replicas to."""
    import os

    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    from dml_cnn_cifar10_tpu_torch.ckpt import peerstore
    from dml_cnn_cifar10_tpu_torch.config import ParallelConfig
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    mesh = mesh_lib.build_mesh(ParallelConfig())
    out = {}
    for name, run in runs.items():
        net, ocfg, state = sharded_state(rank, world, run, mesh)
        b = run["batches"][0][0].shape[0] // mesh.data
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        train = step_lib.make_train_step(net, ocfg, mesh)
        for images, labels in run["batches"]:
            train(state, torch.from_numpy(images[rows]),
                  torch.from_numpy(labels[rows].astype(np.int64)))
        store = peerstore.PeerReplicaStore(
            os.path.join(cluster_dir, name), rank, list(range(world)))
        try:
            assert store.push_state_async(1, state, mesh.rank)
            store.flush()
            assert store.committed_steps(rank) == [1]
        finally:
            store.close()
        out[name] = ckpt_lib.state_to_tree(state)
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism (Megatron column/row layers over the model ranks).
# ---------------------------------------------------------------------------


def tp_state(run, mesh):
    """``(net, optim cfg, state)`` of ``run`` (a dict: ``mode`` none |
    zero1 | fsdp, ``model``/``data``/``optim`` config kwargs, ``params`` a
    JAX-layout numpy tree of the WHOLE parameters) over ``mesh``: the
    layout built as the Trainer builds it, the whole params (and the EMA,
    when kept) loaded through the checkpoint restore, which cuts each
    rank's slices and shards."""
    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                                  OptimConfig,
                                                  ParallelConfig)
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
    from dml_cnn_cifar10_tpu_torch.parallel import zero

    mode = run.get("mode", "none")
    mcfg = ModelConfig(**run["model"])
    net = get_model(mcfg.name)(mcfg, DataConfig(**run.get("data", {})),
                               mesh=mesh)
    ocfg = OptimConfig(**run["optim"], optimizer_sharding=(
        "zero1" if mode == "zero1" else "none"))
    layout = zero.build_layout(net, mcfg.name, ocfg, ParallelConfig(
        model_axis=mesh.model, fsdp=mode == "fsdp"), mesh)
    state = step_lib.init_train_state(net, ocfg, torch.device("cpu"),
                                      torch.Generator().manual_seed(0),
                                      layout)
    tree = ckpt_lib.state_to_tree(state)
    tree["params"] = run["params"]
    if "ema" in tree["opt"]:
        tree["opt"]["ema"] = run["params"]
    ckpt_lib.load_tree_into(state, tree)
    return net, ocfg, state


def _tp_train(run, mesh, net, ocfg, state):
    """The steps of ``run`` (``batches`` the GLOBAL ``(images, labels)``,
    this rank takes its data rank's rows; ``chunk`` runs them as one
    chunk), with the health scalars; returns the per-step metrics."""
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    b = run["batches"][0][0].shape[0] // mesh.data
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    ims = [torch.from_numpy(i[rows]) for i, _ in run["batches"]]
    lbs = [torch.from_numpy(l[rows].astype(np.int64))
           for _, l in run["batches"]]
    if run.get("chunk"):
        chunk = step_lib.make_train_chunk(net, ocfg, mesh=mesh,
                                          health_metrics=True)
        _, m = chunk(state, torch.stack(ims), torch.stack(lbs))
        return [{k: float(v) for k, v in m.items()}]
    train = step_lib.make_train_step(net, ocfg, mesh, health_metrics=True)
    out = []
    for im, lb in zip(ims, lbs):
        _, m = train(state, im, lb)
        out.append({k: float(v) for k, v in m.items()})
    return out


def tp_runs(rank, world, model_axis, runs, ckpt=None):
    """Each run of ``runs`` (see :func:`tp_state` and :func:`_tp_train`)
    on a ``data x model`` mesh of ``model_axis`` model ranks: per run the
    per-step metrics, the whole state tree (``state_to_tree``: gathered
    over the data and the model ranks), this rank's local parameters and
    their bytes, and the eval accuracy of ``eval`` (a global batch); the
    mesh's broadcast over ``model`` of the rank's number. Then,
    with ``ckpt`` (``work`` dir, ``run``, ``replicated`` a sharded
    checkpoint dir of whole params), the checkpoint cases: the run
    trained as TP+fsdp and as TP, each saved in msgpack and sharded; the
    TP+fsdp sharded save and the replicated one restored into a TP
    state, the TP+fsdp msgpack save into a TP+zero1 state."""
    import os

    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    from dml_cnn_cifar10_tpu_torch.config import ParallelConfig
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    mesh = mesh_lib.build_mesh(ParallelConfig(model_axis=model_axis))
    out = {"coords": (mesh.data_rank, mesh.model_rank)}
    for name, run in runs.items():
        net, ocfg, state = tp_state(run, mesh)
        res = {"metrics": _tp_train(run, mesh, net, ocfg, state),
               "tree": ckpt_lib.state_to_tree(state),
               "local": {k: v.detach().numpy().copy()
                         for k, v in state.params.items()},
               "param_bytes": _entry_bytes(state.params)}
        if "eval" in run:
            images, labels = run["eval"]
            b = images.shape[0] // mesh.data
            rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
            res["eval"] = float(step_lib.make_eval_step(net, mesh)(
                state, torch.from_numpy(images[rows]),
                torch.from_numpy(labels[rows].astype(np.int64)))["accuracy"])
        out[name] = res
    got = torch.full((3,), float(rank))
    mesh.broadcast_(got, "model")
    out["broadcast"] = got.numpy()
    if ckpt is None:
        return out
    work, run = ckpt["work"], ckpt["run"]
    saved = {}
    for mode in ("fsdp", "none"):
        net, ocfg, state = tp_state(dict(run, mode=mode), mesh)
        _tp_train(run, mesh, net, ocfg, state)
        saved[mode] = ckpt_lib.state_to_tree(state)
        for fmt in ("msgpack", "sharded"):
            ckpt_lib.CheckpointManager(
                os.path.join(work, f"{fmt}_{mode}"), 1, mesh=mesh,
                fmt=fmt).maybe_save(state, len(run["batches"]))
    restored = {}
    for label, path, mode in (
            ("fsdp->tp", "sharded_fsdp", "none"),
            ("replicated->tp", ckpt["replicated"], "none"),
            ("msgpack fsdp->zero1", "msgpack_fsdp", "zero1")):
        _, _, fresh = tp_state(dict(run, mode=mode), mesh)
        ckpt_lib.restore_checkpoint(os.path.join(work, path), fresh)
        restored[label] = ckpt_lib.state_to_tree(fresh)
    out["ckpt"] = {"saved": saved, "restored": restored}
    return out


# ---------------------------------------------------------------------------
# Mixture of experts: global routing over the data ranks, experts over the
# model ranks.
# ---------------------------------------------------------------------------


def _metrics(m):
    return {k: v.tolist() if v.dim() else float(v) for k, v in m.items()}


def moe_runs(rank, world, runs, ckpt=None):
    """Each run of ``runs`` (see :func:`tp_state`; ``model_axis`` its
    mesh's model ranks, 1 by default; ``batches`` the GLOBAL ``(images,
    labels)`` of each step, this rank takes its data rank's rows): per run
    the per-step metrics (the router stats with them), the whole state
    tree and this rank's local parameters' shapes. With ``ckpt`` (``run``
    a name, ``jax`` and ``out`` dirs) a fresh state of that run restores
    the JAX-written checkpoint under ``jax`` and saves it ``.sharded``
    under ``out``."""
    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    from dml_cnn_cifar10_tpu_torch.config import ParallelConfig
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    meshes, out = {}, {}
    for name, run in runs.items():
        m = run.get("model_axis", 1)
        if m not in meshes:
            meshes[m] = mesh_lib.build_mesh(ParallelConfig(model_axis=m))
        mesh = meshes[m]
        net, ocfg, state = tp_state(run, mesh)
        b = run["batches"][0][0].shape[0] // mesh.data
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        train = step_lib.make_train_step(net, ocfg, mesh)
        metrics = []
        for images, labels in run["batches"]:
            _, met = train(state, torch.from_numpy(images[rows]),
                           torch.from_numpy(labels[rows].astype(np.int64)))
            metrics.append(_metrics(met))
        out[name] = {"metrics": metrics,
                     "tree": ckpt_lib.state_to_tree(state),
                     "local": {k: tuple(v.shape)
                               for k, v in state.params.items()}}
        if ckpt is not None and name == ckpt["run"]:
            _, _, fresh = tp_state(run, mesh)
            ckpt_lib.restore_checkpoint(ckpt["jax"], fresh)
            ckpt_lib.save_checkpoint(ckpt["out"], fresh, int(fresh.step),
                                     fmt="sharded", mesh=mesh,
                                     shard_io_threads=1)
    return out


# ---------------------------------------------------------------------------
# Pipeline parallelism over the pipe ranks; the CNN's spatial split over the
# seq ranks.
# ---------------------------------------------------------------------------


def _toy_block(h, p):
    return torch.tanh(h @ p["w"] + p["b"])


def pipeline_cases(rank, world, cases):
    """Each case: ``(name, pipe, schedule, microbatches, x, stacked, vit)``
    with ``x`` the GLOBAL ``[B, S, D]`` input and ``stacked`` the whole
    ``[depth, ...]`` leaves (numpy); ``vit`` None runs the toy block
    ``tanh(h @ w + b)``, else a dict of ``ModelConfig`` kwargs whose ViT
    blocks run (``ViT._stage``). On a ``data x pipe`` mesh of ``pipe``
    stages this rank runs ``pipeline_blocks`` on its data rank's rows
    and its stage's rows, then the backward of ``sum(sin(out))``;
    returns ``{name: (out, dx, {leaf: stage gradient summed over the data
    ranks})}`` with the mesh's coordinates."""
    from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                                  ParallelConfig)
    from dml_cnn_cifar10_tpu_torch.models.vit import ViT
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import pipeline

    meshes, res = {}, {}
    for name, pipe, schedule, m, x, stacked, vit in cases:
        if pipe not in meshes:
            meshes[pipe] = mesh_lib.build_mesh(ParallelConfig(pipe_axis=pipe))
        mesh = meshes[pipe]
        def fn(h, rows):
            return pipeline.sequential_blocks(h, rows, _toy_block)

        if vit is not None:
            fn = ViT(ModelConfig(**vit), DataConfig(crop_height=32,
                                                    crop_width=32))._stage
        b = x.shape[0] // mesh.data
        xl = torch.tensor(x[mesh.data_rank * b:(mesh.data_rank + 1) * b],
                          requires_grad=True)
        n = next(iter(stacked.values())).shape[0] // pipe
        stage = {k: torch.tensor(v[mesh.pipe_rank * n:(mesh.pipe_rank + 1)
                                   * n], requires_grad=True)
                 for k, v in stacked.items()}
        out = pipeline.pipeline_blocks(xl, stage, fn, mesh,
                                       num_microbatches=m, schedule=schedule)
        torch.sin(out).sum().backward()
        grads = {k: mesh.all_reduce_(v.grad, "data").numpy()
                 for k, v in stage.items()}
        res[name] = (out.detach().numpy(), xl.grad.numpy(), grads)
    res["coords"] = {p: (mm.data_rank, mm.pipe_rank)
                     for p, mm in meshes.items()}
    return res


def axis_runs(rank, world, runs, ckpt=None, ops=None):
    """Each run of ``runs`` (see :func:`tp_state` and :func:`_tp_train`;
    ``pipe`` and ``seq`` its mesh's pipeline stages and seq ranks, 1 by
    default, the data ranks the rest): per run the per-step metrics, the
    whole state tree (gathered over the stages) and this rank's local
    parameter shapes. A run with ``resident`` (``(images, labels, idx)``:
    a uint8 split and ``[K, B]`` global rows) trains one chunk of its rows
    on the device-resident path and one on the host-fed raw path, each
    from the run's params, and returns both. With ``ckpt`` (``work`` dir,
    ``run`` a pipe-2 run, ``next`` its following batches, ``jax`` a JAX
    package ``.sharded`` save): the run trained and saved in both codecs,
    restored into a pipe-4 state that trains ``next``, and the JAX save
    restored into a pipe-2 state. With ``ops``, :func:`spatial_ops` of
    them first, under ``"ops"``."""
    import os

    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    from dml_cnn_cifar10_tpu_torch.config import DataConfig, ParallelConfig
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    out = {} if ops is None else {"ops": spatial_ops(rank, world, ops)}
    meshes = {}

    def mesh_of(run):
        key = (run.get("pipe", 1), run.get("seq", 1))
        if key not in meshes:
            meshes[key] = mesh_lib.build_mesh(
                ParallelConfig(pipe_axis=key[0], seq_axis=key[1]))
        return meshes[key]

    for name, run in runs.items():
        mesh = mesh_of(run)
        net, ocfg, state = tp_state(run, mesh)
        if "resident" in run:
            images, labels, idx = run["resident"]
            dcfg = DataConfig(normalize="scale")
            b = idx.shape[1] // mesh.data
            cols = idx[:, mesh.data_rank * b:(mesh.data_rank + 1) * b]
            resident = step_lib.make_train_chunk_resident(
                net, ocfg, torch.from_numpy(images),
                torch.from_numpy(labels.astype(np.int64)), data_cfg=dcfg,
                mesh=mesh)
            _, m_r = resident(state, torch.from_numpy(cols.astype(np.int64)))
            tree_r = ckpt_lib.state_to_tree(state)
            _, _, state = tp_state(run, mesh)
            hostfed = step_lib.make_train_chunk(net, ocfg, data_cfg=dcfg,
                                                mesh=mesh)
            _, m_h = hostfed(state, torch.from_numpy(images[cols]),
                             torch.from_numpy(labels[cols].astype(np.int64)))
            out[name] = {"resident": (float(m_r["loss"]), tree_r),
                         "hostfed": (float(m_h["loss"]),
                                     ckpt_lib.state_to_tree(state))}
            continue
        out[name] = {"metrics": _tp_train(run, mesh, net, ocfg, state),
                     "tree": ckpt_lib.state_to_tree(state),
                     "local": {k: tuple(v.shape)
                               for k, v in state.params.items()}}
    out["coords"] = {f"{k[0]}x{k[1]}": (m.data_rank, m.seq_rank, m.pipe_rank)
                     for k, m in meshes.items()}
    if ckpt is None:
        return out
    work, run = ckpt["work"], ckpt["run"]
    mesh = mesh_of(run)
    net, ocfg, state = tp_state(run, mesh)
    _tp_train(run, mesh, net, ocfg, state)
    steps = len(run["batches"])
    for fmt in ("msgpack", "sharded"):
        ckpt_lib.CheckpointManager(os.path.join(work, fmt), 1, mesh=mesh,
                                   fmt=fmt).maybe_save(state, steps)
    resumed = {}
    for fmt in ("msgpack", "sharded"):
        four = dict(run, pipe=4, batches=ckpt["next"])
        mesh4 = mesh_of(four)
        net4, ocfg4, fresh = tp_state(four, mesh4)
        ckpt_lib.restore_checkpoint(os.path.join(work, fmt), fresh)
        restored = ckpt_lib.state_to_tree(fresh)
        metrics = _tp_train(four, mesh4, net4, ocfg4, fresh)
        resumed[fmt] = {"restored": restored, "metrics": metrics,
                        "tree": ckpt_lib.state_to_tree(fresh),
                        "local": {k: tuple(v.shape)
                                  for k, v in fresh.params.items()}}
    _, _, fresh = tp_state(run, mesh)
    ckpt_lib.restore_checkpoint(ckpt["jax"], fresh)
    out["ckpt"] = {"saved": ckpt_lib.state_to_tree(state),
                   "resumed": resumed,
                   "jax_restored": ckpt_lib.state_to_tree(fresh)}
    return out


def spatial_ops(rank, world, cases):
    """Each case: ``(name, seq, kind, x, w, b)`` with ``x`` a whole NCHW
    map (the same on every data row), ``kind`` ``"conv"`` (``w``, ``b``
    its OIHW kernel and bias), ``"pool"`` or ``"trunk"`` (the CNN's
    conv-pool-conv-pool and the gather, ``w``/``b`` pairs of both
    convs). On a ``data x seq`` mesh this rank runs the split layer on
    its rows and the backward of ``sum(sin(y))`` of its output (the
    trunk's gathered map, whole on every rank); returns ``{name: (its
    rows of y or the whole map, its rows' input gradient, the kernels'
    gradients summed over the seq ranks)}`` and its coordinates."""
    from dml_cnn_cifar10_tpu_torch.config import ParallelConfig
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import spatial

    meshes, res = {}, {}
    for name, seq, kind, x, w, b in cases:
        if seq not in meshes:
            meshes[seq] = mesh_lib.build_mesh(ParallelConfig(seq_axis=seq))
        mesh = meshes[seq]
        split = spatial.Split.even(x.shape[2], seq)
        xl = torch.tensor(x[:, :, split.rows(mesh.seq_rank)],
                          requires_grad=True)
        ws = [torch.tensor(a, requires_grad=True) for a in (w or ())]
        bs = [torch.tensor(a, requires_grad=True) for a in (b or ())]
        if kind == "conv":
            y = spatial.conv2d(xl, ws[0], bs[0], mesh, split)
        elif kind == "pool":
            y = spatial.max_pool(xl, mesh, split)
        else:
            y, s = xl, split
            for i in range(2):
                y = torch.relu(spatial.conv2d(y, ws[i], bs[i], mesh, s))
                y, s = spatial.max_pool(y, mesh, s), s.pooled()
            y = spatial.gather(y, mesh, s)
        torch.sin(y).sum().backward()
        grads = [mesh.all_reduce_(t.grad.clone(), "seq").numpy()
                 for t in ws + bs]
        res[name] = (y.detach().numpy(), xl.grad.numpy(), grads)
    res["coords"] = {s: (m.data_rank, m.seq_rank) for s, m in meshes.items()}
    return res
