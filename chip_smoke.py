#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout:  ``python3 chip_smoke.py``

It needs one CUDA card, ``nvcc`` (PATH or ``$CUDA_HOME/bin``) and the
``dml_cnn_cifar10_tpu_torch`` package beside this file; without them it
exits non-zero and prints no result. It imports nothing of JAX. Phases, in
order; any failure ends the run with a non-zero exit:

1. device   ``torch.cuda`` must see a card; print ``nvidia-smi``'s name and
            power limit.
2. build    compile every ``csrc/*.cu`` afresh with ``nvcc`` (one process
            per source, all started together); print ptxas's report.
3. parity   K1 ``sgd_update_plain`` and K2 ``sgd_update_momentum`` against
            their plain PyTorch version on the CNN's 10 leaf shapes plus
            ragged and misaligned ones, for (mu, wd) in {0, 0.9} x {0, 5e-4}:
            max abs difference <= 5e-7.
4. timing   each kernel's optimizer step over the CNN's 10 leaves (CUDA
            events, and the kernels' own device time from torch.profiler),
            beside its plain version, ``torch.optim.SGD(fused=True).step()``
            on the same leaves (a yardstick the port never calls), and the
            bound: the bytes the update must move over the card's memory
            rate, or its f32 operations over the card's f32 rate.
5. train    the main path, ``cli.main.main``: the reference CNN at full
            width (batch 128, 24x24x3 crop, 1,068,298 params) for 500
            steps on 50,000 synthetic records. Loss finite, K1 launched
            once per leaf per step, final test accuracy far above chance.
6. resume   the same log dir to step 600: the global step continues at 500.
7. eval     ``--mode eval`` restores step 600 and prints the accuracy of the
            in-training eval at step 600.
8. momentum 50 steps with ``--momentum 0.9 --weight_decay 5e-4``: K2
            launched once per leaf per step.
9. profile  where a training step's time goes: the trainer's own rate, a
            step on a batch already on the card, the host's batch
            assembly, and the device's busy time by kernel.

The lines before the last are ``{"kernels": [...]}`` and the card's name
and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Scratch data and checkpoints go to ``.chip_smoke_work/`` (removed after a
passing run); the run's metrics JSONL files are copied to
``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".chip_smoke_work")
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")

STEPS, RESUME_STEPS, MOMENTUM_STEPS = 500, 600, 50
ATOL = 5e-7   # PARITY.md's pin for the update kernel vs its plain form
CASES = [(0.0, 0.0), (0.0, 5e-4), (0.9, 0.0), (0.9, 5e-4)]
# Published peaks (NVIDIA data sheets, SXM parts, full power limit):
# device-memory bytes/s and f32 operations/s outside the tensor cores.
PEAKS = {"H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}

EVAL_LINE = re.compile(r"^ --- Test Accuracy = (\d+\.\d\d)%\.$")
STEP_LINE = re.compile(r"^global_step (\d+), task:0_step (\d+), ")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for stream in self.streams:
            stream.write(s)
        return len(s)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def run_cli(args):
    """``cli.main.main(args)``, echoing its console; returns the lines."""
    from dml_cnn_cifar10_tpu_torch.cli.main import main
    buf = io.StringIO()
    print("$ python -m dml_cnn_cifar10_tpu_torch " + " ".join(args),
          flush=True)
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = main(args)
    check(rc == 0, f"cli returned {rc} for {args}")
    return buf.getvalue().splitlines()


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def cuda_ms(fn, reps=500, warmup=50) -> float:
    """Mean time of ``fn()`` by CUDA events over ``reps`` back-to-back
    calls (what a caller waits for, launches included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, needle: str, reps=100):
    """Device time per ``fn()`` of the kernels whose name holds
    ``needle``, from torch.profiler; None when the trace shows none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if needle in ev.key:
            total_us += (getattr(ev, "device_time_total", None)
                         or getattr(ev, "cuda_time_total", 0.0))
    return total_us / 1000.0 / reps if total_us > 0 else None


def profile_step(args, train_recs, card, steps=50) -> None:
    """Split the main path's step time: the trainer's windowed rate (its
    own JSONL, steps 200-500), one step with its batch already on the
    card (CUDA events), the host's batch assembly, and the device's busy
    time per step by kernel (torch.profiler). Written to
    ``chiprun_out/chip_smoke/profile.json``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.data import pipeline as pipe
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer

    cfg = config_from_args(build_parser().parse_args(args))
    trainer = Trainer(cfg)
    state = trainer.init_or_restore()
    it = pipe.input_pipeline(cfg.data, cfg.batch_size, train=True,
                             seed=cfg.seed)
    t0 = time.perf_counter()
    host = [next(it) for _ in range(steps)]
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    images, labels = pipe.to_device(host[0], torch.device("cuda"))
    step_ms = cuda_ms(lambda: trainer.train_step(state, images, labels),
                      reps=200, warmup=20)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step(state, images, labels)
        torch.cuda.synchronize()
    rows = sorted(((getattr(ev, "device_time_total", 0.0) / 1e3 / steps,
                    ev.count // steps, ev.key)
                   for ev in prof.key_averages()
                   if getattr(ev, "device_type", None) == DeviceType.CUDA),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    windows = [r["images_per_sec"] for r in train_recs
               if r["kind"] == "train" and r["step"] > 100]
    loop_ms = cfg.batch_size / (sum(windows) / len(windows)) * 1e3
    summary = {"card": card, "batch": cfg.batch_size,
               "loop_ms_per_step": loop_ms, "step_ms_on_device_batch": step_ms,
               "host_batch_ms": host_ms, "device_busy_ms_per_step": busy_ms,
               "device_busy_share": busy_ms / step_ms,
               "kernels": [{"ms_per_step": ms, "per_step": n, "name": name}
                           for ms, n, name in rows]}
    with open(os.path.join(OUT, "profile.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[profile] trainer loop {loop_ms:.4f} ms/step (windows after "
          f"step 100); a step on a batch already on the card "
          f"{step_ms:.4f} ms; host batch assembly {host_ms:.4f} ms; device "
          f"busy {busy_ms:.4f} ms/step ({100 * busy_ms / step_ms:.1f}% of "
          f"the step) in {sum(r[1] for r in rows)} kernels, on {card}")
    for ms, n, name in rows[:12]:
        print(f"[profile]   {ms:.5f} ms/step  x{n}  {name[:110]}")


def main() -> int:
    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
    from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
    from dml_cnn_cifar10_tpu_torch.ops import _build
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    bytes_per_s, ops_per_s = next(
        (v for k, v in PEAKS.items() if k in kind), PEAKS["H100"])
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; peaks used for bounds: "
          f"{bytes_per_s / 1e12} TB/s, {ops_per_s / 1e12} f32 TFLOP/s",
          flush=True)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 2. build --------------------------------------------------------
    if _build.BUILD_DIR.exists():
        shutil.rmtree(_build.BUILD_DIR)
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    check(set(logs) == set(_build.sources()), f"built {sorted(logs)}")
    for name, log in logs.items():
        print(f"[build] {name}.cu:\n{log.strip()}")
    print(f"[build] {len(logs)} source(s) in {build_s:.2f} s", flush=True)

    # ---- 3. parity -------------------------------------------------------
    model = CNN(ModelConfig(logit_relu=False), DataConfig())
    leaf_shapes = [tuple(p.shape) for p in model.parameters()]
    n_leaves = len(leaf_shapes)
    n_params = sum(math.prod(s) for s in leaf_shapes)
    check(n_leaves == 10 and n_params == 1_068_298,
          f"CNN has {n_leaves} leaves / {n_params} params")
    gen = torch.Generator(device=dev).manual_seed(0)
    lr = torch.tensor(0.02, device=dev)
    worst = {"sgd_update_plain": 0.0, "sgd_update_momentum": 0.0}

    def leaf(shape, offset=0):
        n = math.prod(shape)
        t = torch.randn(n + offset, device=dev, generator=gen)
        return t[offset:].view(shape)   # offset 1: not 16-byte aligned

    for mu, wd in CASES:
        for shape, offset in ([(s, 0) for s in leaf_shapes]
                              + [((37,), 0), ((130, 7), 0), ((130, 7), 1),
                                 ((2304, 384), 3)]):
            p, g = leaf(shape, offset), leaf(shape, offset)
            m = leaf(shape, offset) if mu else None
            want_p, want_m = fused.fused_sgd_update_plain(p, g, m, lr, mu,
                                                          wd)
            params, grads = {"x": p.clone()}, {"x": g.clone()}
            mom = {"x": m.clone()} if mu else None
            if offset:   # keep the misalignment through the clone
                params["x"] = leaf(shape, offset).copy_(p)
                if mu:
                    mom["x"] = leaf(shape, offset).copy_(m)
            fused.fused_sgd_update(params, grads, mom, lr, mu, wd)
            torch.cuda.synchronize()
            diff = (params["x"] - want_p).abs().max().item()
            if mu:
                diff = max(diff, (mom["x"] - want_m).abs().max().item())
            name = "sgd_update_momentum" if mu else "sgd_update_plain"
            worst[name] = max(worst[name], diff)
            check(diff <= ATOL, f"{name} {shape}+{offset} mu={mu} wd={wd}: "
                                f"max abs diff {diff} > {ATOL}")
    print(f"[parity] max abs diff vs plain: {worst}", flush=True)
    # On the card the wrapper launches or raises: no quiet fallback.
    for what, bad in (
            ("a non-contiguous leaf", ({"x": leaf((8, 8)).t()},
                                       {"x": leaf((8, 8))}, None, lr)),
            ("an lr on the host", ({"x": leaf((8,))}, {"x": leaf((8,))},
                                   None, lr.cpu()))):
        try:
            fused.fused_sgd_update(*bad, 0.0, 0.0)
        except ValueError:
            continue
        fail(f"fused_sgd_update accepted {what}")

    # ---- 4. timing -------------------------------------------------------
    def cnn_leaves():
        return {f"l{i}": torch.randn(s, device=dev, generator=gen)
                for i, s in enumerate(leaf_shapes)}

    timing = {}
    for name, mu, wd, needle in (
            ("sgd_update_plain", 0.0, 0.0, "sgd_plain_kernel"),
            ("sgd_update_momentum", 0.9, 5e-4, "sgd_momentum_kernel")):
        params, grads = cnn_leaves(), cnn_leaves()
        mom = cnn_leaves() if mu else None

        def kernel_step():
            fused.fused_sgd_update(params, grads, mom, lr, mu, wd)

        def plain_step():
            for k in params:
                fused.fused_sgd_update_plain(
                    params[k], grads[k], mom[k] if mom else None, lr, mu, wd)

        lib_params = [torch.nn.Parameter(t.clone()) for t in params.values()]
        for lp, g in zip(lib_params, grads.values()):
            lp.grad = g.clone()
        lib = torch.optim.SGD(lib_params, lr=0.02, momentum=mu,
                              weight_decay=wd, fused=True)
        ms = cuda_ms(kernel_step)
        dms = device_ms(kernel_step, needle)
        plain_ms = cuda_ms(plain_step)
        library_ms = cuda_ms(lib.step)
        per_param_bytes, per_param_ops = (20, 4) if mu else (12, 2)
        if wd:
            per_param_ops += 2
        need_bytes = per_param_bytes * n_params + 4      # + the lr scalar
        need_ops = per_param_ops * n_params
        by_bytes = need_bytes / bytes_per_s * 1e3
        by_ops = need_ops / ops_per_s * 1e3
        timing[name] = dict(
            ms=ms, device_ms=dms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            bytes=need_bytes, mu=mu, wd=wd)
        print(f"[timing] {name} (mu={mu}, wd={wd}, {n_leaves} leaves): "
              f"kernel {ms:.5f} ms/step (device {dms} ms), plain "
              f"{plain_ms:.5f} ms, torch.optim.SGD(fused=True) "
              f"{library_ms:.5f} ms, bound {timing[name]['bound_ms']:.5f} ms "
              f"({timing[name]['bound_by']}) on {card}", flush=True)

    # ---- 5. train: the main path ----------------------------------------
    if os.path.isdir(WORK):
        shutil.rmtree(WORK)
    os.makedirs(OUT, exist_ok=True)
    data_dir = os.path.join(WORK, "data")
    log_dir = os.path.join(WORK, "logs")
    base = ["--dataset", "synthetic", "--data_dir", data_dir,
            "--synthetic_train_records", "50000", "--fidelity", "fixed",
            "--learning_rate", "0.02", "--batch_size", "128",
            "--output_every", "100", "--checkpoint_every", "250"]
    train_jsonl = os.path.join(WORK, "train.jsonl")
    fused.reset_launches()
    t0 = time.perf_counter()
    lines = run_cli(base + ["--log_dir", log_dir, "--total_steps",
                            str(STEPS), "--eval_every", "250",
                            "--metrics_jsonl", train_jsonl])
    wall_s = time.perf_counter() - t0
    launches = dict(fused.LAUNCHES)
    recs = records(train_jsonl)
    train_recs = [r for r in recs if r["kind"] == "train"]
    check(len(train_recs) == STEPS // 100, f"{len(train_recs)} train records")
    check(all(r["loss"] is not None and math.isfinite(r["loss"])
              for r in train_recs), "non-finite training loss")
    check(launches["sgd_update_plain"] == STEPS * n_leaves,
          f"K1 launched {launches['sgd_update_plain']} times, want "
          f"{STEPS} steps x {n_leaves} leaves")
    check(launches["sgd_update_momentum"] == 0,
          f"K2 launched {launches['sgd_update_momentum']} times in a "
          "momentum-free run")
    accs = [float(m[1]) for m in map(EVAL_LINE.match, lines) if m]
    check(len(accs) == 2 and accs[-1] > 50.0,
          f"test accuracies {accs} (chance is 10%)")
    done = next(r for r in recs if r["kind"] == "done")
    ips = done["images_per_sec"]
    train_k1 = launches["sgd_update_plain"]
    print(f"[train] {STEPS} steps, loss {train_recs[0]['loss']:.4f} -> "
          f"{train_recs[-1]['loss']:.4f}, test accuracy {accs[-1]:.2f}%, "
          f"{ips / 128:.2f} steps/s = {ips:.1f} images/s (after the first "
          f"step; evals and checkpoints included), {wall_s:.1f} s wall "
          f"with data generation, on {card}", flush=True)

    # ---- 6. resume -------------------------------------------------------
    fused.reset_launches()
    resume_jsonl = os.path.join(WORK, "resume.jsonl")
    lines = run_cli(base + ["--log_dir", log_dir, "--total_steps",
                            str(RESUME_STEPS), "--eval_every", "100",
                            "--metrics_jsonl", resume_jsonl])
    steps = [int(m[1]) for m in map(STEP_LINE.match, lines) if m]
    check(steps == [RESUME_STEPS], f"resumed run printed steps {steps}")
    check(fused.LAUNCHES["sgd_update_plain"]
          == (RESUME_STEPS - STEPS) * n_leaves,
          f"resume ran {fused.LAUNCHES['sgd_update_plain'] // n_leaves} "
          f"steps, want {RESUME_STEPS - STEPS} (from step {STEPS})")
    resumed_acc = [m[1] for m in map(EVAL_LINE.match, lines) if m]
    check(len(resumed_acc) == 1, f"resume evals {resumed_acc}")
    print(f"[resume] continued {STEPS} -> {RESUME_STEPS}", flush=True)

    # ---- 7. eval mode ----------------------------------------------------
    lines = run_cli(base + ["--log_dir", log_dir, "--mode", "eval"])
    eval_acc = [m[1] for m in map(EVAL_LINE.match, lines) if m]
    check(eval_acc == resumed_acc,
          f"--mode eval printed {eval_acc}, training printed {resumed_acc}")
    check(any(f"eval at step {RESUME_STEPS}" in l for l in lines),
          "eval mode did not restore the last checkpoint")
    print(f"[eval] restored step {RESUME_STEPS}: {eval_acc[0]}% (matches)",
          flush=True)

    # ---- 8. momentum -----------------------------------------------------
    fused.reset_launches()
    mom_jsonl = os.path.join(WORK, "momentum.jsonl")
    run_cli(base + ["--log_dir", os.path.join(WORK, "logs_momentum"),
                    "--total_steps", str(MOMENTUM_STEPS), "--output_every",
                    "25", "--eval_every", "50", "--momentum", "0.9",
                    "--weight_decay", "5e-4", "--metrics_jsonl", mom_jsonl])
    momentum_k2 = fused.LAUNCHES["sgd_update_momentum"]
    check(momentum_k2 == MOMENTUM_STEPS * n_leaves,
          f"K2 launched {momentum_k2} times, want {MOMENTUM_STEPS} x "
          f"{n_leaves}")
    check(fused.LAUNCHES["sgd_update_plain"] == 0, "K1 ran with momentum")
    check(all(r["loss"] is not None and math.isfinite(r["loss"])
              for r in records(mom_jsonl) if r["kind"] == "train"),
          "non-finite momentum-run loss")
    print(f"[momentum] {MOMENTUM_STEPS} steps, K2 launches {momentum_k2}",
          flush=True)

    # ---- 9. where a training step's time goes ---------------------------
    profile_step(base + ["--log_dir", os.path.join(WORK, "logs_profile")],
                 records(train_jsonl), card)

    for path in (train_jsonl, resume_jsonl, mom_jsonl):
        shutil.copy(path, OUT)
    shutil.rmtree(WORK)

    kernels = []
    for name, kid, line, launches in (
            ("sgd_update_plain", "K1", 83, train_k1),
            ("sgd_update_momentum", "K2", 70, momentum_k2)):
        t = timing[name]
        kernels.append({
            "name": name, "kernel": kid, "route": "cuda",
            "source": "dml_cnn_cifar10_tpu_torch/csrc/sgd_update.cu",
            "replaces": f"dml_cnn_cifar10_tpu/ops/optimizer.py:{line}",
            "launches": launches,
            "max_abs_err": worst[name], "max_abs_diff": worst[name],
            "ms": t["ms"], "kernel_ms": t["ms"],
            "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": "torch.optim.SGD(fused=True).step",
            "work": f"one optimizer step over the CNN's {n_leaves} f32 "
                    f"leaves ({n_params} params), mu={t['mu']}, "
                    f"wd={t['wd']}; bound from {t['bytes']} bytes",
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
