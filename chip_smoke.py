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
            per source, all started together: ``sgd_update.cu`` and
            ``flash_attention.cu``); print ptxas's report.
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
10. flash parity  K3 ``flash_fwd``, K4 ``flash_fwd_lse``, K6
            ``flash_bwd_dq`` and K7 ``flash_bwd_dkv`` against their plain
            versions on the card, in the working dtype: the ViT's
            [2, 257, 3, 64] in f32, bf16 and as strided views of one fused
            qkv; ragged S=300; causal; window 100; segment ids; kv_start
            (K4, K6, K7); dead rows (exactly 0); head dims 32 and 128;
            and the main paths' own shapes, [128, 257, 3, 64] f32 and
            [2, 8100, 3, 64] bf16, as views of a fused qkv. Tolerances: the JAX package's pins in
            f32 (out 5e-6, lse 1e-5, grads 5e-5); in bf16 lse keeps
            1e-5 and out and grads 1e-2 x max|plain| (one bf16 ulp; at most
            0.05). A CUDA input the kernels cannot take must raise.
11. flash timing  each flash kernel at [128, 257, 3, 64] f32 and
            [2, 8100, 3, 64] bf16: CUDA events, device time, the plain
            version, ``F.scaled_dot_product_attention`` (a yardstick the
            port never calls) and the bound.
12. vit train  the main path with ``--model vit_tiny``: ViT-Ti at full
            width (dim 192, depth 12, 3 heads, 64x64 crop = 257 tokens,
            5,399,626 f32 params), AdamW + cosine, batch 128, 200 steps on
            10,000 synthetic records. Loss finite and falling; K4 = K6 =
            K7 = 200 x 12 launches, K3 = 12 per forward-only batch, K1 =
            K2 = 0.
13. vit resume  to step 300 (the AdamW moments come back from the
            checkpoint), then ``--mode eval`` prints the same accuracy.
14. long context  the 8,100-token recipe (368/360 images, mean pool,
            remat, bf16, batch 2) for 10 steps: finite loss, K4 = 240
            (remat recomputes each block), K6 = K7 = 120, device memory
            below one dense score matrix.
15. vit profile  a main-path and a long-context step's device time split
            between the flash kernels, the GEMMs and the rest.

The lines before the last are ``{"kernels": [...]}`` and the card's name
and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Scratch data and checkpoints go to ``.chip_smoke_work/`` (removed after a
passing run); the run's metrics JSONL files, the profiles and ``vit.json``
(the ViT phases' numbers) are written to the output directory ``OUT``.
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
VIT_STEPS, VIT_RESUME_STEPS, LONG_STEPS = 200, 300, 10
ATOL = 5e-7   # PARITY.md's pin for the update kernel vs its plain form
CASES = [(0.0, 0.0), (0.0, 5e-4), (0.9, 0.0), (0.9, 5e-4)]
# Published peaks (NVIDIA data sheets, SXM parts, full power limit):
# device-memory bytes/s and f32 operations/s outside the tensor cores.
PEAKS = {"H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}
# bf16 operations/s on the tensor cores (dense), the bf16 kernels' bound.
BF16_PEAK = 989e12

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
    ``needle``, from torch.profiler; None when the trace shows none. The
    trace can miss one kernel event of a profiling run (seen on the card:
    one of two), so the time is the mean per traced kernel times the
    kernels per call, not the sum over ``reps``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if needle in ev.key:
            total_us += (getattr(ev, "device_time_total", None)
                         or getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    if total_us <= 0 or count == 0:
        return None
    per_call = max(1, round(count / reps))
    return total_us / count * per_call / 1000.0


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


# ---- the flash-attention kernels (K3, K4, K6, K7) -----------------------

# Pins of the JAX package's flash tests (tests/test_flash_backward.py) in
# f32. With bf16 inputs, lse is still an f32 result of f32 arithmetic on
# the same values, so it keeps the f32 pin; out and the gradients are
# rounded once to bf16 from f32 on both sides, so they may differ by one
# bf16 ulp (at most 2^-7 of the tensor's largest magnitude): they are held
# to 1e-2 x max|plain| per tensor, and never more than the JAX package's
# 0.05.
FLASH_TOL = {"out": 5e-6, "lse": 1e-5, "grad": 5e-5}
BF16_REL, BF16_CAP = 1e-2, 0.05


def flash_tol(kind: str, dtype, ref: torch.Tensor) -> float:
    """The gate for one output tensor against its plain version ``ref``."""
    if dtype == torch.float32 or kind == "lse":
        return FLASH_TOL[kind]
    return min(BF16_CAP, BF16_REL * ref.float().abs().max().item())


# name, (B, Sq, Skv, H, D), dtype, mask; "strided" feeds q, k, v as the
# ViT does (views of one fused [B, S, H, 3, D] qkv tensor). The first two
# are the shapes the main paths give the kernels: the ViT's attention at
# batch 128 (f32) and the long-context recipe's (8,100 tokens, bf16).
FLASH_CASES = [
    ("vit main path", (128, 257, 257, 3, 64), torch.float32,
     {"strided": True}),
    ("long context", (2, 8100, 8100, 3, 64), torch.bfloat16,
     {"strided": True}),
    ("vit f32", (2, 257, 257, 3, 64), torch.float32, {}),
    ("vit bf16", (2, 257, 257, 3, 64), torch.bfloat16, {}),
    ("strided qkv", (2, 257, 257, 3, 64), torch.float32, {"strided": True}),
    ("ragged 300", (2, 300, 300, 3, 64), torch.float32, {}),
    ("causal", (2, 257, 257, 3, 64), torch.float32, {"causal": True}),
    ("window 100", (2, 300, 300, 3, 64), torch.float32, {"window": 100}),
    ("segments", (2, 300, 300, 3, 64), torch.float32, {"segments": True}),
    ("kv_start", (2, 300, 200, 3, 64), torch.float32,
     {"kv_start": 100, "causal": True, "window": 150}),
    ("dead rows", (1, 512, 128, 1, 64), torch.float32, {"window": 64}),
    ("head dim 32", (2, 257, 257, 3, 32), torch.float32, {}),
    ("head dim 128", (2, 257, 257, 3, 128), torch.float32, {"causal": True}),
]
FLASH_KERNELS = ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq",
                 "flash_bwd_dkv")


def _segment_ids(b, s, gen, dev):
    """Packed-sequence ids: each row cut into a few segments."""
    cuts = torch.rand(b, s, device=dev, generator=gen) < 4.0 / s
    cuts[:, 0] = False
    return torch.cumsum(cuts.to(torch.int32), dim=1).to(torch.int32)


def flash_parity(dev) -> dict:
    """Hold K3, K4, K6 and K7 against their plain versions on the card, in
    the working dtype, case by case; dead rows must be exactly 0. Returns
    the worst max abs difference per kernel and dtype."""
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {(k, dt): 0.0 for k in FLASH_KERNELS
             for dt in ("float32", "bfloat16")}
    for name, (b, sq, skv, h, d), dtype, mask in FLASH_CASES:
        kw = {k: v for k, v in mask.items() if k not in ("strided",
                                                         "segments")}
        if mask.get("strided"):
            qkv = torch.randn(b, sq, h, 3, d, device=dev,
                              generator=gen).to(dtype)
            q, k, v = qkv.unbind(3)
            check(q.stride()[1] == h * 3 * d,
                  "the strided case lost the fused qkv layout")
        else:
            q = torch.randn(b, sq, h, d, device=dev, generator=gen).to(dtype)
            k, v = (torch.randn(b, skv, h, d, device=dev, generator=gen)
                    .to(dtype) for _ in range(2))
        if mask.get("segments"):
            kw["segment_ids"] = _segment_ids(b, sq, gen, dev)
        do = torch.randn(b, sq, h, d, device=dev, generator=gen).to(dtype)
        with torch.no_grad():
            want, want_lse = fa.flash_attention_plain(q, k, v, **kw)
            dead = want_lse >= 1e29
            outs = {}
            if "kv_start" not in kw:
                outs["flash_fwd"] = fa.flash_attention(q, k, v, **kw)
            outs["flash_fwd_lse"], lse = fa.flash_attention_fwd_lse(
                q, k, v, **kw)
            delta = fa.attention_delta(want, do)
            want_g = fa.flash_attention_bwd_plain(q, k, v, do, want_lse,
                                                  delta, **kw)
            got_g = fa.flash_attention_bwd(q, k, v, do, want_lse, delta,
                                           **kw)
        torch.cuda.synchronize()
        diffs = {}
        for kname, out in outs.items():
            check(out.dtype == dtype and out.shape == want.shape,
                  f"{name}: {kname} gave {out.dtype} {tuple(out.shape)}")
            check(bool(torch.all(out[dead] == 0)),
                  f"{name}: {kname} dead rows are not exactly 0")
            diffs[kname] = (out.float() - want.float()).abs().max().item()
            tol = flash_tol("out", dtype, want)
            check(diffs[kname] <= tol,
                  f"{name}: {kname} out max abs diff {diffs[kname]} > {tol}")
        check(torch.equal(lse >= 1e29, dead) and
              bool(torch.all(lse[dead] == 1e30)),
              f"{name}: K4 dead-row lse differs from the plain version")
        lse_diff = (lse[~dead] - want_lse[~dead]).abs().max().item() \
            if bool((~dead).any()) else 0.0
        check(lse_diff <= FLASH_TOL["lse"],
              f"{name}: K4 lse max abs diff {lse_diff} > {FLASH_TOL['lse']}")
        diffs["flash_fwd_lse"] = max(diffs["flash_fwd_lse"], lse_diff)
        gdiff = [(g.float() - w.float()).abs().max().item()
                 for g, w in zip(got_g, want_g)]
        for g, w in zip(got_g, want_g):
            check(g.dtype == w.dtype == dtype, f"{name}: grad dtype {g.dtype}")
        check(bool(torch.all(got_g[0][dead] == 0)),
              f"{name}: K6 dQ of dead rows is not exactly 0")
        diffs["flash_bwd_dq"], diffs["flash_bwd_dkv"] = gdiff[0], max(gdiff[1:])
        gtol = [flash_tol("grad", dtype, w) for w in want_g]
        check(all(g <= t for g, t in zip(gdiff, gtol)),
              f"{name}: grads max abs diff {gdiff} > {gtol}")
        dt_name = "float32" if dtype == torch.float32 else "bfloat16"
        for kname, dval in diffs.items():
            worst[(kname, dt_name)] = max(worst[(kname, dt_name)], dval)
        scale_ref = max(w.float().abs().max().item() for w in want_g)
        print(f"[flash parity] {name:13s} {dt_name} {(b, sq, skv, h, d)} "
              f"{mask}: max abs diff "
              + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
              + f" (lse {lse_diff:.3g}; |out| up to "
              f"{want.float().abs().max().item():.3g}, |grad| up to "
              f"{scale_ref:.3g}; {int(dead.sum())} dead rows)", flush=True)
    # On the card the wrappers launch or raise: no quiet fallback.
    q = torch.randn(2, 128, 3, 64, device=dev, generator=gen)
    for what, args in (
            ("float16 inputs", (q.half(), q.half(), q.half())),
            ("head dim 48", (q[..., :48],) * 3),
            ("a non-contiguous head dim",
             (torch.randn(2, 128, 3, 128, device=dev)[..., ::2],) * 3),
            ("a key on the host", (q, q.cpu(), q))):
        try:
            with torch.no_grad():
                fa.flash_attention(*args)
        except ValueError:
            continue
        fail(f"flash_attention accepted {what}")
    return worst


# Shapes of the flash timing: the ViT main path's attention (batch 128,
# 257 tokens, 3 heads of 64, f32) and the long-context recipe's (8,100
# tokens, bf16) at batch 2.
FLASH_TIMING = [("vit", (128, 257, 3, 64), torch.float32),
                ("long", (2, 8100, 3, 64), torch.bfloat16)]
FLASH_NEEDLES = {"flash_fwd": "flash_out_kernel",
                 "flash_fwd_lse": "flash_lse_kernel",
                 "flash_bwd_dq": "flash_dq_kernel",
                 "flash_bwd_dkv": "flash_dkv_kernel"}
# Matrix-product FLOPs per (B·H·Sq·Skv·D): QKᵀ and PV forward; S, dP, dQ
# for K6; S, dP, dV, dK for K7.
FLASH_FLOPS = {"flash_fwd": 4, "flash_fwd_lse": 4, "flash_bwd_dq": 6,
               "flash_bwd_dkv": 8}


def timed_ms(fn, min_ms=300.0):
    """``cuda_ms`` over enough back-to-back calls to fill ``min_ms`` of
    device time after a warm-up of a quarter of that (short runs catch the
    card before its clocks settle). Returns ``(ms, reps)``."""
    one = cuda_ms(fn, reps=1, warmup=1)
    reps = max(3, min(500, math.ceil(min_ms / max(one, 1e-3))))
    return cuda_ms(fn, reps=reps, warmup=max(1, reps // 4)), reps


def flash_timing(dev, card, bytes_per_s, f32_ops) -> dict:
    """Each flash kernel at the main path's and the long shape: CUDA-event
    ms (launch included), the profiler's device ms, the plain version's
    ms, ``F.scaled_dot_product_attention``'s forward (for K3/K4) and its
    autograd backward (for K6+K7 together) as a yardstick the port never
    calls, and the bound: matrix-product FLOPs over the dtype's peak (f32
    on the CUDA cores, bf16 on the tensor cores) or the bytes each input
    and output needs once over the memory rate, whichever is larger."""
    import torch.nn.functional as F

    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(2)
    res = {}
    for label, (b, s, h, d), dtype in FLASH_TIMING:
        q, k, v, do = (torch.randn(b, s, h, d, device=dev, generator=gen)
                       .to(dtype) for _ in range(4))
        with torch.no_grad():
            out, lse = fa.flash_attention_fwd_lse(q, k, v)
            delta = fa.attention_delta(out, do)
        bwd = (q, k, v, do, lse, delta, d ** -0.5, False, None, None, 0,
               None, None)
        fns = {"flash_fwd": lambda: fa.flash_attention(q, k, v),
               "flash_fwd_lse": lambda: fa.flash_attention_fwd_lse(q, k, v),
               "flash_bwd_dq": lambda: fa._dq_launch(*bwd),
               "flash_bwd_dkv": lambda: fa._dkv_launch(*bwd)}
        plain_fwd, _ = timed_ms(lambda: fa.flash_attention_plain(q, k, v))
        plain_bwd, _ = timed_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, do, lse, delta))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_fwd, _ = timed_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt))
        qg, kg, vg = (t.detach().clone().requires_grad_()
                      for t in (qt, kt, vt))
        og = F.scaled_dot_product_attention(qg, kg, vg)
        dog = do.transpose(1, 2)
        lib_bwd, _ = timed_ms(lambda: torch.autograd.grad(
            og, (qg, kg, vg), dog, retain_graph=True))
        del og, qg, kg, vg
        elem, n, rows = q.element_size(), b * s * h * d, b * s * h
        nbytes = {"flash_fwd": 4 * n * elem,
                  "flash_fwd_lse": 4 * n * elem + 4 * rows,
                  "flash_bwd_dq": 5 * n * elem + 8 * rows,
                  "flash_bwd_dkv": 6 * n * elem + 8 * rows}
        peak = f32_ops if dtype == torch.float32 else BF16_PEAK
        for kname, fn in fns.items():
            ms, reps = timed_ms(fn)
            dms = device_ms(fn, FLASH_NEEDLES[kname], reps=min(reps, 50))
            flops = FLASH_FLOPS[kname] * b * h * s * s * d
            by_ops = flops / peak * 1e3
            by_bytes = nbytes[kname] / bytes_per_s * 1e3
            fwd = kname.startswith("flash_fwd")
            res[(kname, label)] = dict(
                shape=[b, s, h, d], dtype=str(dtype).replace("torch.", ""),
                ms=ms, device_ms=dms, plain_ms=plain_fwd if fwd else plain_bwd,
                library_ms=lib_fwd if fwd else lib_bwd,
                library=("F.scaled_dot_product_attention forward" if fwd else
                         "F.scaled_dot_product_attention backward (dQ, dK "
                         "and dV together)"),
                bound_ms=max(by_ops, by_bytes),
                bound_by="operations" if by_ops >= by_bytes else "bytes",
                flops=flops, bytes=nbytes[kname])
            r = res[(kname, label)]
            print(f"[flash timing] {kname} {label} {[b, s, h, d]} "
                  f"{r['dtype']}: kernel {ms:.5f} ms (device {dms} ms), "
                  f"plain {r['plain_ms']:.5f} ms, library "
                  f"{r['library_ms']:.5f} ms, bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']}; {flops / ms / 1e9:.1f} TFLOP/s "
                  f"achieved) on {card}", flush=True)
        del q, k, v, do, out, lse, delta
    return res


_GEMM = re.compile(r"gemm|xmma|cutlass|cublas", re.I)


def _device_rows(prof, steps):
    from torch.autograd import DeviceType
    return sorted(((getattr(ev, "device_time_total", 0.0) / 1e3 / steps,
                    ev.count // steps, ev.key)
                   for ev in prof.key_averages()
                   if getattr(ev, "device_type", None) == DeviceType.CUDA),
                  reverse=True)


def profile_vit(args, label, card, steps) -> dict:
    """Where one ViT training step's time goes: the step on a batch
    already on the card (CUDA events) and the device time per step split
    between the four flash kernels, the GEMMs and the rest
    (torch.profiler)."""
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
                      reps=steps, warmup=2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step(state, images, labels)
        torch.cuda.synchronize()
    rows = _device_rows(prof, steps)
    groups = {"flash kernels (K4, K6, K7)": 0.0, "GEMMs (cuBLAS)": 0.0,
              "rest": 0.0}
    for ms, _, name in rows:
        if any(n in name for n in FLASH_NEEDLES.values()):
            groups["flash kernels (K4, K6, K7)"] += ms
        elif _GEMM.search(name):
            groups["GEMMs (cuBLAS)"] += ms
        else:
            groups["rest"] += ms
    busy = sum(groups.values())
    summary = {"card": card, "label": label, "batch": cfg.batch_size,
               "tokens_per_image": trainer.model.seq,
               "step_ms_on_device_batch": step_ms, "host_batch_ms": host_ms,
               "device_busy_ms_per_step": busy,
               "device_busy_share": busy / step_ms, "groups_ms": groups,
               "kernels": [{"ms_per_step": ms, "per_step": n, "name": name}
                           for ms, n, name in rows]}
    with open(os.path.join(OUT, f"profile_{label}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[profile {label}] a step on a batch already on the card "
          f"{step_ms:.4f} ms; host batch assembly {host_ms:.4f} ms; device "
          f"busy {busy:.4f} ms/step ({100 * busy / step_ms:.1f}%): "
          + ", ".join(f"{k} {v:.4f} ms ({100 * v / busy:.1f}%)"
                      for k, v in groups.items()) + f", on {card}",
          flush=True)
    for ms, n, name in rows[:10]:
        print(f"[profile {label}]   {ms:.5f} ms/step  x{n}  {name[:110]}")
    return summary


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

    # ---- 10. flash parity (K3, K4, K6, K7) -------------------------------
    from dml_cnn_cifar10_tpu_torch import convert
    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    flash_worst = flash_parity(dev)

    # ---- 11. flash timing ------------------------------------------------
    flash_times = flash_timing(dev, card, bytes_per_s, ops_per_s)

    # ---- 12. ViT train: the main path ------------------------------------
    n_blocks = 12
    vit_log = os.path.join(WORK, "logs_vit")
    vit_base = ["--model", "vit_tiny", "--dataset", "synthetic",
                "--data_dir", os.path.join(WORK, "data_vit"),
                "--image_size", "72", "--crop_size", "64",
                "--synthetic_train_records", "10000", "--fidelity", "fixed",
                "--batch_size", "128", "--optimizer", "adamw",
                "--learning_rate", "3e-4", "--schedule", "cosine",
                "--warmup_steps", "20", "--eval_every", "100",
                "--checkpoint_every", "100", "--output_every", "50"]
    vit_jsonl = os.path.join(WORK, "vit_train.jsonl")
    fused.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    lines = run_cli(vit_base + ["--log_dir", vit_log, "--total_steps",
                                str(VIT_STEPS), "--metrics_jsonl",
                                vit_jsonl])
    wall_s = time.perf_counter() - t0
    vit_launches = dict(fa.LAUNCHES)
    check(sum(fused.LAUNCHES.values()) == 0,
          f"the AdamW ViT path launched K1/K2: {fused.LAUNCHES}")
    recs = records(vit_jsonl)
    train_recs = [r for r in recs if r["kind"] == "train"]
    losses = [r["loss"] for r in train_recs]
    check(len(losses) == VIT_STEPS // 50 and all(
        l is not None and math.isfinite(l) for l in losses),
        f"ViT losses {losses}")
    check(losses[-1] < losses[0], f"ViT loss did not fall: {losses}")
    accs = [float(m[1]) for m in map(EVAL_LINE.match, lines) if m]
    check(len(accs) == 2, f"ViT test accuracies {accs}")
    # Forward-only batches (K3): two full sweeps of the 512-record test
    # split at batch 128, plus the fresh-batch train accuracy at every
    # output boundary.
    fwd_only = 2 * 4 + VIT_STEPS // 50
    want = {"flash_fwd": fwd_only * n_blocks,
            "flash_fwd_lse": VIT_STEPS * n_blocks,
            "flash_bwd_dq": VIT_STEPS * n_blocks,
            "flash_bwd_dkv": VIT_STEPS * n_blocks}
    check(vit_launches == want,
          f"ViT main path launched {vit_launches}, want {want}")
    done = next(r for r in recs if r["kind"] == "done")
    ips = done["images_per_sec"]
    win = [r["images_per_sec"] for r in train_recs[1:]]
    win_ips = sum(win) / len(win)
    vit_rate = dict(steps_per_s=ips / 128, images_per_s=ips,
                    tokens_per_s=ips * 257, window_images_per_s=win_ips,
                    window_step_ms=128 / win_ips * 1e3, wall_s=wall_s,
                    losses=losses, test_accuracy=accs)
    print(f"[vit train] {VIT_STEPS} steps, ViT-Ti 257 tokens f32 batch 128 "
          f"AdamW: loss {losses[0]:.4f} -> {losses[-1]:.4f}, test accuracy "
          f"{accs[-1]:.2f}%, {ips / 128:.3f} steps/s = {ips:.1f} images/s "
          f"= {ips * 257:.0f} tokens/s over the run (evals and checkpoints "
          f"included; {win_ips:.1f} images/s = {128 / win_ips * 1e3:.2f} "
          f"ms/step in the windows after step 50), {wall_s:.1f} s wall with "
          f"data generation; launches {vit_launches}, on {card}", flush=True)

    # ---- 13. ViT resume + eval mode --------------------------------------
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer
    resume_args = vit_base + ["--log_dir", vit_log, "--total_steps",
                              str(VIT_RESUME_STEPS)]
    trainer = Trainer(config_from_args(build_parser().parse_args(
        resume_args)))
    state = trainer.init_or_restore()
    with open(os.path.join(vit_log, f"ckpt_{VIT_STEPS}.msgpack"), "rb") as f:
        tree = ckpt.from_bytes(f.read())
    check(int(state.step) == VIT_STEPS, f"restored step {int(state.step)}")
    for key in ("mu", "nu"):
        saved = convert.params_from_jax(tree["opt"][key])
        check(all(torch.equal(t.cpu(), saved[n])
                  for n, t in state.opt[key].items())
              and any(bool(t.any()) for t in state.opt[key].values()),
              f"AdamW {key} did not come back from the checkpoint")
    del trainer, state, tree
    fa.reset_launches()
    lines = run_cli(resume_args + ["--metrics_jsonl",
                                   os.path.join(WORK, "vit_resume.jsonl")])
    steps = [int(m[1]) for m in map(STEP_LINE.match, lines) if m]
    check(steps == list(range(VIT_STEPS + 50, VIT_RESUME_STEPS + 1, 50)),
          f"resumed ViT printed steps {steps}")
    check(fa.LAUNCHES["flash_fwd_lse"]
          == (VIT_RESUME_STEPS - VIT_STEPS) * n_blocks,
          f"ViT resume ran {fa.LAUNCHES['flash_fwd_lse'] // n_blocks} steps")
    resumed_acc = [m[1] for m in map(EVAL_LINE.match, lines) if m]
    lines = run_cli(vit_base + ["--log_dir", vit_log, "--mode", "eval"])
    eval_acc = [m[1] for m in map(EVAL_LINE.match, lines) if m]
    check(len(resumed_acc) == 1 and eval_acc == resumed_acc,
          f"ViT --mode eval printed {eval_acc}, training {resumed_acc}")
    check(any(f"eval at step {VIT_RESUME_STEPS}" in l for l in lines),
          "ViT eval mode did not restore the last checkpoint")
    print(f"[vit resume] continued {VIT_STEPS} -> {VIT_RESUME_STEPS} with "
          f"the AdamW moments restored; --mode eval {eval_acc[0]}% matches",
          flush=True)

    # ---- 14. long context: 8,100 tokens, bf16, remat ---------------------
    long_base = ["--model", "vit_tiny", "--dataset", "synthetic",
                 "--data_dir", os.path.join(WORK, "data_long"),
                 "--image_size", "368", "--crop_size", "360", "--pool",
                 "mean", "--remat", "true", "--compute_dtype", "bfloat16",
                 "--optimizer", "adamw", "--learning_rate", "3e-4",
                 "--batch_size", "2", "--synthetic_train_records", "64",
                 "--fidelity", "fixed", "--output_every", "5",
                 "--eval_every", "1000", "--checkpoint_every", "1000"]
    long_jsonl = os.path.join(WORK, "vit_long.jsonl")
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_cli(long_base + ["--log_dir", os.path.join(WORK, "logs_long"),
                         "--total_steps", str(LONG_STEPS), "--metrics_jsonl",
                         long_jsonl])
    long_wall = time.perf_counter() - t0
    long_launches = dict(fa.LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated()
    want = {"flash_fwd": (LONG_STEPS // 5) * n_blocks,
            "flash_fwd_lse": LONG_STEPS * n_blocks * 2,
            "flash_bwd_dq": LONG_STEPS * n_blocks,
            "flash_bwd_dkv": LONG_STEPS * n_blocks}
    check(long_launches == want,
          f"long context launched {long_launches}, want {want}")
    long_recs = records(long_jsonl)
    long_losses = [r["loss"] for r in long_recs if r["kind"] == "train"]
    check(long_losses and all(l is not None and math.isfinite(l)
                              for l in long_losses),
          f"long-context losses {long_losses}")
    # One dense f32 score matrix of this batch (2 x 3 heads x 8100^2)
    # would take 1.57 GB on its own.
    dense_bytes = 2 * 3 * 8100 * 8100 * 4
    check(peak_bytes < dense_bytes,
          f"long context peaked at {peak_bytes} bytes, more than one dense "
          f"score matrix ({dense_bytes})")
    long_ips = [r["images_per_sec"] for r in long_recs
                if r["kind"] == "train"][-1]
    long_rate = dict(step_ms=2 / long_ips * 1e3, tokens_per_s=long_ips * 8100,
                     losses=long_losses, peak_bytes=peak_bytes,
                     wall_s=long_wall)
    print(f"[long context] {LONG_STEPS} steps of 2 x 8,100 tokens, bf16, "
          f"remat: loss {long_losses}, {long_rate['step_ms']:.1f} ms/step = "
          f"{long_rate['tokens_per_s']:.0f} tokens/s (steps 6-10), peak "
          f"device memory {peak_bytes / 2**20:.1f} MiB; launches "
          f"{long_launches}, on {card}", flush=True)

    # ---- 15. where a ViT step's time goes --------------------------------
    vit_profile = profile_vit(
        vit_base + ["--log_dir", os.path.join(WORK, "logs_vit_profile")],
        "vit", card, steps=10)
    long_profile = profile_vit(
        long_base + ["--log_dir", os.path.join(WORK, "logs_long_profile")],
        "long", card, steps=2)

    for path in (train_jsonl, resume_jsonl, mom_jsonl, vit_jsonl,
                 os.path.join(WORK, "vit_resume.jsonl"), long_jsonl):
        shutil.copy(path, OUT)
    with open(os.path.join(OUT, "vit.json"), "w") as f:
        json.dump({"card": card, "main": vit_rate, "long": long_rate,
                   "flash_timing": {f"{k}/{l}": v
                                    for (k, l), v in flash_times.items()},
                   "flash_parity": {f"{k}/{d}": v
                                    for (k, d), v in flash_worst.items()},
                   "profiles": {"vit": {k: v for k, v in vit_profile.items()
                                        if k != "kernels"},
                                "long": {k: v for k, v in long_profile.items()
                                         if k != "kernels"}}}, f, indent=1)
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
    for name, kid, line, needle in (
            ("flash_fwd", "K3", 345, "flash_out_kernel"),
            ("flash_fwd_lse", "K4", 360, "flash_lse_kernel"),
            ("flash_bwd_dq", "K6", 688, "flash_dq_kernel"),
            ("flash_bwd_dkv", "K7", 736, "flash_dkv_kernel")):
        t, long_t = flash_times[(name, "vit")], flash_times[(name, "long")]
        kernels.append({
            "name": name, "kernel": kid, "route": "cuda",
            "source": "dml_cnn_cifar10_tpu_torch/csrc/flash_attention.cu",
            "cuda_kernel": needle,
            "replaces": f"dml_cnn_cifar10_tpu/ops/flash_attention.py:{line}",
            "launches": vit_launches[name],
            "launches_long_context": long_launches[name],
            "max_abs_err": flash_worst[(name, "float32")],
            "max_abs_diff": flash_worst[(name, "float32")],
            "max_abs_err_bf16": flash_worst[(name, "bfloat16")],
            "ms": t["ms"], "kernel_ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library": t["library"],
            "work": f"one launch at the ViT main path's attention "
                    f"{t['shape']} {t['dtype']} ({t['flops']} FLOPs, "
                    f"{t['bytes']} bytes)",
            "long": {k: long_t[k] for k in ("shape", "dtype", "ms",
                                            "device_ms", "plain_ms",
                                            "library_ms", "bound_ms",
                                            "bound_by")},
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
