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
            ``flash_attention.cu``); print ptxas's report, and for each of
            the 36 flash instances (K3, K4, K5: dtype x head dim; K6, K7
            also x P/dS terms) its registers, stack, spills and dynamic
            shared memory: the head-dim-64 ones must not spill.
3. parity   K1 ``sgd_update_plain`` and K2 ``sgd_update_momentum`` (one
            body; every f32 leaf of a step in one launch, ``MAX_LEAVES`` a
            launch) against their plain PyTorch version, all cases in one
            call for each (mu, wd) in {0, 0.9} x {0, 5e-4}: the CNN's 10
            leaf shapes, a one-element and an empty leaf, ragged and
            misaligned views, enough leaves for a second launch, and a
            bf16 leaf (the plain version). Both bit-equal; the launches
            counted.
4. timing   each kernel's optimizer step over the CNN's 10 leaves (CUDA
            events, and the kernels' own device time from torch.profiler),
            beside its plain version, ``torch.optim.SGD(fused=True).step()``
            on the same leaves (a yardstick the port never calls; by
            events and by the device time of its kernels), and the
            bound: the bytes the update must move over the card's memory
            rate, or its f32 operations over the card's f32 rate.
5. train    the main path, ``cli.main.main``: the reference CNN at full
            width (batch 128, 24x24x3 crop, 1,068,298 params) for 500
            steps on 50,000 synthetic records. Loss finite, K1 launched
            once per step, final test accuracy far above chance.
6. resume   the same log dir to step 600: the global step continues at 500.
7. eval     ``--mode eval`` restores step 600 and prints the accuracy of the
            in-training eval at step 600.
8. momentum 50 steps with ``--momentum 0.9 --weight_decay 5e-4``: K2
            launched once per step, K1 never.
9. profile  where a training step's time goes: the trainer's own rate, a
            step on a batch already on the card, the host's batch
            assembly, and the device's busy time by kernel.
9b. chunked  the main path with ``--steps_per_dispatch 10``: the train
            split resident on the card, its rows from the device index
            stream, each chunk of 10 steps one CUDA graph replay. 500
            steps: finite losses, test accuracy above 50%, K1 once a step
            (each replay adds the launches its capture recorded; the
            warm-up's 10 are kept apart), 50 replays, no index-stream
            miss; resume to 600 continues at 500; the resident full-split
            eval counts what the host-fed sweep counts on the same state;
            50 momentum steps launch K2 once a step; one graphed chunk
            against the same chunk body run eagerly from one state, cuDNN
            deterministic (loss 1e-6 relative, params 1e-5; printed
            without it too); a small ViT (145 tokens, the flash kernels)
            chunked the same way: a replay launches what the eager body
            launches, losses within 1e-5 relative; then a profile of 20
            replays (ms/step, device busy share, no host-to-device copy)
            beside phase 9's eager numbers, written to
            ``OUT/chunk.json``.
10. flash parity  K3 ``flash_fwd``, K4 ``flash_fwd_lse``, K6
            ``flash_bwd_dq`` and K7 ``flash_bwd_dkv`` against their plain
            versions on the card, in the working dtype: the ViT's
            [2, 257, 3, 64] in f32, bf16 and as strided views of one fused
            qkv; ragged S=300; causal; window 100; segment ids; kv_start
            (K4, K6, K7); dead rows (exactly 0); head dims 32 and 128;
            and the main paths' own shapes, [128, 257, 3, 64] f32 and
            [2, 8100, 3, 64] bf16, as views of a fused qkv, and a Ulysses
            rank's [2, 8100, 1, 64] bf16. Tolerances: the JAX package's pins in
            f32 (out 5e-6, lse 1e-5, grads 5e-5); in bf16 lse keeps
            1e-5 and out and grads 1e-2 x max|plain| (one bf16 ulp; at most
            0.05). A CUDA input the kernels cannot take must raise.
11. flash timing  each flash kernel at [128, 257, 3, 64] f32,
            [2, 8100, 3, 64] bf16 and a Ulysses rank's [2, 8100, 1, 64]
            bf16: CUDA events, device time, the plain
            version, ``F.scaled_dot_product_attention`` (a yardstick the
            port never calls; by CUDA events and by device time) and the
            bound, and the tensor-core bound of the split products each
            kernel issues.
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
16. stats parity  K5 ``flash_fwd_stats`` against its plain version on the
            card: the SP main path's [2, 4050, 3, 64] bf16 block (views of
            a fused qkv) and [128, 128, 3, 64] f32, ragged, causal, a ring
            step's neighbour windows at kv_start = -S / +S, segment-id
            pairs, dead rows (exactly m = -1e30, l = 0, acc = 0), head dims
            32 and 128. f32 acc / l 5e-6; m and l 1e-5 relative; bf16
            acc / l 1e-2 x max|plain|. A CUDA input K5 cannot take raises.
            Then K6/K7 as the backward ring calls them, bf16 q/k/v of that
            block -> f32 gradients, on the diagonal block and at kv_start =
            -S / +S with window 512, against the plain version: 5e-5.
17. stats timing  K5 at [2, 4050, 3, 64] bf16: CUDA events, device time,
            the plain version, ``F.scaled_dot_product_attention`` forward
            (by CUDA events and by device time), the bound, the
            tensor-core bound of the products K5 issues and its TFLOP/s;
            the ring's K6/K7 at that block on a card alone, with their
            bounds, TFLOP/s and SDPA's backward on the block (contiguous
            [B, H, S, D] inputs, warmed up, read A/B/B/A against the pair
            by CUDA events and by device time; the kernel it picked is
            printed).
The distributed phases (``dist_phases``) run each rank as a process of its
own (this script with ``--rank R --job FILE``, after the build): over NCCL
with a card each when there are two cards, else both on this card over
gloo. Each rank starts with every launch count at 0 and writes its counts
(and, after a training run, a digest of its parameters) to ``OUT/ranks/``.
18. ring op  the 2-rank ring attention against the one-rank flash
            attention of the full sequence, out and gradients: f32
            [2, 2048, 3, 64] full, causal and window 512 (out 2e-5, grads
            5e-5), and bf16 [2, 8100, 3, 64] (1e-2 x max|reference|).
19. sp train  the SP main path, ``cli.main.main --seq_axis 2`` on each
            rank: ViT-Ti at full width on the 8,100-token recipe of phase
            14, 4,050 tokens a rank, 10 steps. Per rank K5 = 10 x 48 + 24
            per forward-only batch, K6 = K7 = 10 x 24, K3 = K4 = K1 = K2 =
            0; equal parameter digests; every logged loss (steps 5 and 10)
            within 1e-3 of phase 14's one-rank run (same seed, batches and
            weights). Then a resume to step 15 and ``--mode eval`` over the
            two ranks.
20. dp cnn  the CNN data-parallel over 2 ranks x 64 images (global batch
            128), 100 steps: K1 = 100 per rank (one a step), equal
            digests.
21. sp profile  an SP step's time per rank (host clock, batch on the card)
            and its device timeline: the union of its compute kernels'
            intervals over all streams (busy time and share of the step),
            the hops and all-reduces (NCCL kernels, or gloo's host copies)
            apart, the time the two overlap, and K5/K6/K7.

Then the serving path, on phase 6's CNN checkpoint (step 600) and phase
13's ViT-Ti checkpoint (step 300):
22. export  ``--mode export`` for each: the artifact (``<log_dir>/
            model.pt2``) holds 12 flash operator nodes for the ViT-Ti and
            none for the CNN, loads on the card, and serves b = 1, 8, 32
            and 128 within 1e-5 of the live weights' eager forward.
23. serve k3  K3 through ``dml_torch::flash_attention_out`` at the four
            serving shapes [b, 257, 3, 64] f32 (views of a fused qkv)
            against its plain version (5e-6), timed at b = 1 and 128:
            CUDA events, device time, the plain version, SDPA and the
            bound.
24. graphs  each engine (the artifact's, and the live weights') captures
            one CUDA graph a bucket at warm-up; each replay
            against the eager forward (1e-5 of the largest logit), 12 K3
            a ViT-Ti replay, at most one copy in (the uint8 batch) and
            one out (the logits) a served batch, so no weight copy (10
            traced batches; a trace drops some memcpy events); replay
            and eager ms a bucket; where a served batch's time goes at
            b = 1 and 128.
25. serve http  ``--mode serve`` (``main_serve`` with the CLI's config)
            in a thread, driven by the port's loadgen in a process of its
            own: closed loops at 1, 32 and 128 clients, twice each, every
            answer's class the direct forward's (near-ties left out and
            counted), no error but 503, and the served ViT-Ti path
            launched 12 K3 a replay and no other kernel; an open loop past
            capacity with a 2-deep queue and a 0.5 ms deadline sheds; the
            CNN's step-500 weights served live with 32 clients while step
            600 is hot-swapped in: the tags flip, every answer within 1e-4
            of its version's forward, one ``swap`` record. Numbers in
            ``OUT/serve.json`` and the loadgen reports.

Then the slice of Ulysses, telemetry and the optimizer surface:
26. ulysses op  3 rank processes (ViT-Ti's 3 heads, one a rank; gloo on
            one card, NCCL given three): Ulysses attention at [2, 8100, 3,
            64] bf16 (2,700 tokens a rank) and f32 full and causal cases
            against the one-rank flash attention of the full sequence, out
            and gradients, with phase 18's pins; the long-context call
            launches one K4, one K6 and one K7 a rank, at [2, 8100, 1, 64].
27. ulysses train  ``cli.main.main --seq_axis 3 --sp_mode ulysses`` on the
            long-context recipe of phase 14, 10 steps: per rank K4 = 10 x
            24, K6 = K7 = 10 x 12, K3 = 12 per forward-only batch, K5 = K1
            = K2 = 0; equal parameter digests; every logged loss within
            1e-3 of phase 14's one-rank run. Then a resume to step 15,
            ``--mode eval`` (16 batches of 32 on each rank) and rank 0's
            step time and device timeline.
28. telemetry  the ``train`` records of the CNN (eager and chunked),
            ViT-Ti, long-context, ring SP and Ulysses runs carry
            ``device_step_ms``, ``drain_wait_ms``,
            ``tflops_per_sec_per_chip`` and ``mfu`` (``--peak_tflops`` 67
            on the f32 paths, 989 on the bf16 ones); each path's TFLOP/s
            and MFU printed with the card. Then ``--profile_at_steps
            30:10`` on 60 CNN steps, eager and chunked: ``devtime``
            records; the chunked window's ``optimizer_ms`` (K1 by name: a
            graph replay has no range) within 2x of K1's device time in
            phase 9b's replays, the eager one's (the ``optimizer``
            range: the LR schedule, K1, the step counter) within 2x of
            one update's device time, and the eager window's compute per
            step within 25% of phase 9's device time.
29. optimizer  100 CNN steps each with ``--grad_clip_norm 1 --momentum
            0.9`` (K2 once a step), ``--grad_accum 2`` (K1 once a step),
            ``--async_staleness 2`` (K1 once a step) and ``--optimizer
            lars|lamb|adafactor`` (no K1/K2): losses finite and falling.
            ``--async_staleness 2 --steps_per_dispatch 10``, 100 steps,
            then one graphed chunk against the eager body from its state,
            bit for bit with cuDNN deterministic; eager 50 + 50 steps with
            a resume against 100 steps: the same losses and step-100
            checkpoint, bit for bit. Numbers in ``OUT/slice10.json``.

``--dist`` runs the build and phases 18-21 alone over NCCL on two or more
cards, with 4 ranks beside 2 given four cards: SP data 2 x seq 2 against
its 2 data ranks without the ring, and the DP CNN on 4 ranks; given three
or more cards, phases 26-27 over NCCL on 3 of them.

The lines before the last are ``{"kernels": [...]}`` (K3 three times:
its training row, its serving row with ``"path": "serve"`` and its Ulysses
row; K4, K6 and K7 twice, with a ``"path": "ulysses"`` row) and the card's
name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Scratch data and checkpoints go to ``.chip_smoke_work/`` (removed after a
passing run); the run's metrics JSONL files, the profiles, ``chunk.json``
(phase 9b), ``vit.json``
(the ViT phases' numbers), ``serve.json`` (phases 22-25), ``dist.json``
(phases 16-21;
``dist_nccl.json`` under ``--dist``) and the ranks' logs are written to
the output directory ``OUT``.
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
DP_STEPS = 100
CASES = [(0.0, 0.0), (0.0, 5e-4), (0.9, 0.0), (0.9, 5e-4)]
# Published peaks (NVIDIA data sheets, SXM parts, full power limit):
# device-memory bytes/s and f32 operations/s outside the tensor cores.
PEAKS = {"H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}
# bf16 operations/s on the tensor cores (dense), the bf16 kernels' bound.
BF16_PEAK = 989e12
# --peak_tflops of each path, the card's dense peak for its dtype: f32
# outside the tensor cores (TF32 is off on every f32 path), bf16 on them.
F32_PEAK_TFLOPS, BF16_PEAK_TFLOPS = "67", "989"

EVAL_LINE = re.compile(r"^ --- Test Accuracy = (\d+\.\d\d)%\.$")
STEP_LINE = re.compile(r"^global_step (\d+), task:0_step (\d+), ")


# The train step's record_function ranges (parallel/step.py). The
# profiler puts each on the device's timeline as an annotation spanning
# its kernels: device time, but not work of its own.
STEP_RANGES = ("fwd_bwd", "optimizer")


def is_device_work(ev) -> bool:
    """A device event of a profile that is a kernel, copy or memset (not
    one of the step's ranges)."""
    from torch.autograd import DeviceType
    return (getattr(ev, "device_type", None) == DeviceType.CUDA
            and getattr(ev, "key", getattr(ev, "name", None))
            not in STEP_RANGES)


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


def kernel_ms(fn, reps=50) -> dict:
    """Device ms per ``fn()`` of each kernel (and device memset or copy) it
    runs, by name, from torch.profiler. The trace can miss one kernel
    event of a profiling run (seen on the card: one of two), so each is
    its mean per traced event times its events per call, not the sum over
    ``reps``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", None)
              or getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0 and ev.count:
            out[ev.key] = us / ev.count * max(1, round(ev.count / reps)) / 1e3
    return out


def device_ms(fn, needle: str, reps=100):
    """Device time per ``fn()`` of the kernels whose name holds
    ``needle`` (``kernel_ms``); None when the trace shows none."""
    found = [ms for name, ms in kernel_ms(fn, reps).items() if needle in name]
    return sum(found) if found else None


def profile_step(args, train_recs, card, steps=50) -> None:
    """Split the main path's step time: the trainer's windowed rate (its
    own JSONL, steps 200-500), one step with its batch already on the
    card (CUDA events), the host's batch assembly, and the device's busy
    time per step by kernel (torch.profiler). Written to
    ``chiprun_out/chip_smoke/profile.json``."""
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
                   for ev in prof.key_averages() if is_device_work(ev)),
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
    return summary


def run_trainer(args):
    """``Trainer(config_from_args(args)).fit()``, the CLI's train mode
    with the trainer kept, echoing its console; returns ``(lines,
    trainer, result)``."""
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer
    buf = io.StringIO()
    print("$ python -m dml_cnn_cifar10_tpu_torch " + " ".join(args),
          flush=True)
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        trainer = Trainer(config_from_args(build_parser().parse_args(args)))
        try:
            result = trainer.fit()
        finally:
            trainer.logger.close()
    return buf.getvalue().splitlines(), trainer, result


# Steps per dispatch of the chunked phase (9b), and its graphed-vs-eager
# gate: the loss of ten steps (relative) and every parameter after them.
# The graph replays the kernels the eager body launches, on the same
# inputs in the same order, so with cuDNN held to deterministic algorithms
# for the comparison the two agreed bit for bit on an H100 (PERF.md), as
# did two eager runs. Without it (printed, not gated), cuDNN may
# pick backward kernels that sum with atomics, and ten steps of SGD carry
# the difference along. The gate leaves room for a stray rounding, while
# a wrong row, a skipped or repeated update (lr x gradient, 1e-4 and up)
# lands outside it.
CHUNK_K = 10
CHUNK_LOSS_TOL, CHUNK_PARAM_TOL = 1e-6, 1e-5


def _cnn_copies(cfg, state, n):
    """``n`` (model, state) pairs of the CNN holding ``state``'s values."""
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
    out = []
    for _ in range(n):
        model = get_model(cfg.model.name)(cfg.model, cfg.data)
        st = step_lib.init_train_state(model, cfg.optim,
                                       torch.device("cuda"))
        with torch.no_grad():
            for a, b in zip(step_lib._state_tensors(st),
                            step_lib._state_tensors(state)):
                a.copy_(b)
        out.append((model, st))
    return out


def _gaps(a, b):
    """Largest parameter gap between two states."""
    return max((x - y).abs().max().item()
               for x, y in zip(a.params.values(), b.params.values()))


def _graph_vs_eager(cfg, state, ds_images, ds_labels, deterministic):
    """One graphed chunk of the device-stream resident path against the
    same chunk body run eagerly, twice, each from a copy of ``state``;
    returns the gaps, the graphed callable and its state."""
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        copies = _cnn_copies(cfg, state, 3)
        fns = [step_lib.make_train_chunk_resident(
            m, cfg.optim, ds_images, ds_labels, data_cfg=cfg.data,
            index_stream=(cfg.data.seed, cfg.batch_size, CHUNK_K))
            for m, _ in copies]
        (_, s_g), (_, s_e), (_, s_e2) = copies
        losses = [float(fns[0](s_g)[1]["loss"]),
                  float(fns[1].eager(s_e)[1]["loss"]),
                  float(fns[2].eager(s_e2)[1]["loss"])]
        fns[0].check()
    finally:
        torch.backends.cudnn.deterministic = saved
    return ({"loss_graph": losses[0], "loss_eager": losses[1],
             "loss_gap": abs(losses[0] - losses[1]),
             "param_gap": _gaps(s_g, s_e),
             "eager_eager_loss_gap": abs(losses[1] - losses[2]),
             "eager_eager_param_gap": _gaps(s_e, s_e2)}, fns[0], s_g)


def _vit_chunk_check(card) -> dict:
    """The ViT under chunked dispatch: a small ViT (depth 2, dim 64, 48x48
    crop = 145 tokens, so the flash kernels run) on the resident device
    stream, K = 2, AdamW, two graphed chunks against the same body run
    eagerly from one state: the flash launches a replay adds equal the
    eager body's, and the losses agree (AdamW turns the rounding of
    nondeterministic sums into steps of +-lr, so params are printed, not
    gated)."""
    import numpy as np

    from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                                  OptimConfig)
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    mcfg = ModelConfig(name="vit_tiny", logit_relu=False, vit_depth=2,
                       vit_dim=64, vit_heads=2)
    dcfg = DataConfig(image_height=52, image_width=52, crop_height=48,
                      crop_width=48, random_crop=True,
                      normalize="standardize")
    ocfg = OptimConfig(optimizer="adamw", learning_rate=1e-3,
                       schedule="cosine", cosine_decay_steps=100,
                       warmup_steps=2, dead_lr_decay=False)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    images = torch.from_numpy(rng.integers(0, 256, (512, 52, 52, 3),
                                           dtype=np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 10, 512)).to(dev)
    runs = []
    for _ in range(2):
        model = get_model(mcfg.name)(mcfg, dcfg)
        state = step_lib.init_train_state(model, ocfg, dev,
                                          torch.Generator().manual_seed(0))
        runs.append((state, step_lib.make_train_chunk_resident(
            model, ocfg, images, labels, data_cfg=dcfg,
            index_stream=(0, 16, 2))))
    (s_g, f_g), (s_e, f_e) = runs
    fa.reset_launches()
    gaps, graph_launches = [], {}
    for _ in range(2):
        before = dict(fa.LAUNCHES)
        loss_g = float(f_g(s_g)[1]["loss"])
        graph_launches = {n: fa.LAUNCHES[n] - before[n] for n in before}
        before = dict(fa.LAUNCHES)
        loss_e = float(f_e.eager(s_e)[1]["loss"])
        eager_launches = {n: fa.LAUNCHES[n] - before[n] for n in before}
        check(graph_launches == eager_launches and math.isfinite(loss_g),
              f"ViT chunk: replay launched {graph_launches}, the eager "
              f"body {eager_launches}; loss {loss_g}")
        gaps.append((loss_g, loss_e, _gaps(s_g, s_e)))
    f_g.check()
    check(all(abs(g - e) <= 1e-5 * abs(e) for g, e, _ in gaps),
          f"ViT chunk losses (graph, eager, param gap): {gaps}")
    check(f_g.graph.replays == 2, f"ViT chunk replays {f_g.graph.replays}")
    print(f"[chunk vit] depth 2, 145 tokens, K = 2: (graph loss, eager "
          f"loss, params max gap) per chunk {gaps}; flash launches a "
          f"replay {graph_launches}; on {card}", flush=True)
    return {"chunks": gaps, "flash_launches_per_replay": graph_launches}


def chunk_phase(base, card, eager_profile) -> dict:
    """Phase 9b: the CNN main path with ``--steps_per_dispatch 10``,
    resident on the device index stream (see the module docstring).
    Returns the numbers, also written to ``OUT/chunk.json``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    k = CHUNK_K
    args = base + ["--steps_per_dispatch", str(k)]
    log_dir = os.path.join(WORK, "logs_chunk")
    jsonl = os.path.join(WORK, "chunk_train.jsonl")
    fused.reset_launches()
    t0 = time.perf_counter()
    lines, trainer, _ = run_trainer(args + [
        "--log_dir", log_dir, "--total_steps", str(STEPS), "--eval_every",
        "250", "--metrics_jsonl", jsonl])
    wall_s = time.perf_counter() - t0
    fn = trainer.train_fn
    launches = dict(fused.LAUNCHES)
    want = {"sgd_update_plain": STEPS, "sgd_update_momentum": 0}
    check(launches == want, f"chunked run launched {launches}, want {want}"
          " (K1 once a step)")
    check(fn.graph.replays == STEPS // k,
          f"{fn.graph.replays} graph replays for {STEPS // k} chunks")
    check(fn.graph.warmup_launches == {"sgd_update_plain": k},
          f"warm-up launches {fn.graph.warmup_launches}")
    rows = fn.rows
    check(int(rows.misses) == 0, f"index stream misses {int(rows.misses)}")
    recs = records(jsonl)
    train_recs = [r for r in recs if r["kind"] == "train"]
    losses = [r["loss"] for r in train_recs]
    check(len(losses) == STEPS // 100 and all(
        l is not None and math.isfinite(l) for l in losses),
        f"chunked losses {losses}")
    accs = [float(m[1]) for m in map(EVAL_LINE.match, lines) if m]
    check(len(accs) == 2 and accs[-1] > 50.0,
          f"chunked test accuracies {accs} (chance is 10%)")
    windows = [r["images_per_sec"] for r in train_recs if r["step"] > 100]
    loop_ms = 128 / (sum(windows) / len(windows)) * 1e3
    print(f"[chunk train] {STEPS} steps in {STEPS // k} graph replays of "
          f"{k} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}, test "
          f"accuracy {accs[-1]:.2f}%, loop {loop_ms:.4f} ms/step (windows "
          f"after step 100), {wall_s:.1f} s wall; K1 {STEPS} launches "
          f"(+{k} in the warm-up, apart); index "
          f"stream: {rows.epochs_built} epoch tables, {rows.host_reads} "
          f"host reads, misses {int(rows.misses)}; on {card}", flush=True)

    # Resume: the stream position is the step.
    fused.reset_launches()
    lines, trainer, result = run_trainer(args + [
        "--log_dir", log_dir, "--total_steps", str(RESUME_STEPS),
        "--eval_every", "100", "--metrics_jsonl",
        os.path.join(WORK, "chunk_resume.jsonl")])
    steps = [int(m[1]) for m in map(STEP_LINE.match, lines) if m]
    check(steps == [RESUME_STEPS], f"chunked resume printed steps {steps}")
    check(fused.LAUNCHES["sgd_update_plain"] == RESUME_STEPS - STEPS
          and trainer.train_fn.graph.replays == (RESUME_STEPS - STEPS) // k,
          f"chunked resume: K1 {fused.LAUNCHES}, "
          f"{trainer.train_fn.graph.replays} replays")
    print(f"[chunk resume] continued {STEPS} -> {RESUME_STEPS} in "
          f"{trainer.train_fn.graph.replays} replays", flush=True)

    # Eval: the resident sweep against the host-fed one, same state.
    cfg, state = trainer.cfg, result.state
    test_it = trainer.input_pipeline(train=False, seed=cfg.seed)
    ev, total = step_lib.make_eval_resident(
        trainer.model, test_it.images, test_it.labels, cfg.data,
        torch.device("cuda"), batch_size=cfg.batch_size,
        expected_batches=test_it.num_padded_sweep_batches())
    resident_count = int(ev(state))
    host_count = sum(int(trainer.eval_step(
        state, *trainer._placed(b))["correct"])
        for b in test_it.full_sweep_padded())
    check(resident_count == host_count,
          f"resident eval counted {resident_count}, the host-fed sweep "
          f"{host_count}")
    print(f"[chunk eval] step {RESUME_STEPS}: {resident_count}/{total} "
          f"correct, resident and host-fed sweeps equal", flush=True)

    # Momentum: K2 once a step under the graph.
    fused.reset_launches()
    run_trainer(args + ["--log_dir", os.path.join(WORK, "logs_chunk_mom"),
                        "--total_steps", str(MOMENTUM_STEPS),
                        "--output_every", "10", "--eval_every", "50",
                        "--momentum", "0.9", "--weight_decay", "5e-4"])
    mom_launches = dict(fused.LAUNCHES)
    want = {"sgd_update_plain": 0, "sgd_update_momentum": MOMENTUM_STEPS}
    check(mom_launches == want,
          f"chunked momentum launched {mom_launches}, want {want}")

    # Graphed against eager: one chunk from one (trained) state, with
    # cuDNN's deterministic algorithms (gated) and without (printed).
    train_it = trainer.input_pipeline(train=True, seed=cfg.seed)
    ds_images = torch.from_numpy(train_it.images).cuda()
    ds_labels = torch.from_numpy(train_it.labels.astype("int64")).cuda()
    compare, graphed = {}, {}
    for det in (False, True):
        c, *graphed[det] = _graph_vs_eager(cfg, state, ds_images,
                                           ds_labels, det)
        compare["deterministic" if det else "default"] = c
        print(f"[chunk graph vs eager] {k} steps from step {RESUME_STEPS}, "
              f"cudnn.deterministic={det}: loss {c['loss_graph']!r} vs "
              f"{c['loss_eager']!r} (gap {c['loss_gap']:.3g}), params max "
              f"gap {c['param_gap']:.3g}; two eager runs "
              f"{c['eager_eager_loss_gap']:.3g}, "
              f"{c['eager_eager_param_gap']:.3g}", flush=True)
    c = compare["deterministic"]
    check(c["loss_gap"] <= CHUNK_LOSS_TOL * abs(c["loss_eager"])
          and c["param_gap"] <= CHUNK_PARAM_TOL,
          f"graphed chunk differs from the eager body: {c}")

    vit = _vit_chunk_check(card)

    # Profile: replays of the graphed chunk (default cuDNN, as trained).
    fn_g, s_g = graphed[False]
    reps = 20
    for _ in range(2):
        fn_g(s_g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn_g(s_g)
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) / (reps * k) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn_g(s_g)
        torch.cuda.synchronize()
    steps_traced = reps * k
    prof_rows = _device_rows(prof, steps_traced)
    busy_ms = sum(r[0] for r in prof_rows)
    groups = dict.fromkeys(("convolutions (cuDNN)", "GEMMs (cuBLAS)",
                            "max pool", "K1", "rest"), 0.0)
    for ms, _, name in prof_rows:
        group = ("K1" if "sgd_multi_kernel" in name
                 else "convolutions (cuDNN)" if _CONV.search(name)
                 else "GEMMs (cuBLAS)" if _GEMM.search(name)
                 else "max pool" if "pool" in name else "rest")
        groups[group] += ms
    h2d = [ev.key for ev in prof.key_averages() if "HtoD" in ev.key]
    k1_events = sum(ev.count for ev in prof.key_averages()
                    if getattr(ev, "device_type", None) == DeviceType.CUDA
                    and "sgd_multi_kernel<false>" in ev.key)
    fn_g.check()
    check(not h2d, f"host-to-device copies in a window of replays: {h2d}")
    summary = {
        "card": card, "batch": cfg.batch_size, "steps_per_dispatch": k,
        "loop_ms_per_step": loop_ms, "replay_ms_per_step": window_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share_of_replays": busy_ms / window_ms,
        "device_busy_share_of_loop": busy_ms / loop_ms,
        "groups_ms_per_step": groups,
        "k1_launches": launches["sgd_update_plain"],
        "k1_kernel_events_traced": k1_events, "steps_traced": steps_traced,
        "k2_launches": mom_launches["sgd_update_momentum"],
        "warmup_launches": fn.graph.warmup_launches,
        "replays": STEPS // k, "host_to_device_copies": h2d,
        "index_stream": {"epochs_built": rows.epochs_built,
                         "host_reads": rows.host_reads, "misses": 0},
        "losses": losses, "test_accuracy": accs,
        "resident_eval_correct": resident_count,
        "host_eval_correct": host_count, "graph_vs_eager": compare,
        "vit": vit,
        "eager": {key: eager_profile[key] for key in (
            "loop_ms_per_step", "step_ms_on_device_batch", "host_batch_ms",
            "device_busy_ms_per_step", "device_busy_share")},
        "kernels": [{"ms_per_step": ms, "per_step": n, "name": name}
                    for ms, n, name in prof_rows]}
    with open(os.path.join(OUT, "chunk.json"), "w") as f:
        json.dump(summary, f, indent=1)
    e = summary["eager"]
    print(f"[chunk profile] chunked loop {loop_ms:.4f} ms/step, replays "
          f"{window_ms:.4f} ms/step, device busy {busy_ms:.4f} ms/step "
          f"({100 * busy_ms / window_ms:.1f}% of the replays, "
          f"{100 * busy_ms / loop_ms:.1f}% of the loop), K1 kernels "
          f"traced {k1_events} in {steps_traced} steps, host-to-device "
          f"copies {len(h2d)}; eager (phase 9): loop "
          f"{e['loop_ms_per_step']:.4f} ms/step, device-batch step "
          f"{e['step_ms_on_device_batch']:.4f} ms, busy "
          f"{e['device_busy_ms_per_step']:.4f} ms "
          f"({100 * e['device_busy_share']:.1f}%); on {card}", flush=True)
    print("[chunk profile] device ms/step by group: " + ", ".join(
        f"{g} {ms:.5f} ({100 * ms / busy_ms:.1f}%)"
        for g, ms in groups.items()), flush=True)
    for ms, n, name in prof_rows[:12]:
        print(f"[chunk profile]   {ms:.5f} ms/step  x{n}  {name[:110]}")
    return summary


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_INSTANCE = re.compile(r"(flash_out_kernel|flash_lse_kernel|"
                       r"flash_stats_kernel|flash_dq_kernel|flash_dkv_kernel)"
                       r"I(f|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)E)?")
# Instances a build must hold: K3, K4, K5 per input dtype and head dim;
# K6, K7 also per P/dS term count.
_INSTANCES = {"flash_out_kernel": 6, "flash_lse_kernel": 6,
              "flash_stats_kernel": 6, "flash_dq_kernel": 9,
              "flash_dkv_kernel": 9}


def ptxas_report(log: str) -> list:
    """ptxas's registers, stack and spills for every flash instance (input
    dtype x head dim, and for K6/K7 x P/dS terms), beside the dynamic
    shared memory it launches with. Fails unless all 36 are found and the
    head-dim-64 instances (K3-K7: the main paths') spill nothing."""
    import ctypes

    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    lib = fa._lib()
    fwd, bwd = lib.flash_fwd_smem_bytes, lib.flash_bwd_smem_bytes
    for fn in (fwd, bwd):
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    # kernel -> its shared-memory query and that query's first argument
    smem_of = {"flash_out_kernel": (fwd, 0), "flash_lse_kernel": (fwd, 0),
               "flash_stats_kernel": (fwd, 1), "flash_dq_kernel": (bwd, 0),
               "flash_dkv_kernel": (bwd, 1)}
    found, cur = {}, None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = found.setdefault(m[1], {})
            continue
        m = _PTXAS_SPILL.search(line)
        if m and cur is not None:
            cur.update(stack_bytes=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = _PTXAS_REGS.search(line)
        if m and cur is not None:
            cur["registers"] = int(m[1])
    report = []
    for name, info in sorted(found.items()):
        m = _INSTANCE.search(name)
        if not m:
            continue
        dt = 0 if m[2] == "f" else 1
        report.append(dict(kernel=m[1], dtype=["float32", "bfloat16"][dt],
                           head_dim=int(m[3]),
                           terms=int(m[4]) if m[4] else None,
                           smem_bytes=smem_of[m[1]][0](smem_of[m[1]][1], dt,
                                                       int(m[3])), **info))
    for r in report:
        print(f"[build] {r['kernel']} {r['dtype']} D={r['head_dim']}"
              + (f" P/dS terms {r['terms']}" if r["terms"] else "")
              + f": {r.get('registers')} registers, "
              f"{r.get('stack_bytes')} B stack, {r.get('spill_stores')}/"
              f"{r.get('spill_loads')} B spill stores/loads, "
              f"{r['smem_bytes']} B dynamic shared memory")
    counts = {k: sum(r["kernel"] == k and "spill_loads" in r for r in report)
              for k in _INSTANCES}
    check(counts == _INSTANCES,
          f"ptxas reported {counts} flash instances, want {_INSTANCES}")
    check(all(r["spill_stores"] == r["spill_loads"] == 0 for r in report
              if r["head_dim"] == 64),
          "a head-dim-64 flash instance spills")
    return report


def cu_constant(name: str) -> int:
    """``constexpr int <name> = N;`` of ``csrc/flash_attention.cu``."""
    path = os.path.join(ROOT, "dml_cnn_cifar10_tpu_torch", "csrc",
                        "flash_attention.cu")
    with open(path) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read())[1])


def tc_flops(kname: str, f32_in: bool, f32_grads: bool = False) -> int:
    """Tensor-core FLOPs per B·H·Sq·Skv·D that K3/K4/K5 (S, O), K6 (S,
    dP, dQ) or K7 (S, dP, dV, dK) issue: 2 per product times the term
    pairs of its split (f32 inputs: 6 for every product; bf16 inputs: 1,
    but kStatsBf16Terms for K5's P V and 3 for K6/K7's second products
    with f32 gradients)."""
    first = 6 if f32_in else 1
    if kname.startswith("flash_fwd"):
        pv = first if f32_in or kname != "flash_fwd_stats" else cu_constant(
            "kStatsBf16Terms")
        return 2 * (first + pv)
    second = 6 if f32_in else (3 if f32_grads else 1)
    return 2 * (2 * first + (1 if kname == "flash_bwd_dq" else 2) * second)


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
    # Ulysses over 3 seq ranks: each rank's full-sequence head, contiguous
    # after the all-to-all.
    ("ulysses", (2, 8100, 8100, 1, 64), torch.bfloat16, {}),
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


# Per case of the last flash_parity, each kernel's max abs difference.
FLASH_CASE_DIFFS = {}


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
        FLASH_CASE_DIFFS[name] = diffs
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
# 257 tokens, 3 heads of 64, f32), the long-context recipe's (8,100
# tokens, bf16) at batch 2, and its Ulysses rank's (one head of the 3).
FLASH_TIMING = [("vit", (128, 257, 3, 64), torch.float32),
                ("long", (2, 8100, 3, 64), torch.bfloat16),
                ("ulysses", (2, 8100, 1, 64), torch.bfloat16)]
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


def sdpa_backward(q, k, v, do):
    """``F.scaled_dot_product_attention``'s autograd backward (dQ, dK and
    dV together, gradients in the input's dtype), a yardstick the port
    never calls, on contiguous [B, H, S, D] copies of the [B, S, H, D]
    inputs and warmed up. Returns ``(fn, backend)``: the call to time and
    the name of the device kernel that takes most of its time."""
    import torch.nn.functional as F

    qg, kg, vg = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dog = do.transpose(1, 2).contiguous()
    og = F.scaled_dot_product_attention(qg, kg, vg)

    def fn():
        return torch.autograd.grad(og, (qg, kg, vg), dog, retain_graph=True)

    cuda_ms(fn, reps=1, warmup=20)
    per_kernel = kernel_ms(fn, reps=5)
    backend = max(per_kernel, key=per_kernel.get)[:120] if per_kernel else None
    return fn, backend


def flash_timing(dev, card, bytes_per_s, f32_ops) -> dict:
    """Each flash kernel at the main path's and the long shape: CUDA-event
    ms (launch included), the profiler's device ms, the plain version's
    ms, ``F.scaled_dot_product_attention``'s forward (for K3/K4) and its
    autograd backward (for K6+K7 together) as a yardstick the port never
    calls, by CUDA events and by device time, and the bound:
    matrix-product FLOPs over the dtype's peak (f32 on the CUDA cores,
    bf16 on the tensor cores) or the bytes each input and output needs
    once over the memory rate, whichever is larger; beside it the
    tensor-core bound of the split products each kernel issues. The
    factor against the library divides device times: at these shapes
    SDPA's event time can be its host dispatch."""
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

        def lib_fwd_fn():
            return F.scaled_dot_product_attention(qt, kt, vt)

        lib_fwd, _ = timed_ms(lib_fwd_fn)
        lib_fwd_device = sum(kernel_ms(lib_fwd_fn).values())
        lib_fn, lib_backend = sdpa_backward(q, k, v, do)
        lib_bwd, _ = timed_ms(lib_fn)
        lib_bwd_device = sum(kernel_ms(lib_fn).values())
        del lib_fn
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
            lib_dev = lib_fwd_device if fwd else lib_bwd_device
            # The split products the kernel issues on the tensor cores.
            tcf = tc_flops(kname, dtype == torch.float32) * b * h * s * s * d
            res[(kname, label)] = dict(
                shape=[b, s, h, d], dtype=str(dtype).replace("torch.", ""),
                ms=ms, device_ms=dms, plain_ms=plain_fwd if fwd else plain_bwd,
                library_ms=lib_fwd if fwd else lib_bwd,
                library_device_ms=lib_dev,
                library=("F.scaled_dot_product_attention forward" if fwd else
                         "F.scaled_dot_product_attention backward (dQ, dK "
                         f"and dV together; kernel {lib_backend})"),
                bound_ms=max(by_ops, by_bytes),
                bound_by="operations" if by_ops >= by_bytes else "bytes",
                bound_tc_ms=max(tcf / BF16_PEAK * 1e3, by_bytes),
                flops=flops, tc_flops=tcf, bytes=nbytes[kname],
                library_factor=(dms / lib_dev if fwd and dms else None))
            r = res[(kname, label)]
            print(f"[flash timing] {kname} {label} {[b, s, h, d]} "
                  f"{r['dtype']}: kernel {ms:.5f} ms (device {dms} ms), "
                  f"plain {r['plain_ms']:.5f} ms, library "
                  f"{r['library_ms']:.5f} ms (device {lib_dev:.5f} ms"
                  + (f"; {r['library_factor']:.2f}x on device time"
                     if r["library_factor"] else "")
                  + f"), bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']}; {flops / ms / 1e9:.1f} TFLOP/s "
                  f"achieved), tensor-core bound {r['bound_tc_ms']:.5f} ms "
                  f"({tcf / ms / 1e9:.1f} TFLOP/s issued) on {card}",
                  flush=True)
        del q, k, v, do, out, lse, delta
    return res


_GEMM = re.compile(r"gemm|xmma|cutlass|cublas", re.I)
# cuDNN's convolution kernels (checked before _GEMM: implicit-GEMM
# convolutions carry "gemm" in their names too).
_CONV = re.compile(r"convolve|dgrad|wgrad|fprop|winograd|cudnn", re.I)


def _device_rows(prof, steps):
    return sorted(((getattr(ev, "device_time_total", 0.0) / 1e3 / steps,
                    ev.count // steps, ev.key)
                   for ev in prof.key_averages() if is_device_work(ev)),
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


# ---- K5 and the distributed phases (16-21) -------------------------------

# name, (B, Sq, Skv, H, D), dtype, mask. The first is the block the SP main
# path gives K5 (two ranks of the 8,100-token recipe: 4,050 tokens each,
# q/k/v as views of the fused qkv); the left/right windows are a ring
# step's neighbour shards at kv_start = -S / +S.
STATS_CASES = [
    ("sp main path", (2, 4050, 4050, 3, 64), torch.bfloat16,
     {"strided": True}),
    ("f32 128", (128, 128, 128, 3, 64), torch.float32, {}),
    ("ragged", (2, 300, 200, 3, 64), torch.float32, {}),
    ("causal", (2, 257, 257, 3, 64), torch.float32, {"causal": True}),
    ("left window", (2, 300, 300, 3, 64), torch.float32,
     {"window": 100, "kv_start": -300}),
    ("right window", (2, 300, 300, 3, 64), torch.float32,
     {"window": 100, "kv_start": 300}),
    ("segment pair", (2, 300, 300, 3, 64), torch.float32,
     {"segments": True, "causal": True}),
    ("dead rows", (1, 512, 128, 1, 64), torch.float32, {"window": 64}),
    ("bf16 causal", (2, 300, 300, 3, 64), torch.bfloat16, {"causal": True}),
    ("head dim 32", (2, 257, 257, 3, 32), torch.float32, {}),
    ("head dim 128", (2, 257, 257, 3, 128), torch.float32, {"causal": True}),
]
# K5 against its plain version: the normalized acc / l in f32 at the flash
# out pin; m and l at 1e-5 relative (both are f32 results for either input
# dtype); bf16 out at one bf16 ulp of the largest |out| (1e-2 x max|plain|,
# at most 0.05), as phase 10 holds K3/K4.
STATS_OUT_TOL, STATS_REL_TOL = 5e-6, 1e-5


def stats_parity(dev) -> dict:
    """Hold K5 against ``flash_attention_stats_plain`` on the card, case by
    case; dead rows must be exactly ``m = -1e30``, ``l = 0``, ``acc = 0``.
    Returns the worst normalized-out difference per dtype."""
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(3)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for name, (b, sq, skv, h, d), dtype, mask in STATS_CASES:
        kw = {k: v for k, v in mask.items() if k not in ("strided",
                                                         "segments")}
        if mask.get("strided"):
            qkv = torch.randn(b, sq, h, 3, d, device=dev,
                              generator=gen).to(dtype)
            q, k, v = qkv.unbind(3)
        else:
            q = torch.randn(b, sq, h, d, device=dev, generator=gen).to(dtype)
            k, v = (torch.randn(b, skv, h, d, device=dev, generator=gen)
                    .to(dtype) for _ in range(2))
        if mask.get("segments"):
            kw["segment_ids"] = (_segment_ids(b, sq, gen, dev),
                                 _segment_ids(b, skv, gen, dev))
        acc, m, l = fa.flash_attention_stats(q, k, v, **kw)
        pacc, pm, pl = fa.flash_attention_stats_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        check(all(t.dtype == torch.float32 for t in (acc, m, l))
              and acc.shape == (b, sq, h, d) and m.shape == l.shape
              == (b, sq, h), f"{name}: K5 gave {acc.dtype} "
              f"{tuple(acc.shape)}, {tuple(m.shape)}")
        dead = pm <= fa.NEG_INF * 0.5
        check(torch.equal(m <= fa.NEG_INF * 0.5, dead)
              and bool(torch.all(m[dead] == fa.NEG_INF))
              and bool(torch.all(l[dead] == 0))
              and bool(torch.all(acc[dead] == 0)),
              f"{name}: K5 dead rows are not m = -1e30, l = 0, acc = 0")
        live = ~dead
        out = acc[live] / l[live][:, None]
        pout = pacc[live] / pl[live][:, None]
        out_diff = (out - pout).abs().max().item() if out.numel() else 0.0
        m_rel = ((m[live] - pm[live]).abs()
                 / pm[live].abs().clamp_min(1.0)).max().item() \
            if out.numel() else 0.0
        l_rel = ((l[live] - pl[live]).abs() / pl[live]).max().item() \
            if out.numel() else 0.0
        dt = "float32" if dtype == torch.float32 else "bfloat16"
        tol = STATS_OUT_TOL if dtype == torch.float32 else min(
            BF16_CAP, BF16_REL * pout.abs().max().item())
        check(out_diff <= tol and m_rel <= STATS_REL_TOL
              and l_rel <= STATS_REL_TOL,
              f"{name}: K5 acc/l max abs diff {out_diff} (gate {tol}), m "
              f"rel {m_rel}, l rel {l_rel} (gate {STATS_REL_TOL})")
        worst[dt] = max(worst[dt], out_diff)
        print(f"[stats parity] {name:12s} {dt} {(b, sq, skv, h, d)} {mask}: "
              f"acc/l max abs diff {out_diff:.3g} (gate {tol:.3g}), m rel "
              f"{m_rel:.3g}, l rel {l_rel:.3g}; {int(dead.sum())} dead rows",
              flush=True)
        del q, k, v, acc, m, l, pacc, pm, pl
    q = torch.randn(2, 128, 3, 64, device=dev, generator=gen)
    for what, args in (("float16 inputs", (q.half(),) * 3),
                       ("a key on the host", (q, q.cpu(), q))):
        try:
            fa.flash_attention_stats(*args)
        except ValueError:
            continue
        fail(f"flash_attention_stats accepted {what}")
    return worst


# K6/K7 as the backward ring calls them: bf16 q/k/v of the SP main path's
# block (views of a fused qkv), f32 gradients (``out_dtype``), on the
# diagonal block and on a window step's neighbour shards at kv_start = -S
# and +S. Both sides write f32, so the f32 gradient pin holds.
RING_BWD_CASES = [
    ("sp main path", {}),
    ("left window", {"window": 512, "kv_start": -4050}),
    ("right window", {"window": 512, "kv_start": 4050}),
]


def ring_bwd_parity(dev) -> float:
    """Hold ``flash_attention_bwd(..., out_dtype=torch.float32)`` (K6, K7)
    against ``flash_attention_bwd_plain`` on the same inputs at [2, 4050,
    3, 64] bf16, with lse and out from the block's plain partials; dQ of
    dead rows must be exactly 0. Returns the worst max abs difference."""
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa

    b, s, h, d = 2, 4050, 3, 64
    gen = torch.Generator(device=dev).manual_seed(6)
    qkv = torch.randn(b, s, h, 3, d, device=dev,
                      generator=gen).to(torch.bfloat16)
    q, k, v = qkv.unbind(3)
    do = torch.randn(b, s, h, d, device=dev,
                     generator=gen).to(torch.bfloat16)
    worst = 0.0
    for name, kw in RING_BWD_CASES:
        acc, m, l = fa.flash_attention_stats_plain(q, k, v, **kw)
        live = l > 0
        lsafe = l.clamp_min(1e-30)
        lse = torch.where(live, m + torch.log(lsafe), fa.DEAD_LSE)
        out = torch.where(live[..., None], acc / lsafe[..., None],
                          0.0).to(q.dtype)
        delta = fa.attention_delta(out, do)
        want = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                            out_dtype=torch.float32, **kw)
        before = (fa.LAUNCHES["flash_bwd_dq"], fa.LAUNCHES["flash_bwd_dkv"])
        got = fa.flash_attention_bwd(q, k, v, do, lse, delta,
                                     out_dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        check((fa.LAUNCHES["flash_bwd_dq"], fa.LAUNCHES["flash_bwd_dkv"])
              == (before[0] + 1, before[1] + 1),
              f"ring bwd {name}: K6/K7 were not launched")
        check(all(g.dtype == torch.float32 and g.shape == w.shape
                  for g, w in zip(got, want)),
              f"ring bwd {name}: K6/K7 gave "
              f"{[(g.dtype, tuple(g.shape)) for g in got]}")
        check(bool(torch.all(got[0][~live] == 0)),
              f"ring bwd {name}: K6 dQ of dead rows is not exactly 0")
        diffs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        check(max(diffs) <= FLASH_TOL["grad"],
              f"ring bwd {name}: dq/dk/dv max abs diff {diffs} > "
              f"{FLASH_TOL['grad']}")
        worst = max(worst, max(diffs))
        print(f"[ring bwd parity] {name:12s} bfloat16 -> float32 "
              f"{(b, s, h, d)} {kw}: dq/dk/dv max abs diff "
              + ", ".join(f"{x:.3g}" for x in diffs)
              + f" (gate {FLASH_TOL['grad']}; |grad| up to "
              f"{max(w.abs().max().item() for w in want):.3g}; "
              f"{int((~live).sum())} dead rows)", flush=True)
        del acc, m, l, lse, out, delta, want, got
    return worst


def stats_timing(dev, card, bytes_per_s) -> dict:
    """K5 at the SP main path's block [2, 4050, 3, 64] bf16: CUDA-event ms,
    device ms, the plain version, ``F.scaled_dot_product_attention``'s
    forward (a yardstick the port never calls; by events and by device
    time, the factor on device time), and the bound: 4·B·H·S²·D FLOPs
    over the bf16 tensor-core peak, or the bytes of q, k, v, the f32 acc
    and m, l over the memory rate, whichever is larger."""
    import torch.nn.functional as F

    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa

    b, s, h, d = 2, 4050, 3, 64
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(b, s, h, d, device=dev, generator=gen)
               .to(torch.bfloat16) for _ in range(3))

    def fn():
        return fa.flash_attention_stats(q, k, v)

    ms, reps = timed_ms(fn)
    dms = device_ms(fn, "flash_stats_kernel", reps=min(reps, 50))
    plain_ms, _ = timed_ms(lambda: fa.flash_attention_stats_plain(q, k, v))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def lib_fn():
        return F.scaled_dot_product_attention(qt, kt, vt)

    lib_ms, _ = timed_ms(lib_fn)
    lib_dev = sum(kernel_ms(lib_fn).values())
    n, rows = b * s * h * d, b * s * h
    flops = 4 * b * h * s * s * d
    tcf = tc_flops("flash_fwd_stats", False) * b * h * s * s * d
    nbytes = 3 * n * q.element_size() + 4 * n + 2 * 4 * rows
    by_ops, by_bytes = flops / BF16_PEAK * 1e3, nbytes / bytes_per_s * 1e3
    res = dict(shape=[b, s, h, d], dtype="bfloat16", ms=ms, device_ms=dms,
               plain_ms=plain_ms, library_ms=lib_ms,
               library_device_ms=lib_dev,
               library_factor=dms / lib_dev if dms else None,
               library="F.scaled_dot_product_attention forward",
               bound_ms=max(by_ops, by_bytes),
               bound_by="operations" if by_ops >= by_bytes else "bytes",
               bound_tc_ms=max(tcf / BF16_PEAK * 1e3, by_bytes),
               flops=flops, tc_flops=tcf, bytes=nbytes,
               tflops=flops / (dms or ms) / 1e9)
    print(f"[stats timing] flash_fwd_stats {[b, s, h, d]} bfloat16: kernel "
          f"{ms:.5f} ms (device {dms} ms), plain {plain_ms:.5f} ms, library "
          f"{lib_ms:.5f} ms (device {lib_dev:.5f} ms"
          + (f"; {res['library_factor']:.2f}x on device time"
             if res["library_factor"] else "")
          + f"), bound {res['bound_ms']:.5f} ms "
          f"({res['bound_by']}), tensor-core bound of the products it "
          f"issues {res['bound_tc_ms']:.5f} ms, {res['tflops']:.1f} TFLOP/s "
          f"achieved on device time, on {card}", flush=True)
    # The ring backward's K6/K7 at the same block, f32 gradients, on a card
    # of their own (phase 21 sees them beside the other rank's work).
    do = torch.randn(b, s, h, d, device=dev, generator=gen).to(q.dtype)
    acc, m, l = fn()
    lse = m + torch.log(l)
    delta = fa.attention_delta((acc / l[..., None]).to(q.dtype), do)
    bwd = (q, k, v, do, lse, delta, d ** -0.5, False, torch.float32, None,
           0, None, None)
    # SDPA's backward on the same unmasked block (bf16 gradients) as the
    # library time of K6 + K7 together, read A/B/B/A against the pair.
    lib_fn, lib_backend = sdpa_backward(q, k, v, do)
    plain_bwd, _ = timed_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, do, lse, delta, out_dtype=torch.float32))
    launches = {"flash_bwd_dq": lambda: fa._dq_launch(*bwd),
                "flash_bwd_dkv": lambda: fa._dkv_launch(*bwd)}

    def pair():
        return {name: timed_ms(fn) for name, fn in launches.items()}

    def lib_read():
        return timed_ms(lib_fn)[0], sum(kernel_ms(lib_fn).values())

    lib_a = [lib_read()]
    reads = [pair(), pair()]
    lib_a.append(lib_read())
    del lib_fn
    # SDPA's backward at this block can be bound by its host dispatch
    # (autograd), so the factor divides K6 + K7's event time (they are
    # bound by the card) by SDPA's device time; its event times are kept
    # beside it.
    factors = [sum(r[0] for r in read.values()) / a[1]
               for read, a in zip(reads, lib_a)]
    lib_bwd = sum(a[0] for a in lib_a) / 2
    lib_dev = sum(a[1] for a in lib_a) / 2
    # K6 reads q, k, v, dO (bf16), lse and delta (f32) and writes dQ; K7
    # reads the same and writes dK and dV; the gradients are f32.
    grad_bytes = {"flash_bwd_dq": 4 * n, "flash_bwd_dkv": 8 * n}
    res["ring_bwd_ms"] = {}
    for name, needle in (("flash_bwd_dq", "flash_dq_kernel"),
                         ("flash_bwd_dkv", "flash_dkv_kernel")):
        kms = sum(read[name][0] for read in reads) / 2
        kflops = FLASH_FLOPS[name] * b * h * s * s * d
        tcf = tc_flops(name, False, True) * b * h * s * s * d
        kbytes = 4 * n * q.element_size() + 8 * rows + grad_bytes[name]
        by_ops, by_bytes = kflops / BF16_PEAK * 1e3, kbytes / bytes_per_s * 1e3
        res["ring_bwd_ms"][name] = dict(
            ms=kms, ms_reads=[read[name][0] for read in reads],
            device_ms=device_ms(launches[name], needle,
                                reps=min(reads[0][name][1], 50)),
            bound_ms=max(by_ops, by_bytes),
            bound_by="operations" if by_ops >= by_bytes else "bytes",
            bound_tc_ms=max(tcf / BF16_PEAK * 1e3, by_bytes),
            flops=kflops, tc_flops=tcf, bytes=kbytes,
            tflops=kflops / kms / 1e9, plain_ms=plain_bwd,
            library_ms=lib_bwd, library_ms_reads=[a[0] for a in lib_a],
            library_device_ms=lib_dev,
            library_device_ms_reads=[a[1] for a in lib_a],
            library="F.scaled_dot_product_attention backward (dQ, dK and "
                    f"dV together, bf16 gradients; kernel {lib_backend})")
    res["ring_bwd_factor"] = factors
    pair_ms = sum(r["ms"] for r in res["ring_bwd_ms"].values())
    print(f"[stats timing] the ring backward's K6/K7 at {[b, s, h, d]} "
          f"bfloat16 -> float32 (on a card alone): "
          + "; ".join(f"{k} {r['ms']:.5f} ms (reads {r['ms_reads'][0]:.5f}, "
                      f"{r['ms_reads'][1]:.5f}; device {r['device_ms']} ms), "
                      f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
                      f"tensor-core bound {r['bound_tc_ms']:.5f} ms, "
                      f"{r['tflops']:.1f} TFLOP/s"
                      for k, r in res["ring_bwd_ms"].items())
          + f"; K6 + K7 {pair_ms:.5f} ms against SDPA's backward "
          f"{lib_dev:.5f} ms of device time (reads A/B/B/A "
          f"{lib_a[0][1]:.5f}, {lib_a[1][1]:.5f}; by CUDA events "
          f"{lib_a[0][0]:.5f}, {lib_a[1][0]:.5f}; kernel {lib_backend}): "
          f"{sum(factors) / 2:.2f}x ({min(factors):.2f}-{max(factors):.2f}"
          f"x), and the plain backward's {plain_bwd:.5f} ms on {card}",
          flush=True)
    return res


def _free_ports(n):
    import socket
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def spawn_ranks(label: str, job: dict, world: int = 2,
                timeout_s: float = 600.0) -> list:
    """Run ``job`` on ``world`` rank processes (this script with
    ``--rank``), each logging to ``OUT/ranks/<label>.rank<r>.log``; fails
    unless every rank exits 0 in time. Returns the ranks' result dicts."""
    rank_dir = os.path.join(OUT, "ranks")
    os.makedirs(rank_dir, exist_ok=True)
    job = dict(job, out=os.path.join(rank_dir, f"{label}.rank{{rank}}.json"))
    job_path = os.path.join(rank_dir, f"{label}.job.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(rank_dir, f"{label}.rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--job", job_path], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    rcs = [p.returncode for p in procs]
    if any(rc != 0 for rc in rcs):
        for r in range(world):
            with open(os.path.join(rank_dir, f"{label}.rank{r}.log")) as f:
                tail = f.read()[-3000:]
            print(f"[{label}] rank {r} exit {rcs[r]}; log tail:\n{tail}",
                  file=sys.stderr)
        fail(f"{label}: ranks exited {rcs}")
    results = []
    for r in range(world):
        with open(job["out"].format(rank=r)) as f:
            results.append(json.load(f))
    return results


def rank_log(label: str, rank: int = 0):
    with open(os.path.join(OUT, "ranks", f"{label}.rank{rank}.log")) as f:
        return f.read().splitlines()


def _params_digest(params) -> str:
    import hashlib
    h = hashlib.sha256()
    for name in sorted(params):
        h.update(name.encode())
        h.update(params[name].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _rank_cli(rank: int, job: dict) -> dict:
    """``cli.main.main`` as this rank; the trainer's final state is kept
    for the parameter digest."""
    from dml_cnn_cifar10_tpu_torch.cli.main import main
    from dml_cnn_cifar10_tpu_torch.train import loop

    fit, kept = loop.Trainer.fit, {}

    def fit_and_keep(self, *args, **kwargs):
        kept["result"] = fit(self, *args, **kwargs)
        return kept["result"]

    loop.Trainer.fit = fit_and_keep
    rc = main(job["argv"] + ["--task_index", str(rank)])
    res = {"rc": rc}
    if "result" in kept:
        res["digest"] = _params_digest(kept["result"].state.params)
    return res


# name, global [B, S, H, D], dtype, mask: the 2-rank ring op against the
# one-rank flash_attention of the full sequence (K4 forward, K6/K7
# backward). The last is the SP main path's own shape.
RING_OP_CASES = [
    ("full", (2, 2048, 3, 64), "float32", {}),
    ("causal", (2, 2048, 3, 64), "float32", {"causal": True}),
    ("window", (2, 2048, 3, 64), "float32", {"window": 512}),
    ("long context", (2, 8100, 3, 64), "bfloat16", {}),
]
# The pins of tests/test_ring_attention.py in f32; bf16 as phase 10's.
RING_OP_TOL = {"out": 2e-5, "grad": 5e-5}


def _rank_ring(rank: int, job: dict) -> dict:
    """The 2-rank ring op on the card against the full-sequence flash
    attention; returns the max abs differences and reference scales of
    this rank's shard."""
    import torch.distributed as dist

    from dml_cnn_cifar10_tpu_torch.config import ParallelConfig
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import multihost
    from dml_cnn_cifar10_tpu_torch.parallel import ring_attention as ring

    par = ParallelConfig(seq_axis=2, coordinator_address=job["address"],
                         num_processes=2, process_id=rank)
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    multihost.initialize(par, job["backend"], dev)
    mesh = mesh_lib.build_mesh(par)
    gen = torch.Generator(device=dev).manual_seed(5)
    res = {}
    for name, (b, s, h, d), dtype, kw in RING_OP_CASES:
        q, k, v, do = (torch.randn(b, s, h, d, device=dev, generator=gen)
                       .to(getattr(torch, dtype)) for _ in range(4))
        full = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = fa.flash_attention(*full, **kw)
        ref_g = torch.autograd.grad(ref, full, do)
        mine = [ring.seq_shard(t, mesh).detach().clone().requires_grad_()
                for t in (q, k, v)]
        out = ring.ring_attention_local(*mine, mesh, **kw)
        got_g = torch.autograd.grad(out, mine, ring.seq_shard(do, mesh))
        torch.cuda.synchronize()
        res[name] = {}
        for what, g, w in zip(("out", "dq", "dk", "dv"), (out, *got_g),
                              (ref, *ref_g)):
            w = ring.seq_shard(w, mesh).float()
            res[name][what] = [(g.float() - w).abs().max().item(),
                               w.abs().max().item()]
        del q, k, v, do, full, ref, ref_g, mine, out, got_g
    mesh.barrier()
    dist.destroy_process_group()
    return res


FLASH_GROUPS = {"K4 flash_lse_kernel": "flash_lse_kernel",
                "K5 flash_stats_kernel": "flash_stats_kernel",
                "K6 flash_dq_kernel": "flash_dq_kernel",
                "K7 flash_dkv_kernel": "flash_dkv_kernel"}
# Work of the ring hops and the gradient/pool all-reduces: NCCL's kernels,
# or on gloo the copies through host memory and gloo's own events.
_COMM = re.compile(r"nccl|gloo|Memcpy DtoH|Memcpy HtoD", re.I)


def _union_ms(spans) -> float:
    """Length of the union of ``(start, end)`` intervals in µs, as ms."""
    total, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def device_timeline(prof, steps: int) -> dict:
    """Per-step device time of this process from the trace's timeline
    (torch.profiler's device events with their start and end): the union
    of the intervals of its compute kernels over every stream, the union
    of its communication work (``_COMM``), and the time both ran at once.
    A sum of kernel times overcounts where streams overlap — NCCL's
    kernels spin on their own stream until the peer arrives — the union
    does not. Also the summed time of K5, K6 and K7."""

    compute, comm = [], []
    groups = {g: 0.0 for g in FLASH_GROUPS}
    for ev in prof.events():
        if not is_device_work(ev):
            continue
        span = (ev.time_range.start, ev.time_range.end)
        (comm if _COMM.search(ev.name) else compute).append(span)
        for group, needle in FLASH_GROUPS.items():
            if needle in ev.name:
                groups[group] += (span[1] - span[0]) / 1e3 / steps
    check(bool(compute), "the profile traced no device kernel")
    c_ms, n_ms = _union_ms(compute) / steps, _union_ms(comm) / steps
    any_ms = _union_ms(compute + comm) / steps
    return {"compute_ms": c_ms, "comm_ms": n_ms,
            "overlap_ms": c_ms + n_ms - any_ms, "device_any_ms": any_ms,
            "flash_ms": groups}


def _rank_profile(rank: int, job: dict) -> dict:
    """One SP training step of this rank: its host-clock time over a few
    steps on a batch already on the card, and its device timeline
    (``device_timeline``): compute busy time, the hops and all-reduces,
    their overlap, and K5/K6/K7."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.data import pipeline as pipe
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer

    steps = job["steps"]
    cfg = config_from_args(build_parser().parse_args(
        job["argv"] + ["--task_index", str(rank)]))
    trainer = Trainer(cfg, task_index=rank)
    state = trainer.init_or_restore()
    it = trainer.input_pipeline(train=True, seed=cfg.seed)
    images, labels = pipe.to_device(next(it), trainer.device)
    trainer.train_step(state, images, labels)
    torch.cuda.synchronize()
    trainer.mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(state, images, labels)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    trainer.mesh.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step(state, images, labels)
        torch.cuda.synchronize()
    rows = _device_rows(prof, steps)
    timeline = device_timeline(prof, steps)
    trainer.mesh.barrier()
    dist.destroy_process_group()
    return {"step_ms": step_ms, **timeline,
            "compute_share": timeline["compute_ms"] / step_ms,
            "kernels": [{"ms_per_step": ms, "per_step": n, "name": name}
                        for ms, n, name in rows[:25]]}


def check_ring_op(ring_res, backend: str) -> None:
    """Hold the ranks' ring-op differences to their pins."""
    for name, _, dtype, kw in RING_OP_CASES:
        for what in ("out", "dq", "dk", "dv"):
            diff = max(r[name][what][0] for r in ring_res)
            scale = max(r[name][what][1] for r in ring_res)
            kind_ = "out" if what == "out" else "grad"
            tol = RING_OP_TOL[kind_] if dtype == "float32" else min(
                BF16_CAP, BF16_REL * scale)
            check(diff <= tol, f"ring op {name}: {what} max abs diff "
                               f"{diff} > {tol}")
        print(f"[ring op] {name} {dtype} {kw} ({backend}): max abs diff vs "
              f"the full sequence's flash attention " + ", ".join(
                  f"{w} {max(r[name][w][0] for r in ring_res):.3g}"
                  for w in ("out", "dq", "dk", "dv")), flush=True)


def sp_launches(steps: int, fwd_only: int) -> dict:
    """Per-rank launches of ``steps`` SP steps at seq 2 with remat: K5 = 12
    blocks x 2 ring steps x 2, K6 = K7 = 12 x 2; K5 = 24 for each
    forward-only batch; K3 = K4 = K1 = K2 = 0."""
    return {"flash_fwd": 0, "flash_fwd_lse": 0,
            "flash_fwd_stats": steps * 48 + fwd_only * 24,
            "flash_bwd_dq": steps * 24, "flash_bwd_dkv": steps * 24,
            "sgd_update_plain": 0, "sgd_update_momentum": 0}


# Every logged SP loss against the same recipe and batches without the
# ring. Measured on H100s (PERF.md): at most 1.7e-4 apart at step 5
# (bf16 sums in another order) and 2.4e-6 at step 10, so 1e-3 leaves room
# for rounding while a wrong softmax weight or gradient sum lands far
# outside it.
SP_LOSS_TOL = 1e-3


def long_args(work: str) -> list:
    """The long-context recipe (``BASELINE.md:523``: 368/360 images, 8,100
    tokens, mean pool, remat, bf16, AdamW) without its batch size."""
    return ["--model", "vit_tiny", "--dataset", "synthetic",
            "--data_dir", os.path.join(work, "data_long"),
            "--image_size", "368", "--crop_size", "360", "--pool", "mean",
            "--remat", "true", "--compute_dtype", "bfloat16",
            "--optimizer", "adamw", "--learning_rate", "3e-4",
            "--synthetic_train_records", "64", "--fidelity", "fixed",
            "--output_every", "5", "--eval_every", "1000",
            "--checkpoint_every", "1000", "--peak_tflops", BF16_PEAK_TFLOPS]


def cnn_args(work: str) -> list:
    """The CNN main path's recipe: batch 128 on 50,000 synthetic records."""
    return ["--dataset", "synthetic", "--data_dir",
            os.path.join(work, "data"), "--synthetic_train_records",
            "50000", "--fidelity", "fixed", "--learning_rate", "0.02",
            "--batch_size", "128", "--peak_tflops", F32_PEAK_TFLOPS]


def train_log(path) -> list:
    return [(r["step"], r["loss"], r["images_per_sec"])
            for r in records(path) if r["kind"] == "train"]


def dist_phases(backend: str, card: str, worlds=(2,),
                one_rank_jsonl=None) -> dict:
    """Phases 18-21 over ``backend``, each rank a process of its own: the
    2-rank ring op; for each world in ``worlds``, the SP long-context
    recipe on ``world`` ranks (data world/2 x seq 2, 2 images a data row)
    against the same batches without the ring — one rank
    (``one_rank_jsonl``, or run here) or the world/2 data ranks alone —
    then, on 2 ranks, a resume to step 15 and ``--mode eval``; the DP CNN
    on each world; the 2-rank SP profile. Returns the numbers."""
    count = torch.cuda.device_count()

    def dist_args(world):
        return _dist_args(world, backend)

    res = {"card": card, "backend": backend, "cards": count}
    # ---- 18. the 2-rank ring op ------------------------------------------
    ring_res = spawn_ranks(f"ring_op_{backend}", {
        "kind": "ring", "backend": backend,
        "address": f"localhost:{_free_ports(1)[0]}"}, timeout_s=300)
    check_ring_op(ring_res, backend)
    res["ring_op"] = ring_res

    # ---- 19. SP long context: 4,050 tokens a rank ------------------------
    long = long_args(WORK)
    for world in worlds:
        batch = world
        ref_jsonl = one_rank_jsonl if world == 2 else None
        if ref_jsonl is None:
            ref_jsonl = os.path.join(WORK, f"ref{world}.jsonl")
            ref_args = long + ["--batch_size", str(batch), "--total_steps",
                               str(LONG_STEPS), "--log_dir",
                               os.path.join(WORK, f"logs_ref{world}"),
                               "--metrics_jsonl", ref_jsonl]
            if world == 2:
                run_cli(ref_args)
            else:
                spawn_ranks(f"dp_vit{world // 2}_{backend}", {
                    "kind": "cli", "argv": ref_args + dist_args(world // 2)},
                    world=world // 2)
        sp_log = os.path.join(WORK, f"logs_sp{world}")
        sp_jsonl = os.path.join(WORK, f"vit_sp{world}.jsonl")
        t0 = time.perf_counter()
        sp = spawn_ranks(f"sp{world}_{backend}", {"kind": "cli", "argv": long
                         + ["--batch_size", str(batch), "--seq_axis", "2",
                            "--total_steps", str(LONG_STEPS), "--log_dir",
                            sp_log, "--metrics_jsonl", sp_jsonl]
                         + dist_args(world)}, world=world)
        wall = time.perf_counter() - t0
        # The fresh-batch train accuracy every 5 steps is a forward-only
        # batch.
        want = sp_launches(LONG_STEPS, LONG_STEPS // 5)
        check(all(r["launches"] == want for r in sp),
              f"SP {world} ranks launched {[r['launches'] for r in sp]}, "
              f"want {want}")
        check(len({r["digest"] for r in sp}) == 1,
              f"SP {world} ranks ended with different parameters")
        got, ref = train_log(sp_jsonl), train_log(ref_jsonl)
        gaps = [abs(g[1] - r[1]) for g, r in zip(got, ref)]
        check(len(got) == len(ref) == LONG_STEPS // 5
              and [g[0] for g in got] == [r[0] for r in ref]
              and all(math.isfinite(g[1]) for g in got)
              and max(gaps) <= SP_LOSS_TOL,
              f"SP {world} ranks (step, loss, images/s) {got}; without the "
              f"ring {ref}; gaps {gaps} (gate {SP_LOSS_TOL})")
        res[f"sp{world}"] = {
            "batch": batch, "train": got, "reference": ref,
            "loss_gaps": gaps, "step_ms": batch / got[-1][2] * 1e3,
            "tokens_per_s": got[-1][2] * 8100, "wall_s": wall,
            "launches": sp[0]["launches"]}
        shutil.copy(sp_jsonl, OUT)
        print(f"[sp train] {world} ranks (data {world // 2} x seq 2, "
              f"{backend}), batch {batch} x 8,100 tokens: (step, loss, "
              f"images/s) {got}; without the ring ({max(1, world // 2)} "
              f"rank(s)) {ref}; loss gaps {gaps} (gate {SP_LOSS_TOL}); "
              f"{res[f'sp{world}']['step_ms']:.1f} ms/step in steps 6-10; "
              f"launches per rank {sp[0]['launches']}, equal parameters, on "
              f"{min(count, world)} x {card}", flush=True)
        if world != 2:
            continue
        # resume to 15, then --mode eval, both over the 2 ranks
        label = f"sp_resume_{backend}"
        resume = spawn_ranks(label, {"kind": "cli", "argv": long + [
            "--batch_size", "2", "--seq_axis", "2", "--log_dir", sp_log,
            "--total_steps", str(LONG_STEPS + 5)] + dist_args(2)})
        for r in resume:
            check(r["launches"]["flash_fwd_stats"] == 5 * 48 + 24
                  and r["launches"]["flash_bwd_dq"] == 5 * 24,
                  f"SP resume ran {r['launches']}, want 5 steps from step "
                  f"{LONG_STEPS}")
        steps = [int(m[1]) for m in map(STEP_LINE.match, rank_log(label))
                 if m]
        check(steps == [LONG_STEPS + 5], f"SP resume printed steps {steps}")
        # The full test split (512 records) at 8 images a batch.
        label = f"sp_eval_{backend}"
        ev = spawn_ranks(label, {"kind": "cli", "argv": long + [
            "--seq_axis", "2", "--log_dir", sp_log, "--batch_size", "8",
            "--mode", "eval"] + dist_args(2)})
        eval_lines = []
        for r in range(2):
            lines = rank_log(label, r)
            check(any(f"eval at step {LONG_STEPS + 5}" in l for l in lines),
                  f"SP eval rank {r} did not restore step {LONG_STEPS + 5}")
            eval_lines.append([m[1] for m in map(EVAL_LINE.match, lines)
                               if m])
        check(len(eval_lines[0]) == 1 and eval_lines[0] == eval_lines[1],
              f"SP --mode eval printed {eval_lines}")
        check(ev[0]["launches"]["flash_fwd_stats"] == 64 * 24,
              f"SP eval launched {ev[0]['launches']} (64 batches of 8)")
        res["sp_eval_accuracy"] = eval_lines[0][0]
        print(f"[sp resume] continued {LONG_STEPS} -> {LONG_STEPS + 5}; "
              f"--mode eval over 2 ranks: {eval_lines[0][0]}% on both",
              flush=True)

    # ---- 20. data-parallel CNN: 128 images over the world ----------------
    for world in worlds:
        dp_jsonl = os.path.join(WORK, f"cnn_dp{world}.jsonl")
        dp = spawn_ranks(f"dp{world}_{backend}", {"kind": "cli", "argv":
                         cnn_args(WORK) + [
            "--log_dir", os.path.join(WORK, f"logs_dp{world}"),
            "--total_steps", str(DP_STEPS), "--eval_every", "1000",
            "--output_every", "50", "--checkpoint_every", "1000",
            "--metrics_jsonl", dp_jsonl] + dist_args(world)}, world=world)
        for r in dp:
            check(r["launches"]["sgd_update_plain"] == DP_STEPS
                  and r["launches"]["sgd_update_momentum"] == 0,
                  f"DP {world} ranks launched {[r['launches'] for r in dp]}, "
                  f"want K1 = {DP_STEPS} (one a step) each")
        check(len({r["digest"] for r in dp}) == 1,
              f"DP {world} ranks ended with different parameters")
        losses = [l for _, l, _ in train_log(dp_jsonl)]
        check(losses and all(math.isfinite(l) for l in losses),
              f"DP {world} ranks losses {losses}")
        ips = next(r for r in records(dp_jsonl)
                   if r["kind"] == "done")["images_per_sec"]
        res[f"dp{world}"] = {"losses": losses, "images_per_s": ips,
                             "step_ms": 128 / ips * 1e3,
                             "launches": dp[0]["launches"]}
        shutil.copy(dp_jsonl, OUT)
        print(f"[dp cnn] {DP_STEPS} steps, {world} ranks x {128 // world} "
              f"images ({backend}): loss {losses}, {ips:.1f} images/s = "
              f"{128 / ips * 1e3:.3f} ms/step over the run; K1 "
              f"{dp[0]['launches']['sgd_update_plain']} per rank, equal "
              f"parameters, on {min(count, world)} x {card}", flush=True)

    # ---- 21. where an SP step's time goes --------------------------------
    prof = spawn_ranks(f"sp_profile_{backend}", {
        "kind": "profile", "steps": 2, "argv": long + [
            "--batch_size", "2", "--seq_axis", "2", "--log_dir",
            os.path.join(WORK, "logs_sp_profile")] + dist_args(2)})
    res["sp_profile"] = prof
    for r, p in enumerate(prof):
        print(f"[sp profile] rank {r} ({backend}): {p['step_ms']:.2f} "
              f"ms/step (host clock, batch on the card); device timeline a "
              f"step: compute {p['compute_ms']:.2f} ms "
              f"({100 * p['compute_share']:.1f}% of the step), hops and "
              f"all-reduces {p['comm_ms']:.2f} ms, of which "
              f"{p['overlap_ms']:.2f} ms beside compute; "
              + ", ".join(f"{k} {v:.2f}" for k, v in p["flash_ms"].items())
              + f"; on {card}", flush=True)
        for k in p["kernels"][:8]:
            print(f"[sp profile]   rank {r} {k['ms_per_step']:.4f} ms/step "
                  f"x{k['per_step']} {k['name'][:100]}")
    return res


# ---- serving: export, K3 through its operator, graphs, HTTP (22-25) ------

SERVE_BUCKETS = (1, 8, 32, 128)
SERVE_CONCURRENCY = (1, 32, 128)
SERVE_RUN_S = 2.0
# Graph replay against the eager forward, and the artifact against the
# live engine: the same kernels on the same inputs, held to 1e-5 of the
# largest logit (a capture that read the wrong buffer or weights misses
# it by orders of magnitude).
SERVE_REL = 1e-5
# A response's logits against its version's forward at another batch
# size: cuBLAS may pick another kernel for another M, so rows can differ
# in their last bits; two checkpoints 100 steps apart differ by far more.
SWAP_TOL = 1e-4
# Check-set images whose two largest direct logits are closer than this
# (relative) are left out of the class check: their argmax may flip with
# the batch a request lands in. Their count is printed.
MARGIN = 1e-4
# K3 at the serving shapes, as the ViT-Ti gives them: [b, 257, 3, 64]
# f32, q/k/v views of one fused qkv.
SERVE_K3_TIMED = (1, 128)


def _rel(a, b) -> float:
    import numpy as np
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def _host_ms(fn, reps) -> float:
    """Median host ms of ``fn()`` (which ends in a device read) over
    ``reps`` calls after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _copies(fn, reps=10, traces=5) -> dict:
    """Host-to-device and device-to-host copies of ``reps`` calls of
    ``fn()``, by the profiler's memcpy events. A trace drops some of them
    (seen on the card: 7 to 9 of 10, the first ones), so a count bounds
    the copies from below: the caller checks the upper bound, which a
    weight copy (one a leaf, 10 or more a batch) would break. The calls
    start 50 ms into the trace, in case the tracer starts late. A trace
    that holds no copy at all (seen on the card in 1 to 2 of 16 traces
    of a call, both directions empty) recorded nothing: it is traced
    again, at most ``traces`` times in all, and ``traces`` in the result
    says how many it took. A function that really copies nothing fails
    every trace the same."""
    from torch.profiler import ProfilerActivity, profile
    for n in range(1, traces + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {"HtoD": 0, "DtoH": 0}
        for ev in prof.key_averages():
            for kind in out:
                if f"Memcpy {kind}" in ev.key:
                    out[kind] += ev.count
        if out["HtoD"] + out["DtoH"]:
            break
    return {**out, "traces": n}


def _batch_profile(eng, x, reps=20) -> dict:
    """Where a served batch's time goes: the host ms of one
    ``forward_timed`` (input copy, replay, logits back) beside the
    device's busy ms a batch by kernel group, from ``reps`` traced
    batches."""
    from torch.profiler import ProfilerActivity, profile

    eng.forward_timed(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        eng.forward_timed(x)
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            eng.forward_timed(x)
        torch.cuda.synchronize()
    groups = dict.fromkeys(("flash (K3)", "convolutions (cuDNN)",
                            "GEMMs (cuBLAS)", "copies", "rest"), 0.0)
    for ms, _, name in _device_rows(prof, reps):
        groups["flash (K3)" if "flash_out_kernel" in name
               else "copies" if "Memcpy" in name
               else "convolutions (cuDNN)" if _CONV.search(name)
               else "GEMMs (cuBLAS)" if _GEMM.search(name)
               else "rest"] += ms
    busy = sum(groups.values())
    return {"host_ms": host_ms, "device_busy_ms": busy,
            "device_busy_share": busy / host_ms, "groups_ms": groups}


def serve_k3(dev, card, bytes_per_s, f32_ops) -> dict:
    """K3 through the registered operator at the four serving shapes
    against its plain version (f32 out pin 5e-6), then timed at b = 1 and
    128: CUDA events, device time, the plain version, SDPA (a yardstick
    the port never calls) and the bound."""
    import torch.nn.functional as F

    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(3)
    worst, res = 0.0, {}
    fa.reset_launches()
    for b in SERVE_BUCKETS:
        q, k, v = torch.randn(b, 257, 3, 3, 64, device=dev,
                              generator=gen).unbind(3)
        with torch.no_grad():
            got = torch.ops.dml_torch.flash_attention_out(
                q, k, v, None, None, 64 ** -0.5, False, None)
            via = fa.flash_attention(q, k, v)
            want = fa.flash_attention_plain(q, k, v)[0]
        torch.cuda.synchronize()
        diff = (got - want).abs().max().item()
        check(torch.equal(got, via), f"K3 at b={b}: flash_attention and "
              "the operator disagree")
        check(diff <= FLASH_TOL["out"],
              f"K3 at [{b}, 257, 3, 64] through the operator: max abs diff "
              f"{diff} > {FLASH_TOL['out']}")
        worst = max(worst, diff)
        print(f"[serve k3] [{b}, 257, 3, 64] f32 (views of a fused qkv) "
              f"through dml_torch::flash_attention_out: max abs diff "
              f"{diff:.3g} vs the plain version", flush=True)
        if b not in SERVE_K3_TIMED:
            continue

        def fn():
            return torch.ops.dml_torch.flash_attention_out(
                q, k, v, None, None, 64 ** -0.5, False, None)

        ms, reps = timed_ms(fn)
        dms = device_ms(fn, "flash_out_kernel", reps=min(reps, 50))
        plain_ms, _ = timed_ms(lambda: fa.flash_attention_plain(q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def lib_fn():
            return F.scaled_dot_product_attention(qt, kt, vt)

        lib_ms, _ = timed_ms(lib_fn)
        lib_dev = sum(kernel_ms(lib_fn).values())
        flops = FLASH_FLOPS["flash_fwd"] * b * 3 * 257 * 257 * 64
        nbytes = 4 * b * 257 * 3 * 64 * 4
        by_ops, by_bytes = flops / f32_ops * 1e3, nbytes / bytes_per_s * 1e3
        # The split-bf16 products K3 issues on the tensor cores.
        tcf = tc_flops("flash_fwd", True) * b * 3 * 257 * 257 * 64
        res[b] = dict(shape=[b, 257, 3, 64], dtype="float32", ms=ms,
                      device_ms=dms, plain_ms=plain_ms, library_ms=lib_ms,
                      library_device_ms=lib_dev,
                      library="F.scaled_dot_product_attention forward",
                      bound_ms=max(by_ops, by_bytes),
                      bound_by="operations" if by_ops >= by_bytes
                      else "bytes",
                      bound_tc_ms=max(tcf / BF16_PEAK * 1e3, by_bytes),
                      flops=flops, tc_flops=tcf, bytes=nbytes,
                      blocks=b * 3 * math.ceil(257 / 64))
        print(f"[serve k3] timed [{b}, 257, 3, 64] f32: kernel {ms:.5f} ms "
              f"(device {dms} ms), plain {plain_ms:.5f} ms, SDPA "
              f"{lib_ms:.5f} ms (device {lib_dev:.5f} ms), bound "
              f"{res[b]['bound_ms']:.5f} ms ({res[b]['bound_by']}), "
              f"tensor-core bound {res[b]['bound_tc_ms']:.5f} ms of the "
              f"split products it issues, on {card}", flush=True)
    return {"worst": worst, "timed": res}


def _check_set(engine, images, path) -> int:
    """Write the ``--check_labels`` npz: the images whose direct forward
    (the engine's eager forward, in batches of 128) has a clear argmax,
    labelled with it. Returns how many were left out."""
    import numpy as np
    logits = np.concatenate([engine.forward_eager(images[i:i + 128])
                             for i in range(0, len(images), 128)])
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > MARGIN * np.maximum(
        1.0, np.abs(top2[:, 1]))
    np.savez(path, images=images[clear], labels=logits[clear].argmax(1))
    return int((~clear).sum())


def _serve_thread(args, engine=None):
    """``--mode serve`` of ``args`` in a thread with ready and stop events
    (``main_serve`` with the CLI's config; ``engine`` serves a caller's
    engine): ``(thread, stop_event, url, cfg, rc)`` once it is ready."""
    import threading

    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.serve.server import main_serve

    port = _free_ports(1)[0]
    cfg = config_from_args(build_parser().parse_args(
        args + ["--mode", "serve", "--serve_port", str(port)]))
    print("$ python -m dml_cnn_cifar10_tpu_torch " + " ".join(args)
          + f" --mode serve --serve_port {port}", flush=True)
    ready, stop, rc = threading.Event(), threading.Event(), {}

    def run():
        rc["rc"] = main_serve(cfg, ready_event=ready, stop_event=stop,
                              engine=engine)

    t = threading.Thread(target=run, name="serve-main", daemon=True)
    t.start()
    while not ready.wait(1.0):
        check(t.is_alive(), f"--mode serve of {args} died during warm-up")
    return t, stop, f"http://127.0.0.1:{port}", cfg, rc


def _stop_serve(t, stop, rc, what) -> None:
    stop.set()
    t.join(120)
    check(not t.is_alive() and rc.get("rc") == 0,
          f"{what}: the server did not drain and exit 0")


def _loadgen(argv, label) -> dict:
    """The port's load generator in a process of its own (its client
    threads do not share the server's interpreter lock)."""
    report = os.path.join(OUT, f"loadgen_{label}.json")
    cmd = [sys.executable, "-m", "dml_cnn_cifar10_tpu_torch.tools.loadgen",
           *argv, "--report", report]
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    check(p.returncode == 0, f"loadgen {label} exited {p.returncode}: "
          f"{p.stderr[-2000:]}")
    with open(report) as f:
        return json.load(f)


def serve_phases(card, dev, cnn_cli, vit_cli, bytes_per_s, f32_ops) -> dict:
    """Phases 22-25 on phase 6's CNN checkpoint (step 600) and phase 13's
    ViT-Ti checkpoint (step 300). ``cnn_cli`` and ``vit_cli`` are their
    CLI arguments, ``--log_dir`` included."""
    import numpy as np

    from dml_cnn_cifar10_tpu_torch import export as export_lib
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.data import test_files
    from dml_cnn_cifar10_tpu_torch.data.pipeline import _load_split
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.serve.engine import ServingEngine
    from dml_cnn_cifar10_tpu_torch.tools import loadgen

    models = {"cnn": {"cli": cnn_cli, "step": RESUME_STEPS, "k3": 0},
              "vit": {"cli": vit_cli, "step": VIT_RESUME_STEPS, "k3": 12}}
    out = {"card": card, "buckets": list(SERVE_BUCKETS)}

    # ---- 22. export: --mode export, one artifact serves every bucket ----
    for label, m in models.items():
        cfg = config_from_args(build_parser().parse_args(m["cli"]))
        m["cfg"] = cfg
        t0 = time.perf_counter()
        lines = run_cli(m["cli"] + ["--mode", "export"])
        m["export_s"] = time.perf_counter() - t0
        m["path"] = os.path.join(cfg.log_dir, export_lib.ARTIFACT_NAME)
        check(any(f"exported step-{m['step']} forward" in l for l in lines),
              f"{label}: --mode export did not export step {m['step']}")
        images, _ = _load_split(test_files(cfg.data), cfg.data)
        m["images"] = np.ascontiguousarray(images)
        art = ServingEngine.from_artifact(m["path"], dev)
        model, params, step = export_lib.restore_serving_params(cfg, dev)
        check(step == m["step"], f"{label}: restored step {step}")
        live = ServingEngine.from_params(model, cfg.data, params, dev,
                                         version=str(step))
        graph = export_lib.load_program(m["path"]).graph
        n_ops = sum(n.target == torch.ops.dml_torch.flash_attention_out.default
                    for n in graph.nodes)
        check(n_ops == m["k3"], f"{label}: the artifact's graph holds "
              f"{n_ops} flash operator nodes, want {m['k3']}")
        worst = 0.0
        for b in SERVE_BUCKETS:
            x = m["images"][:b]
            got, want = art.forward_eager(x), live.forward_eager(x)
            check(got.shape == (b, 10) and np.isfinite(got).all(),
                  f"{label}: the artifact gave {got.shape} at b={b}")
            worst = max(worst, _rel(got, want))
        check(worst <= SERVE_REL, f"{label}: artifact vs live weights "
              f"{worst} > {SERVE_REL} of the largest logit")
        m.update(art=art, live=live, params=params)
        out[label] = {"export_s": m["export_s"], "artifact_bytes":
                      os.path.getsize(m["path"]), "flash_op_nodes": n_ops,
                      "artifact_vs_live_rel": worst}
        print(f"[serve export] {label}: step {step} -> {m['path']} "
              f"({out[label]['artifact_bytes']} bytes, {n_ops} flash "
              f"operator nodes) in {m['export_s']:.2f} s; one artifact at "
              f"b = {SERVE_BUCKETS}: within {worst:.3g} of the live "
              f"weights' forward", flush=True)

    # ---- 23. K3 through the registered operator ------------------------
    out["k3"] = serve_k3(dev, card, bytes_per_s, f32_ops)

    # ---- 24. one CUDA graph per bucket: replay against eager ------------
    for label, m in models.items():
        rows = {}
        for kind in ("art", "live"):
            eng = m[kind]
            fa.reset_launches()
            t0 = time.perf_counter()
            eng.warmup(SERVE_BUCKETS)
            warm_s = time.perf_counter() - t0
            check(sorted(eng.graphs) == sorted(SERVE_BUCKETS),
                  f"{label} {kind}: {len(eng.graphs)} graphs captured")
            check(fa.LAUNCHES["flash_fwd"] == m["k3"] * len(eng.graphs),
                  f"{label} {kind}: warm-up replays launched "
                  f"{fa.LAUNCHES['flash_fwd']} K3")
            for g in eng.graphs.values():
                check(g.launches == ({"flash_fwd": m["k3"]} if m["k3"]
                                     else {}),
                      f"{label} {kind}: a replay launches {g.launches}")
            for b in SERVE_BUCKETS:
                x = m["images"][:b]
                rep, _ = eng.forward_timed(x)
                eag = eng.forward_eager(x)
                rel = _rel(rep, eag)
                check(rel <= SERVE_REL, f"{label} {kind} b={b}: replay vs "
                      f"eager {rel} > {SERVE_REL}")
                copies = _copies(lambda: eng.forward_timed(x), reps=10)
                check(1 <= copies["HtoD"] <= 10 and copies["DtoH"] <= 10,
                      f"{label} {kind} b={b}: 10 served batches made copies "
                      f"{copies}; want at most one in (the input) and one "
                      f"out (the logits) a batch: no weight copy")
                g = eng.graphs[b]
                replay_dev = cuda_ms(g.graph.replay, reps=50, warmup=5)
                with torch.no_grad():
                    eager_dev = cuda_ms(lambda: eng._run(
                        g.static_in, eng._params), reps=20, warmup=3)
                row = dict(rel=rel, copies=copies,
                           replay_ms=_host_ms(lambda: eng.forward_timed(x),
                                              30),
                           eager_ms=_host_ms(lambda: eng.forward_eager(x),
                                             10),
                           replay_device_ms=replay_dev,
                           eager_device_ms=eager_dev)
                rows.setdefault(kind, {})[b] = row
                print(f"[serve graphs] {label} {kind} b={b}: replay vs eager "
                      f"{rel:.3g}; served batch {row['replay_ms']:.4f} ms "
                      f"(replay), {row['eager_ms']:.4f} ms (eager), input "
                      f"copy + logits included; by CUDA events "
                      f"{replay_dev:.4f} ms replay, {eager_dev:.4f} ms eager;"
                      f" copies {copies}, on {card}", flush=True)
            rows[kind + "_warmup_s"] = warm_s
        for b in (1, 128):
            prof = _batch_profile(m["art"], m["images"][:b])
            rows.setdefault("profile", {})[b] = prof
            print(f"[serve profile] {label} artifact b={b}: served batch "
                  f"{prof['host_ms']:.4f} ms on the host clock, device busy "
                  f"{prof['device_busy_ms']:.4f} ms "
                  f"({100 * prof['device_busy_share']:.1f}%): "
                  + ", ".join(f"{g} {ms:.4f}" for g, ms
                              in prof["groups_ms"].items())
                  + f"; on {card}", flush=True)
        out[label]["graphs"] = rows

    # ---- 25. --mode serve over HTTP, driven by the port's loadgen --------
    # Each model's artifact behind the server (resolve_engine finds
    # <log_dir>/model.pt2), closed loops twice each at 1, 32 and 128
    # clients: every answer's class is the direct forward's, no error but
    # 503, and the served path launched K3 12 times a replay and nothing
    # else (counts set to 0 before the server starts, read after it
    # stops: the warm-up's one replay a bucket, then one a batch).
    for label, m in models.items():
        npz = os.path.join(WORK, f"check_{label}.npz")
        left_out = _check_set(m["art"], m["images"], npz)
        fa.reset_launches()
        t, stop, url, cfg, rc = _serve_thread(
            m["cli"] + ["--metrics_jsonl",
                        os.path.join(OUT, f"serve_{label}.jsonl"),
                        "--serve_metrics_every_s", "1"])
        runs = {}
        for c in SERVE_CONCURRENCY:
            for rep in range(2):
                r = _loadgen(["--target", url, "--mode", "closed",
                              "--concurrency", str(c), "--duration_s",
                              str(SERVE_RUN_S), "--check_labels", npz],
                             f"{label}_c{c}_{rep}")
                check(r["errors"] == 0 and r["rejected"] == 0,
                      f"{label} c={c}: errors {r['error_kinds']}")
                check(r["completed"] > 0 and r.get("label_checked")
                      == r["completed"] and r["accuracy"] == 1.0,
                      f"{label} c={c}: {r.get('label_checked')} checked of "
                      f"{r['completed']}, class agreement "
                      f"{r.get('accuracy')}")
                runs.setdefault(c, []).append(
                    {k: r[k] for k in ("achieved_qps", "latency_ms",
                                       "completed", "shed", "version_mix")})
                print(f"[serve http] {label} closed loop c={c} run {rep}: "
                      f"{r['achieved_qps']} qps, p50 "
                      f"{r['latency_ms']['p50']} ms, p99 "
                      f"{r['latency_ms']['p99']} ms, {r['completed']} "
                      f"completed, {r['shed']} shed, every class the direct "
                      f"forward's; on {card}", flush=True)
        _stop_serve(t, stop, rc, f"{label} serve")
        done = [r for r in records(cfg.metrics_jsonl)
                if r["kind"] == "serve_done"][-1]
        launched = dict(fa.LAUNCHES)
        want = m["k3"] * (done["batches"] + len(SERVE_BUCKETS))
        check(launched["flash_fwd"] == want
              and sum(launched.values()) == want,
              f"{label} serve path launched {launched}; want K3 = "
              f"{m['k3']} x ({done['batches']} batches + "
              f"{len(SERVE_BUCKETS)} warm-up replays) and nothing else")
        out[label]["http"] = {"closed": runs, "left_out_near_ties": left_out,
                              "serve_done": done, "launches": launched}
        print(f"[serve http] {label}: {done['batches']} batches, batch fill "
              f"{done['batch_fill']}, queue wait p50 "
              f"{done['queue_wait_p50_ms']} ms, device p50 "
              f"{done['device_p50_ms']} ms; launches {launched}; "
              f"{left_out} near-tie image(s) left out of the class check",
              flush=True)

    # Past capacity: the ViT-Ti artifact at bucket 1 with a 2-deep queue
    # and a 0.5 ms deadline, an open loop at 1,500 requests/s (a bucket-1
    # replay takes over a millisecond): overload is shed (503), not
    # buffered, and nothing else fails.
    t, stop, url, _, rc = _serve_thread(
        vit_cli + ["--serve_buckets", "1", "--serve_queue_depth", "2",
                   "--serve_deadline_ms", "0.5"])
    r = _loadgen(["--target", url, "--mode", "open", "--qps", "1500",
                  "--duration_s", str(SERVE_RUN_S), "--image_size", "72"],
                 "vit_open")
    _stop_serve(t, stop, rc, "overload serve")
    check(r["shed_fraction"] > 0 and r["errors"] == 0,
          f"open loop past capacity: shed fraction {r['shed_fraction']}, "
          f"errors {r['error_kinds']}")
    out["overload"] = {k: r[k] for k in ("achieved_qps", "latency_ms",
                                         "completed", "shed",
                                         "shed_fraction")}
    print(f"[serve http] open loop at 1500/s past capacity (ViT-Ti, bucket "
          f"1, queue 2, deadline 0.5 ms): shed fraction "
          f"{r['shed_fraction']}, {r['achieved_qps']} qps served, p99 "
          f"{r['latency_ms']['p99']} ms", flush=True)
    out["swap"] = _swap_under_load(card, dev, models["cnn"])
    with open(os.path.join(OUT, "serve.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def _swap_under_load(card, dev, m) -> dict:
    """The CNN's step-500 checkpoint served live over HTTP to 32 closed-loop
    clients; a second in, the step-600 checkpoint is hot-swapped in. The
    version tags flip (every request sent after the swap returned is
    answered by 600), and each answer's logits are its version's forward
    of its image."""
    import threading
    from types import SimpleNamespace

    import numpy as np

    from dml_cnn_cifar10_tpu_torch import convert
    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt
    from dml_cnn_cifar10_tpu_torch.serve.engine import ServingEngine
    from dml_cnn_cifar10_tpu_torch.tools import loadgen

    cfg, images = m["cfg"], m["images"][:256]
    params = {}
    for step in (STEPS, RESUME_STEPS):
        with open(os.path.join(cfg.log_dir, f"ckpt_{step}.msgpack"),
                  "rb") as f:
            params[step] = convert.params_from_jax(
                ckpt.from_bytes(f.read())["params"])
    refs = {}
    for step, p in params.items():
        e = ServingEngine.from_params(_fresh_model(cfg), cfg.data, p, dev,
                                      version=str(step))
        refs[str(step)] = np.concatenate(
            [e.forward_eager(images[i:i + 128]) for i in range(0, 256, 128)])
    apart = float(np.abs(refs[str(STEPS)] - refs[str(RESUME_STEPS)]).max())
    check(apart > 100 * SWAP_TOL, f"the two checkpoints' logits are only "
          f"{apart} apart")
    engine = ServingEngine.from_params(_fresh_model(cfg), cfg.data,
                                       params[STEPS], dev,
                                       version=str(STEPS))
    t, stop, url, scfg, rc = _serve_thread(
        m["cli"] + ["--metrics_jsonl", os.path.join(OUT, "serve_swap.jsonl")],
        engine=engine)
    client = loadgen.HttpClient(url)
    answers, lock = [], threading.Lock()

    def submit(idx, stats, oversize):
        t0 = time.perf_counter()
        try:
            outcome, payload = client.predict(images[idx].tobytes())
        except Exception as e:
            stats.record("error", error=repr(e))
            return
        stats.record(outcome, time.perf_counter() - t0,
                     (payload or {}).get("version"))
        if outcome == "ok":
            with lock:
                answers.append((t0, idx, payload))

    swapped = {}

    def swap():
        time.sleep(1.0)
        ok, why = engine.try_swap(params[RESUME_STEPS],
                                  version=str(RESUME_STEPS))
        swapped.update(ok=ok, why=why, at=time.perf_counter())

    stats = loadgen.ClientStats()
    swapper = threading.Thread(target=swap)
    swapper.start()
    loadgen.run_closed(submit, list(range(len(images))),
                       SimpleNamespace(duration_s=3.0, concurrency=32),
                       stats)
    swapper.join(60)
    _stop_serve(t, stop, rc, "swap serve")
    check(swapped.get("ok") is True, f"hot-swap refused: {swapped}")
    check(stats.errors == 0, f"errors under the swap: {stats.error_kinds}")
    versions = {p["version"] for _, _, p in answers}
    check(versions == {str(STEPS), str(RESUME_STEPS)},
          f"versions seen under the swap: {versions}")
    late = [p["version"] for t0, _, p in answers if t0 > swapped["at"]]
    check(late and set(late) == {str(RESUME_STEPS)},
          f"{len(late)} answers sent after the swap, versions {set(late)}")
    worst = 0.0
    for _, idx, p in answers:
        ref = refs[p["version"]][idx]
        diff = float(np.abs(np.asarray(p["logits"]) - ref).max())
        worst = max(worst, diff / max(1.0, float(np.abs(ref).max())))
    check(worst <= SWAP_TOL, f"an answer is {worst} from its version's "
          "forward")
    swaps = [r for r in records(scfg.metrics_jsonl) if r["kind"] == "swap"]
    check(len(swaps) == 1 and swaps[0]["from_version"] == str(STEPS),
          f"swap records {swaps}")
    res = {"answers": len(answers), "version_mix": dict(stats.versions),
           "after_swap": len(late), "worst_rel": worst,
           "versions_apart": apart, "swap_ms": swaps[0]["swap_ms"]}
    print(f"[serve swap] step {STEPS} -> {RESUME_STEPS} under 32 clients: "
          f"{len(answers)} answers {dict(stats.versions)}, {len(late)} sent "
          f"after the swap all answered by {RESUME_STEPS}; every answer "
          f"within {worst:.3g} of its version's forward (the versions are "
          f"{apart:.3g} apart); swap {swaps[0]['swap_ms']} ms, on {card}",
          flush=True)
    return res


# ---- Ulysses (26-27), telemetry (28), the optimizer surface (29) ---------

ULYSSES_SEQ = 3          # ViT-Ti's 3 heads, one a rank
# name, global [B, S, H, D], dtype, mask: Ulysses over 3 ranks against the
# one-rank flash_attention of the full sequence: the long-context shape
# (2,700 tokens a rank), and f32 full and causal cases.
ULYSSES_OP_CASES = [
    ("long context", (2, 8100, 3, 64), "bfloat16", {}),
    ("full", (2, 2049, 3, 64), "float32", {}),
    ("causal", (2, 2049, 3, 64), "float32", {"causal": True}),
]


def _rank_ulysses(rank: int, job: dict) -> dict:
    """Ulysses attention on ``ULYSSES_SEQ`` ranks against the
    full-sequence flash attention; returns this rank's max abs
    differences and reference scales, and the launches of the Ulysses
    calls alone at the long-context shape."""
    import torch.distributed as dist

    from dml_cnn_cifar10_tpu_torch.config import ParallelConfig
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import multihost
    from dml_cnn_cifar10_tpu_torch.parallel import ring_attention as ring
    from dml_cnn_cifar10_tpu_torch.parallel import ulysses

    n = ULYSSES_SEQ
    par = ParallelConfig(seq_axis=n, coordinator_address=job["address"],
                         num_processes=n, process_id=rank)
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    multihost.initialize(par, job["backend"], dev)
    mesh = mesh_lib.build_mesh(par)
    gen = torch.Generator(device=dev).manual_seed(6)
    res = {}
    for name, (b, s, h, d), dtype, kw in ULYSSES_OP_CASES:
        q, k, v, do = (torch.randn(b, s, h, d, device=dev, generator=gen)
                       .to(getattr(torch, dtype)) for _ in range(4))
        full = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = fa.flash_attention(*full, **kw)
        ref_g = torch.autograd.grad(ref, full, do)
        mine = [ring.seq_shard(t, mesh).detach().clone().requires_grad_()
                for t in (q, k, v)]
        torch.cuda.synchronize()
        before = dict(fa.LAUNCHES)
        out = ulysses.ulysses_attention_local(*mine, mesh, **kw)
        got_g = torch.autograd.grad(out, mine, ring.seq_shard(do, mesh))
        torch.cuda.synchronize()
        res[name] = {"launches": {key: fa.LAUNCHES[key] - before[key]
                                  for key in before}}
        for what, g, w in zip(("out", "dq", "dk", "dv"), (out, *got_g),
                              (ref, *ref_g)):
            w = ring.seq_shard(w, mesh).float()
            res[name][what] = [(g.float() - w).abs().max().item(),
                               w.abs().max().item()]
        del q, k, v, do, full, ref, ref_g, mine, out, got_g
    mesh.barrier()
    dist.destroy_process_group()
    return res


def _dist_args(world: int, backend: str) -> list:
    ports = _free_ports(world)
    return ["--worker_hosts", ",".join(f"localhost:{p}" for p in ports),
            "--dist_backend", backend]


def ulysses_launches(steps: int, fwd_only: int) -> dict:
    """Per-rank launches of ``steps`` Ulysses steps with remat: K4 = 12
    blocks x 2 (the remat recomputes the forward), K6 = K7 = 12 a step, at
    [B, 8100, 1, 64]; K3 = 12 per forward-only batch; K5 = K1 = K2 = 0."""
    return {"flash_fwd": fwd_only * 12, "flash_fwd_lse": steps * 24,
            "flash_fwd_stats": 0, "flash_bwd_dq": steps * 12,
            "flash_bwd_dkv": steps * 12, "sgd_update_plain": 0,
            "sgd_update_momentum": 0}


def ulysses_phases(backend: str, card: str, one_rank_jsonl=None) -> dict:
    """Phases 26-27 over ``backend`` on ``ULYSSES_SEQ`` rank processes: the
    Ulysses op against one-rank flash attention, then the long-context
    recipe with ``--seq_axis 3 --sp_mode ulysses`` for 10 steps against
    the same batches on one rank (``one_rank_jsonl``, or run here), a
    resume to step 15, ``--mode eval`` and rank 0's step profile."""
    n = ULYSSES_SEQ
    count = torch.cuda.device_count()
    res = {"card": card, "backend": backend, "cards": min(count, n)}
    # ---- 26. the Ulysses op ---------------------------------------------
    op = spawn_ranks(f"ulysses_op_{backend}", {
        "kind": "ulysses", "backend": backend,
        "address": f"localhost:{_free_ports(1)[0]}"}, world=n,
        timeout_s=300)
    for name, _, dtype, kw in ULYSSES_OP_CASES:
        for what in ("out", "dq", "dk", "dv"):
            diff = max(r[name][what][0] for r in op)
            scale = max(r[name][what][1] for r in op)
            tol = RING_OP_TOL["out" if what == "out" else "grad"] \
                if dtype == "float32" else min(BF16_CAP, BF16_REL * scale)
            check(diff <= tol, f"ulysses op {name}: {what} max abs diff "
                               f"{diff} > {tol}")
        print(f"[ulysses op] {name} {dtype} {kw} ({n} ranks, {backend}): "
              f"max abs diff vs the full sequence's flash attention "
              + ", ".join(f"{w} {max(r[name][w][0] for r in op):.3g}"
                          for w in ("out", "dq", "dk", "dv")), flush=True)
    want = {"flash_fwd": 0, "flash_fwd_lse": 1, "flash_fwd_stats": 0,
            "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    check(all(r["long context"]["launches"] == want for r in op),
          f"Ulysses op launched {[r['long context']['launches'] for r in op]}"
          f" per rank, want {want}")
    res["op"] = op

    # ---- 27. Ulysses long context: 8,100 tokens, one head a rank --------
    long = long_args(WORK) + ["--batch_size", "2"]
    if one_rank_jsonl is None:
        one_rank_jsonl = os.path.join(WORK, "ulysses_ref.jsonl")
        run_cli(long + ["--total_steps", str(LONG_STEPS), "--log_dir",
                        os.path.join(WORK, "logs_ulysses_ref"),
                        "--metrics_jsonl", one_rank_jsonl])
    sp = ["--seq_axis", str(n), "--sp_mode", "ulysses"]
    log = os.path.join(WORK, f"logs_ulysses_{backend}")
    jsonl = os.path.join(WORK, f"vit_ulysses_{backend}.jsonl")
    t0 = time.perf_counter()
    ranks = spawn_ranks(f"ulysses_{backend}", {"kind": "cli", "argv": long
                        + sp + ["--total_steps", str(LONG_STEPS),
                                "--log_dir", log, "--metrics_jsonl", jsonl]
                        + _dist_args(n, backend)}, world=n)
    wall = time.perf_counter() - t0
    want = ulysses_launches(LONG_STEPS, LONG_STEPS // 5)
    check(all(r["launches"] == want for r in ranks),
          f"Ulysses ranks launched {[r['launches'] for r in ranks]}, want "
          f"{want}")
    check(len({r["digest"] for r in ranks}) == 1,
          "Ulysses ranks ended with different parameters")
    got, ref = train_log(jsonl), train_log(one_rank_jsonl)
    gaps = [abs(g[1] - r[1]) for g, r in zip(got, ref)]
    check(len(got) == len(ref) == LONG_STEPS // 5
          and [g[0] for g in got] == [r[0] for r in ref]
          and all(math.isfinite(g[1]) for g in got)
          and max(gaps) <= SP_LOSS_TOL,
          f"Ulysses (step, loss, images/s) {got}; one rank {ref}; gaps "
          f"{gaps} (gate {SP_LOSS_TOL})")
    res["train"] = {"train": got, "reference": ref, "loss_gaps": gaps,
                    "step_ms": 2 / got[-1][2] * 1e3,
                    "tokens_per_s": got[-1][2] * 8100, "wall_s": wall,
                    "launches": ranks[0]["launches"], "jsonl": jsonl}
    shutil.copy(jsonl, OUT)
    print(f"[ulysses train] {n} ranks (seq {n}, {backend}), batch 2 x 8,100 "
          f"tokens, one head a rank: (step, loss, images/s) {got}; one rank "
          f"{ref}; loss gaps {gaps} (gate {SP_LOSS_TOL}); "
          f"{res['train']['step_ms']:.1f} ms/step in steps 6-10; launches "
          f"per rank {ranks[0]['launches']}, equal parameters, {wall:.1f} s "
          f"wall, on {min(count, n)} x {card}", flush=True)
    label = f"ulysses_resume_{backend}"
    resume = spawn_ranks(label, {"kind": "cli", "argv": long + sp + [
        "--log_dir", log, "--total_steps", str(LONG_STEPS + 5)]
        + _dist_args(n, backend)}, world=n)
    check(all(r["launches"] == ulysses_launches(5, 1) for r in resume),
          f"Ulysses resume ran {[r['launches'] for r in resume]}, want 5 "
          f"steps from step {LONG_STEPS}")
    steps = [int(m[1]) for m in map(STEP_LINE.match, rank_log(label)) if m]
    check(steps == [LONG_STEPS + 5], f"Ulysses resume printed steps {steps}")
    # The full test split (512 records) at 32 images a batch.
    label = f"ulysses_eval_{backend}"
    ev = spawn_ranks(label, {"kind": "cli", "argv": long[:-2] + sp + [
        "--batch_size", "32", "--log_dir", log, "--mode", "eval"]
        + _dist_args(n, backend)}, world=n)
    accs = []
    for r in range(n):
        lines = rank_log(label, r)
        check(any(f"eval at step {LONG_STEPS + 5}" in l for l in lines),
              f"Ulysses eval rank {r} did not restore step {LONG_STEPS + 5}")
        accs.append([m[1] for m in map(EVAL_LINE.match, lines) if m])
    check(len(accs[0]) == 1 and all(a == accs[0] for a in accs),
          f"Ulysses --mode eval printed {accs}")
    check(ev[0]["launches"]["flash_fwd"] == 16 * 12,
          f"Ulysses eval launched {ev[0]['launches']} (16 batches of 32)")
    res["eval_accuracy"] = accs[0][0]
    print(f"[ulysses resume] continued {LONG_STEPS} -> {LONG_STEPS + 5}; "
          f"--mode eval over {n} ranks: {accs[0][0]}% on each", flush=True)
    prof = spawn_ranks(f"ulysses_profile_{backend}", {
        "kind": "profile", "steps": 2, "argv": long + sp + [
            "--log_dir", os.path.join(WORK, "logs_ulysses_profile")]
        + _dist_args(n, backend)}, world=n)
    res["profile"] = prof
    p = prof[0]
    print(f"[ulysses profile] rank 0 ({backend}): {p['step_ms']:.2f} ms/step "
          f"(host clock, batch on the card); device timeline a step: compute "
          f"{p['compute_ms']:.2f} ms ({100 * p['compute_share']:.1f}% of the "
          f"step), all-to-alls and all-reduces {p['comm_ms']:.2f} ms, of "
          f"which {p['overlap_ms']:.2f} ms beside compute; "
          + ", ".join(f"{k} {v:.2f}" for k, v in p["flash_ms"].items())
          + f"; on {card}", flush=True)
    for k in p["kernels"][:8]:
        print(f"[ulysses profile]   rank 0 {k['ms_per_step']:.4f} ms/step "
              f"x{k['per_step']} {k['name'][:100]}")
    return res


# Train records checked for the run telemetry: every record after the
# first carries these (the first may close a window that opened at it).
TELEMETRY_KEYS = ("device_step_ms", "drain_wait_ms",
                  "tflops_per_sec_per_chip", "mfu")


def telemetry_check(paths: dict, card: str) -> dict:
    """Hold each path's ``train`` records to ``TELEMETRY_KEYS`` and print
    its TFLOP/s and MFU. ``paths``: label -> (jsonl, peak TFLOP/s)."""
    res = {}
    for label, (path, peak) in paths.items():
        train = [r for r in records(path) if r["kind"] == "train"]
        check(len(train) >= 2, f"{label}: {len(train)} train records")
        for r in train[1:]:
            missing = [key for key in TELEMETRY_KEYS if r.get(key) is None]
            check(not missing, f"{label}: step {r['step']} lacks {missing}")
        check(train[0].get("flops_stack") is not None,
              f"{label}: no flops_stack label")
        last = train[-1]
        res[label] = {"flops_stack": train[0]["flops_stack"],
                      "peak_tflops": float(peak),
                      **{key: last[key] for key in
                         ("step", "images_per_sec", *TELEMETRY_KEYS)}}
        print(f"[telemetry] {label}: step {last['step']}, "
              f"{last['tflops_per_sec_per_chip']} TFLOP/s a card, MFU "
              f"{last['mfu']} of {peak} TFLOP/s, device step "
              f"{last['device_step_ms']} ms, drain wait "
              f"{last['drain_wait_ms']} ms (flops {train[0]['flops_stack']});"
              f" on {card}", flush=True)
    return res


def devtime_phase(base, card, k1_device_ms, k1_replay_ms,
                  eager_busy_ms) -> dict:
    """Phase 28's profile windows on the CNN main path: eager and chunked
    (graph replay), 60 steps each, ``--profile_at_steps 30:10``. Each
    writes ``devtime`` records. The chunked window counts the update
    kernels by name (a replay has no ``optimizer`` range): its
    ``optimizer_ms`` is within 2x of K1's device time in phase 9b's
    replays (the same graph; phase 4's K1, timed alone with its leaves in
    L2, reads about half of it: printed). The eager
    window counts the kernels inside the step's ``optimizer`` range: K1
    and the LR schedule's and step counter's small kernels, so it is held
    within 2x of one ``sgd_update``'s device time, measured here, with
    K1's share printed; its compute per step is within 25% of phase 9's
    device time."""
    from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                                  OptimConfig)
    from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
    from dml_cnn_cifar10_tpu_torch.train import optim as optim_lib

    check(k1_device_ms is not None, "phase 4 traced no K1 kernel")
    dev = torch.device("cuda")
    params = {n: p.detach().clone().to(dev) for n, p in CNN(
        ModelConfig(), DataConfig()).named_parameters()}
    grads = {n: torch.randn_like(p) for n, p in params.items()}
    ocfg = OptimConfig(learning_rate=0.02, dead_lr_decay=False)
    opt = optim_lib.sgd_init(params, ocfg, dev)
    update = kernel_ms(lambda: optim_lib.sgd_update(grads, opt, params,
                                                    ocfg))
    update_ms = sum(update.values())
    print(f"[devtime] one sgd_update (the fixed recipe's LR schedule, K1, "
          f"the step counter): {update_ms:.5f} ms of device time in "
          f"{len(update)} kernels, K1 {k1_device_ms} ms of it", flush=True)
    res = {"update_device_ms": update_ms, "update_kernels": sorted(update)}
    for label, extra in (("eager", []),
                         ("chunked", ["--steps_per_dispatch", "10"])):
        log = os.path.join(WORK, f"logs_devtime_{label}")
        jsonl = os.path.join(WORK, f"devtime_{label}.jsonl")
        run_cli(base + extra + ["--log_dir", log, "--total_steps", "60",
                                "--output_every", "10", "--eval_every",
                                "1000", "--checkpoint_every", "1000",
                                "--profile_at_steps", "30:10",
                                "--metrics_jsonl", jsonl])
        recs = records(jsonl)
        dev = [r for r in recs if r["kind"] == "devtime"]
        check(dev and all(r["step"] == 40 for r in dev),
              f"{label}: devtime records {dev}")
        lane = max(dev, key=lambda r: r["compute_ms"])
        opt_ms = [r["optimizer_ms"] for r in recs
                  if r["kind"] == "train" and r["step"] > 40]
        check(opt_ms and opt_ms[0] is not None,
              f"{label}: train records after the window carry "
              f"optimizer_ms {opt_ms}")
        traces = os.listdir(os.path.join(log, "devprof"))
        with open(os.path.join(log, "devprof", traces[0])) as f:
            cats = {e.get("cat") for e in json.load(f)["traceEvents"]}
        compute = lane["compute_ms"] / 10
        top = lane["top_ops"][:3]
        want_ms = update_ms if label == "eager" else k1_replay_ms
        check(0.5 <= opt_ms[0] / want_ms <= 2.0,
              f"{label}: optimizer_ms {opt_ms[0]} against "
              f"{'one update' if label == 'eager' else 'K1'}'s device "
              f"{want_ms} ms")
        if label == "eager":
            check(abs(compute / eager_busy_ms - 1) <= 0.25,
                  f"eager window compute {compute} ms/step against phase "
                  f"9's device {eager_busy_ms} ms/step")
        res[label] = {"lanes": [r["device"] for r in dev],
                      "compute_ms_per_step": compute,
                      "collective_ms": lane["collective_ms"],
                      "infeed_ms": lane["infeed_ms"],
                      "optimizer_ms_per_step": opt_ms[0],
                      "held_to_ms": want_ms,
                      "scope_on_device": "gpu_user_annotation" in cats,
                      "top_ops": lane["top_ops"][:5]}
        shutil.copy(jsonl, OUT)
        print(f"[devtime] {label}: lanes {res[label]['lanes']}; compute "
              f"{compute:.4f} ms/step (phase 9's device {eager_busy_ms:.4f}),"
              f" infeed {lane['infeed_ms']} ms, optimizer_ms "
              f"{opt_ms[0]} ms/step against {want_ms:.5f} ("
              f"{opt_ms[0] / k1_device_ms:.2f}x phase 4's K1 alone; the "
              f"update's annotation on the device: "
              f"{res[label]['scope_on_device']});"
              f" top {[(o['name'][:40], o['dur_ms']) for o in top]}; on "
              f"{card}", flush=True)
    return res


OPT_STEPS = 100
# name -> (flags, K1 launches, K2 launches): 100 CNN steps at full width.
OPT_RUNS = {
    "clip_momentum": (["--grad_clip_norm", "1", "--momentum", "0.9"], 0,
                      OPT_STEPS),
    "grad_accum": (["--grad_accum", "2"], OPT_STEPS, 0),
    "staleness": (["--async_staleness", "2"], OPT_STEPS, 0),
    # LARS leaves 1-D leaves (the biases) unadapted, so with its momentum
    # of 0.9 they step by about 10 x lr x g: at lr 1.0 the CNN's loss
    # oscillates and ends above its first reading in some runs on the
    # card; from 0.1 to 0.5 it falls in every run (chip_optim_repeat.py).
    "lars": (["--optimizer", "lars", "--learning_rate", "0.1"], 0, 0),
    "lamb": (["--optimizer", "lamb", "--learning_rate", "0.001"], 0, 0),
    "adafactor": (["--optimizer", "adafactor", "--learning_rate", "0.01"],
                  0, 0),
}


def optim_phase(base, card) -> dict:
    """Phase 29: each ``OPT_RUNS`` entry for 100 steps (losses finite and
    falling, K1/K2 counted); ``--async_staleness 2 --steps_per_dispatch
    10`` for 100 steps, then one graphed chunk from its state against the
    eager body, bit for bit with cuDNN deterministic; eager 50 + 50 steps
    with a resume against 100, bit for bit (cuDNN deterministic)."""
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused

    res = {}
    for name, (flags, k1, k2) in OPT_RUNS.items():
        jsonl = os.path.join(WORK, f"opt_{name}.jsonl")
        fused.reset_launches()
        run_cli(base + flags + ["--log_dir",
                                os.path.join(WORK, f"logs_{name}"),
                                "--total_steps", str(OPT_STEPS),
                                "--output_every", "25", "--eval_every",
                                "1000", "--checkpoint_every", "1000",
                                "--metrics_jsonl", jsonl])
        losses = [l for _, l, _ in train_log(jsonl)]
        launched = (fused.LAUNCHES["sgd_update_plain"],
                    fused.LAUNCHES["sgd_update_momentum"])
        check(len(losses) == 4 and all(math.isfinite(l) for l in losses)
              and losses[-1] < losses[0],
              f"{name}: losses {losses} (finite and falling)")
        check(launched == (k1, k2),
              f"{name}: K1/K2 launched {launched}, want {(k1, k2)}")
        res[name] = {"losses": losses, "k1": launched[0], "k2": launched[1]}
        print(f"[optim] {name} {' '.join(flags)}: losses {losses}; K1 "
              f"{launched[0]}, K2 {launched[1]} launches in {OPT_STEPS} "
              f"steps; on {card}", flush=True)

    # Staleness under the graph: the snapshot slot is read on the card.
    fused.reset_launches()
    stale = ["--async_staleness", "2"]
    lines, trainer, result = run_trainer(base + stale + [
        "--steps_per_dispatch", str(CHUNK_K), "--log_dir",
        os.path.join(WORK, "logs_stale_chunk"), "--total_steps",
        str(OPT_STEPS), "--output_every", "50", "--eval_every", "1000",
        "--checkpoint_every", "1000"])
    check(fused.LAUNCHES["sgd_update_plain"] == OPT_STEPS
          and trainer.train_fn.graph.replays == OPT_STEPS // CHUNK_K,
          f"chunked staleness: {fused.LAUNCHES}, "
          f"{trainer.train_fn.graph.replays} replays")
    cfg = trainer.cfg
    train_it = trainer.input_pipeline(train=True, seed=cfg.seed)
    ds_images = torch.from_numpy(train_it.images).cuda()
    ds_labels = torch.from_numpy(train_it.labels.astype("int64")).cuda()
    c, _, _ = _graph_vs_eager(cfg, result.state, ds_images, ds_labels, True)
    check(c["loss_gap"] == 0 and c["param_gap"] == 0,
          f"staleness: graphed chunk differs from the eager body: {c}")
    res["staleness_graph_vs_eager"] = c
    print(f"[optim] async_staleness 2 under the graph: {OPT_STEPS} steps in "
          f"{OPT_STEPS // CHUNK_K} replays, K1 {OPT_STEPS}; one chunk from "
          f"step {OPT_STEPS}: loss {c['loss_graph']!r} graphed, "
          f"{c['loss_eager']!r} eager, params max gap {c['param_gap']} "
          f"(cudnn.deterministic)", flush=True)

    # Exact resume on the card: the host streams continue.
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        logs = {}
        for label, stops in (("whole", (100,)), ("split", (50, 100))):
            log = os.path.join(WORK, f"logs_resume_{label}")
            logs[label] = []
            for stop in stops:
                jsonl = os.path.join(WORK, f"resume_{label}_{stop}.jsonl")
                run_cli(base + ["--log_dir", log, "--total_steps", str(stop),
                                "--output_every", "25", "--eval_every",
                                "1000", "--checkpoint_every", "50",
                                "--metrics_jsonl", jsonl])
                logs[label] += [(s, l) for s, l, _ in train_log(jsonl)]
    finally:
        torch.backends.cudnn.deterministic = saved
    blobs = []
    for label in ("whole", "split"):
        with open(os.path.join(WORK, f"logs_resume_{label}",
                               "ckpt_100.msgpack"), "rb") as f:
            blobs.append(f.read())
    check(logs["whole"] == logs["split"] and blobs[0] == blobs[1],
          f"resumed run (step, loss) {logs['split']} against the whole "
          f"run's {logs['whole']}; checkpoints equal: {blobs[0] == blobs[1]}")
    res["resume"] = logs
    print(f"[optim] eager 50 + 50 steps with a resume: (step, loss) "
          f"{logs['split']}, the 100-step run's bit for bit, and the same "
          f"step-100 checkpoint (cudnn.deterministic); on {card}", flush=True)
    return res


def _fresh_model(cfg):
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    return get_model(cfg.model.name)(cfg.model, cfg.data)


def dist_main() -> int:
    """``--dist``: phases 18-21 over NCCL on two or more cards, one rank a
    card, with worlds 2 and (given four cards) 4 — the build, then
    ``dist_phases``; phases 1-17 are skipped. Numbers go to
    ``OUT/dist_nccl.json``; the last line is the same ``{"ok": true, ...}``
    object."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke --dist: needs two or more NVIDIA GPUs",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dml_cnn_cifar10_tpu_torch.ops import _build

    card, kind = card_line(), torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {card}; {count} cards; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    if _build.BUILD_DIR.exists():
        shutil.rmtree(_build.BUILD_DIR)
    _build.build()
    if os.path.isdir(WORK):
        shutil.rmtree(WORK)
    os.makedirs(OUT, exist_ok=True)
    res = dist_phases("nccl", card, worlds=(2, 4) if count >= 4 else (2,))
    if count >= ULYSSES_SEQ:
        res["ulysses"] = ulysses_phases(
            "nccl", card, one_rank_jsonl=os.path.join(WORK, "ref2.jsonl"))
    with open(os.path.join(OUT, "dist_nccl.json"), "w") as f:
        json.dump(res, f, indent=1)
    shutil.rmtree(WORK)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


def rank_main(argv) -> int:
    """Entry of a rank process (``--rank R --job FILE``): runs the job
    and writes its result, with this process's kernel launch counts."""
    rank, job_path = int(argv[argv.index("--rank") + 1]), \
        argv[argv.index("--job") + 1]
    with open(job_path) as f:
        job = json.load(f)
    sys.path.insert(0, ROOT)
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run = {"cli": _rank_cli, "ring": _rank_ring, "ulysses": _rank_ulysses,
           "profile": _rank_profile}[job["kind"]]
    res = run(rank, job)
    res["launches"] = {**fa.LAUNCHES, **fused.LAUNCHES}
    with open(job["out"].format(rank=rank), "w") as f:
        json.dump(res, f)
    return 0


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
    flash_build = ptxas_report(logs["flash_attention"])

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

    def leaf(shape, offset=0, dtype=torch.float32):
        n = math.prod(shape)
        t = torch.randn(n + offset, device=dev, generator=gen).to(dtype)
        return t[offset:].view(shape)   # offset 1: not 16-byte aligned

    # Every case in one call, as a step gives them: the CNN's leaves, a
    # one-element and an empty leaf, views 4 and 12 bytes past 16-byte
    # alignment, enough small leaves to pass MAX_LEAVES (a second
    # launch), and a bf16 leaf (the plain version).
    specs = ([(s, 0) for s in leaf_shapes]
             + [((1,), 0), ((0,), 0), ((37,), 0), ((130, 7), 0),
                ((130, 7), 1), ((2304, 384), 3)]
             + [((37,), 0)] * (fused.MAX_LEAVES - 6))
    n_f32 = sum(math.prod(shape) > 0 for shape, _ in specs)
    check(n_f32 > fused.MAX_LEAVES, f"{n_f32} leaves fit one launch")
    for mu, wd in CASES:
        params, grads, mom, want = {}, {}, {} if mu else None, {}
        for i, (shape, offset) in enumerate(specs + [((9,), 0)]):
            dtype = torch.float32 if i < len(specs) else torch.bfloat16
            key = f"l{i}" if i < len(specs) else "bf16"
            params[key], grads[key] = (leaf(shape, offset, dtype)
                                       for _ in range(2))
            if mu:
                mom[key] = leaf(shape, offset, dtype)
            want[key] = fused.fused_sgd_update_plain(
                params[key], grads[key], mom[key] if mu else None, lr, mu,
                wd)
        before = dict(fused.LAUNCHES)
        fused.fused_sgd_update(params, grads, mom, lr, mu, wd)
        torch.cuda.synchronize()
        launched = {k: fused.LAUNCHES[k] - before[k] for k in before}
        name = "sgd_update_momentum" if mu else "sgd_update_plain"
        want_launches = dict.fromkeys(before, 0)
        want_launches[name] = math.ceil(n_f32 / fused.MAX_LEAVES)
        check(launched == want_launches,
              f"mu={mu} wd={wd}: launched {launched}, want {want_launches}")
        for key, (want_p, want_m) in want.items():
            got = [params[key]] + ([mom[key]] if mu else [])
            exp = [want_p] + ([want_m] if mu else [])
            if not params[key].numel():
                continue
            diff = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(got, exp))
            if key != "bf16":
                worst[name] = max(worst[name], diff)
            # Both kernels (and the bf16 leaf's plain version, the same
            # expression) are held bit-equal.
            check(all(torch.equal(a, b) for a, b in zip(got, exp)),
                  f"{name} leaf {key} {tuple(params[key].shape)} mu={mu} "
                  f"wd={wd}: max abs diff {diff}")
    print(f"[parity] max abs diff vs plain: {worst} ({len(specs)} f32 leaves "
          f"and a bf16 one per call, K1 and K2 each in "
          f"{math.ceil(n_f32 / fused.MAX_LEAVES)} launches)", flush=True)
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
            ("sgd_update_plain", 0.0, 0.0, "sgd_multi_kernel<false>"),
            ("sgd_update_momentum", 0.9, 5e-4, "sgd_multi_kernel<true>")):
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
        # fused SGD's device time: every kernel of one lib.step.
        library_dev = kernel_ms(lib.step)
        per_param_bytes, per_param_ops = (20, 4) if mu else (12, 2)
        if wd:
            per_param_ops += 2
        need_bytes = per_param_bytes * n_params + 4      # + the lr scalar
        need_ops = per_param_ops * n_params
        by_bytes = need_bytes / bytes_per_s * 1e3
        by_ops = need_ops / ops_per_s * 1e3
        timing[name] = dict(
            ms=ms, device_ms=dms, plain_ms=plain_ms, library_ms=library_ms,
            library_device_ms=sum(library_dev.values()),
            library_kernels=sorted(library_dev),
            bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            bytes=need_bytes, mu=mu, wd=wd, cuda_kernel=needle)
        print(f"[timing] {name} (mu={mu}, wd={wd}, {n_leaves} leaves): "
              f"kernel {ms:.5f} ms/step (device {dms} ms), plain "
              f"{plain_ms:.5f} ms, torch.optim.SGD(fused=True) "
              f"{library_ms:.5f} ms (device "
              f"{timing[name]['library_device_ms']:.5f} ms in "
              f"{len(library_dev)} kernel(s): "
              f"{', '.join(k[:60] for k in sorted(library_dev))}), bound "
              f"{timing[name]['bound_ms']:.5f} ms "
              f"({timing[name]['bound_by']}) on {card}", flush=True)

    # ---- 5. train: the main path ----------------------------------------
    if os.path.isdir(WORK):
        shutil.rmtree(WORK)
    os.makedirs(OUT, exist_ok=True)
    log_dir = os.path.join(WORK, "logs")
    base = cnn_args(WORK) + ["--output_every", "100",
                             "--checkpoint_every", "250"]
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
    check(launches["sgd_update_plain"] == STEPS,
          f"K1 launched {launches['sgd_update_plain']} times, want one "
          f"for each of {STEPS} steps ({n_leaves} leaves each)")
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
    check(fused.LAUNCHES["sgd_update_plain"] == RESUME_STEPS - STEPS,
          f"resume ran {fused.LAUNCHES['sgd_update_plain']} steps, want "
          f"{RESUME_STEPS - STEPS} (from step {STEPS})")
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
    check(momentum_k2 == MOMENTUM_STEPS,
          f"K2 launched {momentum_k2} times, want one for each of "
          f"{MOMENTUM_STEPS} steps ({n_leaves} leaves each)")
    check(fused.LAUNCHES["sgd_update_plain"] == 0, "K1 ran with momentum")
    check(all(r["loss"] is not None and math.isfinite(r["loss"])
              for r in records(mom_jsonl) if r["kind"] == "train"),
          "non-finite momentum-run loss")
    print(f"[momentum] {MOMENTUM_STEPS} steps, K2 launches {momentum_k2}",
          flush=True)

    # ---- 9. where a training step's time goes ---------------------------
    eager_profile = profile_step(
        base + ["--log_dir", os.path.join(WORK, "logs_profile")],
        records(train_jsonl), card)

    # ---- 9b. chunked: resident data, device index stream, CUDA graphs --
    chunk = chunk_phase(base, card, eager_profile)

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
                "--checkpoint_every", "100", "--output_every", "50",
                "--peak_tflops", F32_PEAK_TFLOPS]
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
            "flash_fwd_lse": VIT_STEPS * n_blocks, "flash_fwd_stats": 0,
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
    long_base = long_args(WORK) + ["--batch_size", "2"]
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
            "flash_fwd_lse": LONG_STEPS * n_blocks * 2, "flash_fwd_stats": 0,
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

    # ---- 16. K5 parity, and K6/K7 as the backward ring calls them -------
    stats_worst = stats_parity(dev)
    ring_bwd_worst = ring_bwd_parity(dev)

    # ---- 17. K5 timing ---------------------------------------------------
    stats_time = stats_timing(dev, card, bytes_per_s)

    # ---- 18-21. two ranks: ring op, SP train/resume/eval, DP, profile ----
    # One card each over NCCL when there are two, else both on this card
    # over gloo (NCCL refuses two ranks on one device).
    backend = "nccl" if count >= 2 else "gloo"
    print(f"[dist] 2 ranks over {backend} on {min(count, 2)} card(s)",
          flush=True)
    dist_res = dist_phases(backend, card, one_rank_jsonl=long_jsonl)
    with open(os.path.join(OUT, "dist.json"), "w") as f:
        json.dump({"stats_parity": stats_worst, "stats_timing": stats_time,
                   "ring_bwd_parity": ring_bwd_worst, **dist_res}, f,
                  indent=1)
    sp_launched = dist_res["sp2"]["launches"]

    # ---- 22-25. serving: export, K3's operator, graphs, HTTP ------------
    serve = serve_phases(card, dev, base + ["--log_dir", log_dir],
                         vit_base + ["--log_dir", vit_log], bytes_per_s,
                         ops_per_s)

    # ---- 26-27. Ulysses: the op, then train/resume/eval/profile ----------
    # One card each over NCCL when there are three, else all on this card
    # over gloo.
    ul_backend = "nccl" if count >= ULYSSES_SEQ else "gloo"
    print(f"[dist] {ULYSSES_SEQ} ranks over {ul_backend} on "
          f"{min(count, ULYSSES_SEQ)} card(s)", flush=True)
    uly = ulysses_phases(ul_backend, card, one_rank_jsonl=long_jsonl)

    # ---- 28. telemetry: TFLOP/s and MFU of every path; profile windows ---
    telemetry = telemetry_check({
        "cnn eager": (train_jsonl, F32_PEAK_TFLOPS),
        "cnn chunked": (os.path.join(WORK, "chunk_train.jsonl"),
                        F32_PEAK_TFLOPS),
        "vit-ti": (vit_jsonl, F32_PEAK_TFLOPS),
        "long context": (long_jsonl, BF16_PEAK_TFLOPS),
        "sp ring (2 ranks)": (os.path.join(WORK, "vit_sp2.jsonl"),
                              BF16_PEAK_TFLOPS),
        "sp ulysses (3 ranks)": (uly["train"]["jsonl"], BF16_PEAK_TFLOPS)},
        card)
    devtime = devtime_phase(base, card,
                            timing["sgd_update_plain"]["device_ms"],
                            chunk["groups_ms_per_step"]["K1"],
                            eager_profile["device_busy_ms_per_step"])

    # ---- 29. the optimizer surface --------------------------------------
    optim = optim_phase(base, card)
    with open(os.path.join(OUT, "slice10.json"), "w") as f:
        json.dump({"card": card, "ulysses": uly, "telemetry": telemetry,
                   "devtime": devtime, "optim": optim}, f, indent=1)

    for path in (train_jsonl, resume_jsonl, mom_jsonl, vit_jsonl,
                 os.path.join(WORK, "vit_resume.jsonl"), long_jsonl):
        shutil.copy(path, OUT)
    with open(os.path.join(OUT, "vit.json"), "w") as f:
        json.dump({"card": card, "main": vit_rate, "long": long_rate,
                   "flash_build": flash_build,
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
            **({"launches_dp_per_rank": dist_res["dp2"]["launches"][name]}
               if kid == "K1" else {}),
            "launches_chunked": chunk["k1_launches" if kid == "K1"
                                      else "k2_launches"],
            "name": name, "kernel": kid, "route": "cuda",
            "source": "dml_cnn_cifar10_tpu_torch/csrc/sgd_update.cu",
            "cuda_kernel": t["cuda_kernel"],
            "replaces": f"dml_cnn_cifar10_tpu/ops/optimizer.py:{line}",
            "launches": launches,
            "max_abs_err": worst[name], "max_abs_diff": worst[name],
            "ms": t["ms"], "kernel_ms": t["ms"],
            "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            "library": "torch.optim.SGD(fused=True).step",
            "work": f"one optimizer step over the CNN's {n_leaves} f32 "
                    f"leaves ({n_params} params), mu={t['mu']}, "
                    f"wd={t['wd']}",
        })
    t = stats_time
    kernels.append({
        "name": "flash_fwd_stats", "kernel": "K5", "route": "cuda",
        "source": "dml_cnn_cifar10_tpu_torch/csrc/flash_attention.cu",
        "cuda_kernel": "flash_stats_kernel",
        "cuda_body": "flash_fwd_tc<T, D, kStats> (tensor cores, mma.sync)",
        "replaces": "dml_cnn_cifar10_tpu/ops/flash_attention.py:386",
        "launches": sp_launched["flash_fwd_stats"],
        "max_abs_err": stats_worst["float32"],
        "max_abs_diff": stats_worst["float32"],
        "max_abs_err_bf16": stats_worst["bfloat16"],
        "ms": t["ms"], "kernel_ms": t["ms"], "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library_device_ms": t["library_device_ms"],
        "library": t["library"],
        "work": f"one launch at the SP main path's ring block "
                f"{t['shape']} {t['dtype']}; launches: rank 0 of the 2-rank "
                f"8,100-token run; max_abs_err on acc / l",
    })
    for name, kid, line, needle in (
            ("flash_fwd", "K3", 345, "flash_out_kernel"),
            ("flash_fwd_lse", "K4", 360, "flash_lse_kernel"),
            ("flash_bwd_dq", "K6", 688, "flash_dq_kernel"),
            ("flash_bwd_dkv", "K7", 736, "flash_dkv_kernel")):
        t, long_t = flash_times[(name, "vit")], flash_times[(name, "long")]
        kernels.append({
            "launches_sp_per_rank": sp_launched[name],
            **({"max_abs_err_ring_bwd_f32": ring_bwd_worst,
                "ring": {k: stats_time["ring_bwd_ms"][name][k]
                         for k in ("ms", "device_ms", "plain_ms",
                                   "library_ms", "library_device_ms",
                                   "bound_ms", "bound_by")}}
               if kid in ("K6", "K7") else {}),
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
            "library_device_ms": t["library_device_ms"],
            "library": t["library"],
            "work": f"one launch at the ViT main path's attention "
                    f"{t['shape']} {t['dtype']}",
            "long": {k: long_t[k] for k in ("shape", "dtype", "ms",
                                            "device_ms", "plain_ms",
                                            "library_ms",
                                            "library_device_ms", "bound_ms",
                                            "bound_by")},
        })
    for name, kid, line, needle in (
            ("flash_fwd", "K3", 345, "flash_out_kernel"),
            ("flash_fwd_lse", "K4", 360, "flash_lse_kernel"),
            ("flash_bwd_dq", "K6", 688, "flash_dq_kernel"),
            ("flash_bwd_dkv", "K7", 736, "flash_dkv_kernel")):
        t = flash_times[(name, "ulysses")]
        err = FLASH_CASE_DIFFS["ulysses"][name]
        kernels.append({
            "name": name, "kernel": kid, "path": "ulysses", "route": "cuda",
            "source": "dml_cnn_cifar10_tpu_torch/csrc/flash_attention.cu",
            "cuda_kernel": needle,
            "replaces": f"dml_cnn_cifar10_tpu/ops/flash_attention.py:{line}",
            "launches": uly["train"]["launches"][name],
            "max_abs_err": err, "max_abs_err_bf16": err,
            **{k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by", "bound_tc_ms", "flops",
                                 "library_ms", "library_device_ms",
                                 "library")},
            "kernel_ms": t["ms"],
            "tflops_per_s": t["flops"] / t["ms"] / 1e9,
            "work": f"one launch at a Ulysses rank's shape {t['shape']} "
                    f"{t['dtype']} (the 8,100-token recipe over 3 seq "
                    f"ranks); launches: rank 0 of the 3-rank run, 10 "
                    f"steps (K3: its 2 forward-only batches); max_abs_err "
                    f"against the plain version at that shape",
        })
    t, t128 = serve["k3"]["timed"][1], serve["k3"]["timed"][128]
    kernels.append({
        "name": "flash_fwd", "kernel": "K3", "path": "serve",
        "route": "cuda",
        "source": "dml_cnn_cifar10_tpu_torch/csrc/flash_attention.cu",
        "cuda_kernel": "flash_out_kernel",
        "operator": "dml_torch::flash_attention_out",
        "replaces": "dml_cnn_cifar10_tpu/ops/flash_attention.py:345",
        "launches": serve["vit"]["http"]["launches"]["flash_fwd"],
        "max_abs_err": serve["k3"]["worst"],
        "max_abs_diff": serve["k3"]["worst"],
        **{k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                             "bound_by", "bound_tc_ms", "tc_flops",
                             "library_ms", "library_device_ms",
                             "library")},
        "kernel_ms": t["ms"],
        "work": "one launch through the registered operator at the ViT-Ti "
                "serving shape [1, 257, 3, 64] f32 (views of a fused qkv); "
                "launches: the ViT-Ti --mode serve run over HTTP (12 a "
                "replay); max_abs_err over b = 1, 8, 32, 128",
        "b128": {k: t128[k] for k in ("shape", "ms", "device_ms",
                                      "plain_ms", "library_ms",
                                      "library_device_ms", "bound_ms",
                                      "bound_by", "bound_tc_ms",
                                      "tc_flops")},
    })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    if "--rank" in sys.argv:
        sys.exit(rank_main(sys.argv))
    sys.exit(dist_main() if "--dist" in sys.argv else main())
