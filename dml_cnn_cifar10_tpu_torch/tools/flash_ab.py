"""A/B timing of the flash-attention kernels: the checkout's
``csrc/flash_attention.cu`` against another version of that source, both
built and timed in one process on one card.

    python3 -m dml_cnn_cifar10_tpu_torch.tools.flash_ab --other PATH

K3 and K4 run at the shapes ``chip_smoke.py`` times them at: the ViT main
path's [128, 257, 3, 64] f32 and the long context's [2, 8100, 3, 64]
bf16; K6 and K7 at those two and at the ring block [2, 4050, 3, 64] bf16
-> f32 gradients. Both versions get the same inputs; their outputs (out
and lse; the gradients) must agree within the pins ``chip_smoke.py``
holds each kernel to against its plain version, and each kernel is timed
by CUDA events in the order A, B, B, A (A the checkout, B ``--other``).
The last line of the output is one JSON object with every reading; the
exit code is 1 if the versions disagree. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from dml_cnn_cifar10_tpu_torch.ops import _build
from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa

FWD_SHAPES = (("vit", (128, 257, 3, 64), torch.float32, None),
              ("long", (2, 8100, 3, 64), torch.bfloat16, None))
BWD_SHAPES = FWD_SHAPES + (("ring", (2, 4050, 3, 64), torch.bfloat16,
                            torch.float32),)
# chip_smoke.py's pins: f32 out, lse, gradients; bf16 out and gradients
# 1e-2 x max|A| (one bf16 ulp), at most 0.05.
PINS = {"out": 5e-6, "lse": 1e-5, "grad": 5e-5}
BF16_REL, BF16_CAP = 1e-2, 0.05


@contextlib.contextmanager
def _sources(csrc: Path):
    """Build and load the kernels' library from ``csrc`` meanwhile."""
    saved, _build.CSRC, fa._LIB = _build.CSRC, csrc, None
    try:
        yield
    finally:
        _build.CSRC = saved


def load_both(other: Path):
    """The checkout's library and ``other``'s, both ``nvcc`` processes
    running together."""
    csrc = _build.BUILD_DIR / "ab_other"
    csrc.mkdir(parents=True, exist_ok=True)
    shutil.copy(other, csrc / "flash_attention.cu")
    with _sources(csrc):
        out = _build.library_path("flash_attention")
        proc = None
        if not out.is_file():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp),
                 str(csrc / "flash_attention.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fa._LIB = None
    lib_a = fa._lib()
    if proc is not None:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {other}:\n{log}")
        os.replace(tmp, out)
    with _sources(csrc):
        lib_b = fa._lib()
    return lib_a, lib_b


def timed_ms(fn, min_ms: float = 300.0) -> float:
    """Mean ms of ``fn()`` by CUDA events over enough back-to-back calls
    to fill ``min_ms``, after a warm-up of a quarter of them."""
    def run(reps, warmup):
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
    reps = max(3, min(500, math.ceil(min_ms / max(run(1, 1), 1e-3))))
    return run(reps, max(1, reps // 4))


def _pin(kind: str, ref: torch.Tensor) -> float:
    if ref.dtype == torch.float32 or kind == "lse":
        return PINS[kind]
    return min(BF16_CAP, BF16_REL * ref.float().abs().max().item())


def compare(libs, launches, kinds):
    """Run each version's launches once; returns the largest difference of
    each output between A and B and whether all are within their pins."""
    outs = {}
    for name in "AB":
        fa._LIB = libs[name]
        outs[name] = [t for fn in launches.values() for t in fn()]
    diffs, ok = [], True
    for a, b, kind in zip(outs["A"], outs["B"], kinds):
        live = a < 1e29 if kind == "lse" else torch.ones_like(a, dtype=bool)
        diff = (a[live].float() - b[live].float()).abs().max().item()
        ok &= diff <= _pin(kind, a) and torch.equal(a[~live], b[~live])
        diffs.append(diff)
    return diffs, ok


def ab_reads(libs, launches):
    """Each launch timed A, B, B, A."""
    reads = {n: {k: [] for k in launches} for n in "AB"}
    for name in "ABBA":
        fa._LIB = libs[name]
        for kid, fn in launches.items():
            reads[name][kid].append(timed_ms(fn))
    return reads


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other version of csrc/flash_attention.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = dict(zip("AB", load_both(args.other)))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    result, agree = {"card": card, "other": str(args.other)}, True
    for part, shapes in (("fwd", FWD_SHAPES), ("bwd", BWD_SHAPES)):
        result[part] = {}
        for label, shape, dtype, out_dtype in shapes:
            q, k, v, do = (torch.randn(*shape, device=dev, generator=gen)
                           .to(dtype) for _ in range(4))
            if part == "fwd":
                launches = {
                    "K3": lambda: [fa.flash_attention(q, k, v)],
                    "K4": lambda: list(fa.flash_attention_fwd_lse(q, k, v))}
                kinds = ["out", "out", "lse"]
            else:
                fa._LIB = libs["A"]
                with torch.no_grad():
                    out, lse = fa.flash_attention_fwd_lse(q, k, v)
                    delta = fa.attention_delta(out, do)
                bwd = (q, k, v, do, lse, delta, shape[-1] ** -0.5, False,
                       out_dtype, None, 0, None, None)
                launches = {"K6": lambda: [fa._dq_launch(*bwd)],
                            "K7": lambda: list(fa._dkv_launch(*bwd))}
                kinds = ["grad"] * 3
            with torch.no_grad():
                diffs, ok = compare(libs, launches, kinds)
                reads = ab_reads(libs, launches)
            agree &= ok
            mean = {n: sum(sum(r) / len(r) for r in reads[n].values())
                    for n in "AB"}
            result[part][label] = dict(
                shape=list(shape), dtype=str(dtype)[6:], reads=reads,
                pair_ms=mean, max_abs_diff=diffs, within_pins=ok)
            ids = list(launches)
            print(f"[ab] {part} {label:4} {list(shape)} {str(dtype)[6:]}: "
                  + "; ".join(" ".join(f"{n} {kid} {reads[n][kid]}"
                                       for kid in ids)
                              + f" pair {mean[n]:.5f} ms" for n in "AB")
                  + f"; B/A {mean['B'] / mean['A']:.4f}; max abs diff "
                  f"A-B {[f'{x:.3g}' for x in diffs]} "
                  f"({'within' if ok else 'OUTSIDE'} the pins) on {card}",
                  flush=True)
            del q, k, v, do
    print(json.dumps(result))
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
