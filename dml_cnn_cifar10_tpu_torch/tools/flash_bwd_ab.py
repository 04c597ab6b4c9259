"""A/B timing of K6/K7, the flash-attention backward kernels: the
checkout's ``csrc/flash_attention.cu`` against another version of that
source, both built and timed in one process on one card.

    python3 -m dml_cnn_cifar10_tpu_torch.tools.flash_bwd_ab --other PATH

Each shape is the one ``chip_smoke.py`` times K6/K7 at: the ViT main
path's [128, 257, 3, 64] f32, the long context's [2, 8100, 3, 64] bf16,
and the ring block [2, 4050, 3, 64] bf16 -> f32 gradients. Both versions
get the same inputs; their gradients are compared, and each is timed by
CUDA events in the order A, B, B, A (A the checkout, B ``--other``). The
last line of the output is one JSON object with every reading. Needs a
CUDA card and ``nvcc``.
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

SHAPES = (("vit", (128, 257, 3, 64), torch.float32, None),
          ("long", (2, 8100, 3, 64), torch.bfloat16, None),
          ("ring", (2, 4050, 3, 64), torch.bfloat16, torch.float32))


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other version of csrc/flash_attention.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_ab: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = dict(zip("AB", load_both(args.other)))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    result = {"card": card, "other": str(args.other), "shapes": {}}
    for label, shape, dtype, out_dtype in SHAPES:
        q, k, v, do = (torch.randn(*shape, device=dev, generator=gen)
                       .to(dtype) for _ in range(4))
        fa._LIB = libs["A"]
        with torch.no_grad():
            out, lse = fa.flash_attention_fwd_lse(q, k, v)
            delta = fa.attention_delta(out, do)
        bwd = (q, k, v, do, lse, delta, shape[-1] ** -0.5, False, out_dtype,
               None, 0, None, None)
        launches = {"K6": lambda: fa._dq_launch(*bwd),
                    "K7": lambda: fa._dkv_launch(*bwd)}
        grads = {}
        for name in "AB":
            fa._LIB = libs[name]
            grads[name] = [launches["K6"](), *launches["K7"]()]
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(grads["A"], grads["B"]))
        reads = {"A": {"K6": [], "K7": []}, "B": {"K6": [], "K7": []}}
        for name in "ABBA":
            fa._LIB = libs[name]
            for kid, fn in launches.items():
                reads[name][kid].append(timed_ms(fn))
        mean = {name: sum(sum(r) / len(r) for r in reads[name].values())
                for name in "AB"}
        result["shapes"][label] = dict(shape=list(shape),
                                       dtype=str(dtype)[6:], reads=reads,
                                       pair_ms=mean, max_abs_diff=diff)
        print(f"[ab] {label:4} {list(shape)} {str(dtype)[6:]}: "
              + "; ".join(f"{n} K6 {reads[n]['K6']} K7 {reads[n]['K7']} "
                          f"pair {mean[n]:.5f} ms" for n in "AB")
              + f"; B/A {mean['B'] / mean['A']:.4f}; max abs diff of the "
              f"gradients {diff:.3g} on {card}", flush=True)
        del q, k, v, do, out, lse, delta, grads
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
