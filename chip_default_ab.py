#!/usr/bin/env python3
"""Time the CNN main path in two checkouts of the port, in turns, on one
card: every run-safety flag at its default, so a change to the trainer's
loop can be held to the loop it replaced.

Usage, from the root of a checkout::

    python3 chip_default_ab.py OTHER

``OTHER`` is another checkout's root (one holding
``dml_cnn_cifar10_tpu_torch/``, e.g. a parent commit unpacked with ``git
archive``). Each run is a process of its own that imports the port from
its tree, builds that tree's kernels there, and drives ``cli.main`` on the
CNN main path of ``chip_smoke.py`` phases 5 and 9b: batch 128 on 50,000
synthetic records, eager for 300 steps and chunked (``--steps_per_dispatch
10``, resident, the device stream, one CUDA graph a chunk) for 500. The
order is other, this, this, other for each path; it prints each run's
ms/step (the mean of its ``train`` windows after step 100), the card's
name and power limit, and one JSON line. Exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
# Scratch (data, logs), removed after a passing run.
WORK = os.path.join(ROOT, ".chip_default_ab_work")
PATHS = {"eager": ["--total_steps", "300"],
         "chunked": ["--total_steps", "500", "--steps_per_dispatch", "10"]}

_RUN = """
import sys
sys.path.insert(0, sys.argv[1])
from dml_cnn_cifar10_tpu_torch.cli.main import main
sys.exit(main(sys.argv[2:]))
"""


def run(tree: str, name: str, path: str) -> float:
    """One run of ``path`` with the port of ``tree``; its ms/step."""
    log = os.path.join(WORK, name)
    shutil.rmtree(log, ignore_errors=True)
    jsonl = os.path.join(WORK, f"{name}.jsonl")
    if os.path.exists(jsonl):
        os.remove(jsonl)
    args = ["--dataset", "synthetic", "--data_dir",
            os.path.join(WORK, "data"), "--synthetic_train_records",
            "50000", "--fidelity", "fixed", "--learning_rate", "0.02",
            "--batch_size", "128", "--output_every", "50",
            "--eval_every", "1000", "--checkpoint_every", "1000",
            "--log_dir", log, "--metrics_jsonl", jsonl, *PATHS[path]]
    out = subprocess.run([sys.executable, "-c", _RUN, tree, *args],
                         cwd=tree, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        sys.exit(f"chip_default_ab: {name} exited {out.returncode}:\n"
                 f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    with open(jsonl) as f:
        ips = [r["images_per_sec"] for r in map(json.loads, f)
               if r["kind"] == "train" and r["step"] > 100]
    return 128 / (sum(ips) / len(ips)) * 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: python3 chip_default_ab.py OTHER (needs a CUDA card)",
              file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    os.makedirs(WORK, exist_ok=True)
    res = {"card": card, "other": other}
    for path in PATHS:
        turns = []
        for i, (label, tree) in enumerate((("other", other), ("this", ROOT),
                                           ("this", ROOT),
                                           ("other", other))):
            ms = run(tree, f"{path}_{label}_{i}", path)
            turns.append((label, ms))
            print(f"[default ab] {path} {label}: {ms:.4f} ms/step on {card}",
                  flush=True)
        res[path] = turns
    shutil.rmtree(WORK)
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
