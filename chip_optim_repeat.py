"""Repeat the optimizer-surface runs of ``chip_smoke.py`` phase 29 on the
card, to show how steady each one's losses are from run to run.

Each entry of ``chip_smoke.OPT_RUNS``, and LARS at the learning rates in
``LARS_LRS``, trains the CNN main path's recipe for 100 steps, ``--repeats``
times (3 by default), without deterministic cuDNN, as phase 29 does. One
line a run gives its losses at steps 25, 50, 75 and 100 and whether the
last is below the first (phase 29's check); the last lines are the
losses of every run as JSON, then the card's name and power limit.

    python3 chip_optim_repeat.py [--repeats N]
"""
import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import time

import chip_smoke as cs

LARS_LRS = ("0.02", "0.1", "0.2", "0.5", "1.0")
STEPS = 100


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    cs.check(cs.torch.cuda.is_available(), "no CUDA device")
    work = os.path.join(cs.ROOT, ".chip_smoke_work", "optim_repeat")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    base = cs.cnn_args(work)
    runs = {name: flags for name, (flags, _, _) in cs.OPT_RUNS.items()}
    for lr in LARS_LRS:
        runs[f"lars_lr{lr}"] = ["--optimizer", "lars", "--learning_rate", lr]
    out = {}
    for rep in range(args.repeats):
        for name, flags in runs.items():
            jsonl = os.path.join(work, f"{name}_{rep}.jsonl")
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cs.run_cli(base + flags + [
                    "--log_dir", os.path.join(work, f"logs_{name}_{rep}"),
                    "--total_steps", str(STEPS), "--output_every", "25",
                    "--eval_every", "1000", "--checkpoint_every", "1000",
                    "--metrics_jsonl", jsonl])
            losses = [l for _, l, _ in cs.train_log(jsonl)]
            out.setdefault(name, []).append(losses)
            print(f"[repeat] {name} run {rep}: losses {losses}, falling "
                  f"{losses[-1] < losses[0]} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps(out))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
