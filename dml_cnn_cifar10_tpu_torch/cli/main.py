"""CLI of the PyTorch port: the reference's flags plus the slice's own.

Reference flags (``cifar10cnn.py:245-273``): ``--ps_hosts --worker_hosts
--job_name --task_index --data_dir --log_dir``, mapped as in the JAX
package's CLI: ``--job_name=ps`` prints a note and exits 0 (parameters
live on the device; there is no parameter server), ``--ps_hosts`` is
accepted and ignored, and several ``--worker_hosts`` ask for multi-GPU
data parallelism, which is the port's next slice and raises here.

Models: ``--model cnn`` (the reference, default) and ``--model vit_tiny``
(ViT-Ti, attention through the hand-written flash kernels from 128 tokens
up, e.g. ``--crop_size 64``), with the JAX CLI's ViT, optimizer and
schedule flags. Modes: ``train`` (default) and ``eval`` (restore the
latest checkpoint and sweep the full test split). The run is on
``--device cuda`` unless ``--device cpu`` is given; a missing card
raises.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from dml_cnn_cifar10_tpu_torch import config as config_lib


def _bool(v: str) -> bool:
    return v.lower() == "true"   # the reference's custom bool (:247)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dml_cnn_cifar10_tpu_torch",
        description="PyTorch/CUDA port of the distributed CIFAR-10 CNN "
                    "trainer (reference-compatible CLI)")
    p.register("type", "bool", _bool)
    # --- reference flags (cifar10cnn.py:249-272) ---
    p.add_argument("--ps_hosts", type=str, default="",
                   help="DEPRECATED: comma-separated ps hosts (ignored; "
                        "there are no parameter servers)")
    p.add_argument("--worker_hosts", type=str, default="",
                   help="comma-separated hostname:port list; more than one "
                        "host needs multi-GPU support, not ported yet")
    p.add_argument("--job_name", type=str, default="",
                   help="One of 'ps', 'worker' (ps exits immediately)")
    p.add_argument("--task_index", type=int, default=0,
                   help="Index of task within the job")
    p.add_argument("--data_dir", type=str, default="cifar10data",
                   help="Directory for input data")
    p.add_argument("--log_dir", type=str, default="/tmp/train_logs",
                   help="Checkpoint/log directory")
    # --- framework flags ---
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "eval"],
                   help="train; eval = restore the latest checkpoint and "
                        "sweep the full test split")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--model", type=str, default="cnn",
                   help="cnn (the reference) or vit_tiny")
    p.add_argument("--dataset", type=str, default="cifar10",
                   choices=["cifar10", "synthetic"])
    p.add_argument("--image_size", type=int, default=None,
                   help="stored square image side (default: 32)")
    p.add_argument("--crop_size", type=int, default=None,
                   help="model input side after crop (default: 24)")
    p.add_argument("--synthetic_train_records", type=int, default=None,
                   help="generated train records for --dataset synthetic")
    p.add_argument("--fidelity", type=str, default="faithful",
                   choices=["faithful", "fixed"],
                   help="faithful reproduces the reference quirks (ReLU'd "
                        "logits, dead LR decay, single-batch eval, raw "
                        "pixels); fixed applies the sane versions")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--total_steps", type=int, default=20000)
    p.add_argument("--output_every", type=int, default=200,
                   help="train-metrics cadence (reference OUTPUT_EVERY)")
    p.add_argument("--eval_every", type=int, default=500,
                   help="eval cadence (reference EVAL_EVERY)")
    p.add_argument("--checkpoint_every", type=int, default=1000)
    p.add_argument("--learning_rate", type=float, default=0.1)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=["sgd", "adamw", "lars", "lamb", "adafactor"],
                   help="sgd = reference; adamw for the transformer "
                        "ladder (lars/lamb/adafactor are not ported yet)")
    p.add_argument("--momentum", type=float, default=0.0,
                   help="SGD momentum (reference uses plain SGD)")
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--schedule", type=str, default="exponential",
                   choices=["exponential", "cosine", "constant"],
                   help="LR schedule family (exponential = reference "
                        "parity; cosine for the ViT ladder)")
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear LR warmup prepended to any schedule")
    p.add_argument("--cosine_decay_steps", type=int, default=0,
                   help="cosine horizon (defaults to total_steps when "
                        "--schedule cosine and this is 0)")
    # --- ViT flags (the JAX package's names and defaults) ---
    p.add_argument("--vit_dim", type=int, default=None,
                   help="ViT embed dim (default 192)")
    p.add_argument("--vit_depth", type=int, default=None,
                   help="ViT blocks (default 12)")
    p.add_argument("--vit_heads", type=int, default=None,
                   help="ViT attention heads (default 3)")
    p.add_argument("--pool", type=str, default=None, choices=["cls", "mean"],
                   help="ViT head pooling (default cls)")
    p.add_argument("--remat", type="bool", default=False,
                   help="recompute each ViT block's activations in the "
                        "backward pass (activation memory O(1) in depth)")
    p.add_argument("--attn_causal", type="bool", default=False,
                   help="causal attention mask in the ViT's blocks")
    p.add_argument("--attn_window", type=int, default=None,
                   help="sliding-window attention width for the ViT: "
                        "band |row-col| < W")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="parameter EMA decay for eval (0 = off)")
    p.add_argument("--fused_optimizer", type="bool", default=True,
                   help="fused single-pass SGD update (ops/optimizer.py: "
                        "the hand-written CUDA kernel on the card); false "
                        "keeps the per-transform chain")
    p.add_argument("--metrics_jsonl", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    return p


def config_from_args(args: argparse.Namespace) -> config_lib.TrainConfig:
    make = (config_lib.reference_config if args.fidelity == "faithful"
            else config_lib.fixed_config)
    cfg = make(
        batch_size=args.batch_size,
        total_steps=args.total_steps,
        output_every=args.output_every,
        eval_every=args.eval_every,
        checkpoint_every=args.checkpoint_every,
        log_dir=args.log_dir,
        metrics_jsonl=args.metrics_jsonl,
        seed=args.seed,
        device=args.device,
    )
    cfg.data.dataset = args.dataset
    cfg.data.data_dir = args.data_dir
    if args.image_size is not None:
        cfg.data.image_height = cfg.data.image_width = args.image_size
    if args.crop_size is not None:
        cfg.data.crop_height = cfg.data.crop_width = args.crop_size
    if args.synthetic_train_records is not None:
        cfg.data.synthetic_train_records = args.synthetic_train_records
    # Seed the data stream from the run seed, as the JAX CLI does.
    cfg.data.seed = args.seed
    cfg.model.name = args.model
    cfg.model.compute_dtype = args.compute_dtype
    cfg.optim.learning_rate = args.learning_rate
    cfg.optim.optimizer = args.optimizer
    cfg.optim.momentum = args.momentum
    cfg.optim.weight_decay = args.weight_decay
    cfg.optim.ema_decay = args.ema_decay
    cfg.optim.fused_optimizer = args.fused_optimizer
    cfg.optim.schedule = args.schedule
    cfg.optim.warmup_steps = args.warmup_steps
    cfg.optim.cosine_decay_steps = args.cosine_decay_steps
    if args.schedule == "cosine" and not args.cosine_decay_steps:
        cfg.optim.cosine_decay_steps = cfg.total_steps
    if args.pool is not None:
        cfg.model.pool = args.pool
    for f in ("vit_heads", "vit_dim", "vit_depth"):
        if getattr(args, f) is not None:
            setattr(cfg.model, f, getattr(args, f))
    cfg.model.remat = args.remat
    cfg.model.attn_causal = args.attn_causal
    cfg.model.attn_window = args.attn_window
    return cfg


def main(argv: Optional[List[str]] = None) -> int:
    args, unparsed = build_parser().parse_known_args(argv)
    if unparsed:
        print(f"[cli] ignoring unrecognized args: {unparsed}",
              file=sys.stderr)

    if args.job_name == "ps":
        # The reference blocks a whole process on server.join()
        # (cifar10cnn.py:191-192). Parameters live on the device here.
        print("[cli] job_name=ps is obsolete: parameters live on the "
              "device. Nothing to serve; exiting.")
        return 0
    if len([h for h in args.worker_hosts.split(",") if h]) > 1:
        raise NotImplementedError(
            "multi-GPU data parallelism (--worker_hosts with several "
            "hosts) is not ported yet; see ROADMAP.md Queue 1, slice 3")

    cfg = config_from_args(args)
    if args.mode == "eval":
        cfg.eval_full_test_set = True
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, task_index=args.task_index)
    try:
        if args.mode == "eval":
            _evaluate(trainer)
        else:
            result = trainer.fit()
            print(f"[cli] done at step {result.final_step}; "
                  f"{result.images_per_sec:.1f} images/sec")
    finally:
        trainer.logger.close()
    return 0


def _evaluate(trainer) -> None:
    """``--mode eval``: restore the newest checkpoint, sweep the full
    test split, print the reference's accuracy line."""
    from dml_cnn_cifar10_tpu_torch.data import pipeline as pipe
    cfg = trainer.cfg
    state = trainer.init_or_restore()
    step = int(state.step)
    if step == 0:
        print(f"[cli] warning: no checkpoint under {cfg.log_dir}; "
              "evaluating fresh-initialized weights", file=sys.stderr)
    test_it = pipe.input_pipeline(cfg.data, cfg.batch_size, train=False,
                                  seed=cfg.seed)
    acc = trainer.evaluate(state, test_it)
    print(f" --- Test Accuracy = {acc * 100:.2f}%.")
    print(f"[cli] eval at step {step}: {acc * 100:.2f}% on "
          f"{test_it.total_records} records")


if __name__ == "__main__":
    sys.exit(main())
