"""Typed configuration for the PyTorch port.

A copy of the fields of ``dml_cnn_cifar10_tpu/config.py`` that the
port's paths read (the reference CNN trainer, the ViT), with the same
defaults and the same reference ``file:line`` notes. The reference keeps
every hyperparameter
as a module-level constant (``cifar10cnn.py:9-27``); here they are
dataclass fields so parity runs are the zero-config path.

Fidelity switches (faithful by default, like the JAX package):
(1) ReLU applied to the logits (``cifar10cnn.py:145``),
(2) a dead LR-decay schedule (``cifar10cnn.py:161,216`` — effective LR is
    a constant 0.1),
(3) eval on a single *shuffled* 128-image test batch rather than the full
    test set (``cifar10cnn.py:202,238``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class DataConfig:
    """Input pipeline config. Reference: ``cifar10cnn.py:9-27,34-91``."""

    dataset: str = "cifar10"              # cifar10 | synthetic
    data_dir: str = "cifar10data"         # reference constant (cifar10cnn.py:26)
    image_height: int = 32                # cifar10cnn.py:15
    image_width: int = 32                 # cifar10cnn.py:16
    crop_height: int = 24                 # cifar10cnn.py:17
    crop_width: int = 24                  # cifar10cnn.py:18
    num_channels: int = 3                 # cifar10cnn.py:19
    num_classes: int = 10                 # cifar10cnn.py:20 (NUM_TARGETS)
    # Reference crop is a deterministic center crop despite the "Randomly
    # Crop" comment (cifar10cnn.py:67-68). random_crop=True enables the
    # augmentation the comment intended (fixed mode).
    random_crop: bool = False
    random_flip: bool = False
    # Pixel normalization. The reference feeds raw 0..255 floats
    # (cifar10cnn.py:66 — cast, no scaling); "scale" maps to [0,1];
    # "standardize" is tf.image.per_image_standardization.
    normalize: str = "none"               # none | scale | standardize
    prefetch: int = 2                     # host->device prefetch depth
    seed: int = 0
    # Synthetic mode generates CIFAR-format .bin files locally (same
    # 3073-byte record layout) for air-gapped testing/benchmarking.
    synthetic_train_records: int = 2048
    synthetic_test_records: int = 512

    @property
    def record_bytes(self) -> int:
        """1 label byte + H*W*C image bytes (cifar10cnn.py:24-25)."""
        return 1 + self.image_height * self.image_width * self.num_channels


@dataclasses.dataclass
class ModelConfig:
    """Model selection + faithful-mode switches."""

    name: str = "cnn"                     # cnn | vit_tiny
    num_classes: int = 10
    # Reference applies ReLU to the final logits (cifar10cnn.py:145).
    # Faithful mode keeps it; fixed mode emits raw logits.
    logit_relu: bool = True
    # Initializers: truncated normal sigma=0.05 (cifar10cnn.py:97-98),
    # bias constant 0.1 (cifar10cnn.py:100-101).
    init_stddev: float = 0.05
    bias_init: float = 0.1
    dtype: str = "float32"                # param dtype
    compute_dtype: str = "float32"        # activations: float32 | bfloat16
    # ViT-specific knobs (ignored by the CNN).
    patch_size: int = 4
    vit_dim: int = 192
    vit_depth: int = 12
    vit_heads: int = 3
    # The JAX package's use_pallas_attention switch is not copied: its
    # default (True) is the port's only route — the hand-written CUDA flash
    # kernels from 128 tokens up (ops/attention.py:dispatch_attention).
    # "cls" = prepend a class token (standard ViT head). "mean" = no class
    # token, mean-pool the tokens (the long-context mode).
    pool: str = "cls"                     # cls | mean
    # Recompute each transformer block's activations in the backward pass
    # instead of storing them (torch.utils.checkpoint around the block):
    # ~1 extra forward of FLOPs for activation memory O(1) in depth.
    remat: bool = False
    # Sliding-window (local) attention width: None = full attention. Band
    # |row - col| < attn_window, composed with attn_causal.
    attn_window: Optional[int] = None
    # Causal (autoregressive) attention mask for the transformer blocks.
    attn_causal: bool = False


@dataclasses.dataclass
class OptimConfig:
    """Optimizer/schedule. Reference: ``cifar10cnn.py:21-23,159-164``."""

    learning_rate: float = 0.1            # cifar10cnn.py:21
    lr_decay: float = 0.9                 # cifar10cnn.py:22
    decay_every: int = 250                # NUM_GENS_TO_WAIT (cifar10cnn.py:23)
    staircase: bool = True                # cifar10cnn.py:161
    # Faithful mode: the reference's decay is keyed on a variable that is
    # never incremented (cifar10cnn.py:216), so the effective LR is a
    # constant 0.1. dead_lr_decay=True reproduces that.
    dead_lr_decay: bool = True
    momentum: float = 0.0                 # reference uses plain SGD
    weight_decay: float = 0.0
    schedule: str = "exponential"         # exponential | cosine | constant
    warmup_steps: int = 0
    cosine_decay_steps: int = 0
    # "sgd" (+ optional momentum) is the reference's; "adamw" (decoupled
    # weight decay, bias-corrected moments) the transformer standard. The
    # JAX package's lars/lamb/adafactor are not ported and raise.
    optimizer: str = "sgd"                # sgd | adamw
    # Label smoothing ε for the CE loss (0 = reference parity).
    label_smoothing: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    # Eval-time parameter EMA (0 disables); no reference counterpart.
    ema_decay: float = 0.0
    # Fused single-pass SGD update (ops/optimizer.py): weight decay +
    # momentum + LR in ONE pass over the param bytes — a hand-written
    # CUDA kernel on the card. False keeps the per-transform chain.
    fused_optimizer: bool = True


@dataclasses.dataclass
class TrainConfig:
    """Training driver. Reference: ``cifar10cnn.py:11-14,219-242``."""

    batch_size: int = 128                 # per-step GLOBAL batch (cifar10cnn.py:13)
    total_steps: int = 20000              # GENERATIONS (cifar10cnn.py:14)
    output_every: int = 200               # OUTPUT_EVERY (cifar10cnn.py:11)
    eval_every: int = 500                 # EVAL_EVERY (cifar10cnn.py:12)
    # Faithful mode evaluates one shuffled test batch (cifar10cnn.py:202,238);
    # fixed mode sweeps the full test set.
    eval_full_test_set: bool = False
    log_dir: str = "/tmp/train_logs"      # checkpoint dir (cifar10cnn.py:269-272)
    checkpoint_every: int = 1000          # steps; MTS default was 600s wall-clock
    keep_checkpoints: int = 3
    metrics_jsonl: Optional[str] = None   # structured metrics sink
    seed: int = 0
    # Where the port runs: "cuda" (the default; raises when no card is
    # present) or "cpu", which the caller must ask for.
    device: str = "cuda"

    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)


def reference_config(**overrides) -> TrainConfig:
    """The exact reference hyperparameters (faithful quirks on)."""
    cfg = TrainConfig()
    for k, v in overrides.items():
        if not hasattr(cfg, k):
            raise AttributeError(f"unknown TrainConfig field {k!r}")
        setattr(cfg, k, v)
    return cfg


def fixed_config(**overrides) -> TrainConfig:
    """Reference hyperparameters with the quirks fixed (sane defaults)."""
    cfg = reference_config(**overrides)
    cfg.model.logit_relu = False
    cfg.optim.dead_lr_decay = False
    cfg.data.random_crop = True
    cfg.data.random_flip = True
    cfg.data.normalize = "standardize"
    cfg.eval_full_test_set = True
    return cfg
