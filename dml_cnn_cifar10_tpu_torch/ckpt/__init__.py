"""Checkpoints in the JAX package's msgpack layout."""

from dml_cnn_cifar10_tpu_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointManager,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
