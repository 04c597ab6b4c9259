"""Checkpoints in the JAX package's msgpack layout."""

from dml_cnn_cifar10_tpu_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointManager,
    latest_checkpoint,
    load_data_state,
    restore_checkpoint,
    save_checkpoint,
    save_data_state,
)
