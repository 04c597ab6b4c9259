"""Serving: dynamic micro-batching inference over the exported artifact
(or live checkpoint weights), behind a stdlib HTTP server.

Port of ``dml_cnn_cifar10_tpu/serve/``: single-image requests become
padded batches at a few bucket sizes, each bucket one captured CUDA graph
on the card, with admission control, deadline shedding, checkpoint
hot-swap and latency accounting on the JSONL stream.
"""

from dml_cnn_cifar10_tpu_torch.serve.batcher import (  # noqa: F401
    MicroBatcher,
    ShedError,
    VersionedLogits,
)
from dml_cnn_cifar10_tpu_torch.serve.engine import ServingEngine  # noqa: F401
from dml_cnn_cifar10_tpu_torch.serve.metrics import ServeMetrics  # noqa: F401
