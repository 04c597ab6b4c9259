"""Host-side input pipeline: CIFAR record files, numpy decode/crop,
shuffled batches, pinned host→device prefetch."""

from dml_cnn_cifar10_tpu_torch.data.download import (  # noqa: F401
    ensure_dataset,
    generate_synthetic_dataset,
    test_files,
    train_files,
)
from dml_cnn_cifar10_tpu_torch.data.pipeline import (  # noqa: F401
    Batch,
    PrefetchIterator,
    ShuffleBatchIterator,
    input_pipeline,
)
