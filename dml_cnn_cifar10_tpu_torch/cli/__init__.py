"""Command line (``python -m dml_cnn_cifar10_tpu_torch``)."""
