"""PyTorch + CUDA port of ``dml_cnn_cifar10_tpu`` for NVIDIA Hopper.

Module paths mirror the JAX package's, so each module's counterpart is
found by path. The package imports ``torch`` and numpy and nothing of
JAX or of the JAX package. Entry points run on ``cuda`` unless the caller
asks for the CPU (``--device cpu`` / ``device="cpu"``).
"""
