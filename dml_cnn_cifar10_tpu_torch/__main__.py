"""``python -m dml_cnn_cifar10_tpu_torch`` — the port's CLI."""

import sys

from dml_cnn_cifar10_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
