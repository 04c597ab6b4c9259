"""Console + JSONL metrics logging.

The reference prints at a 200/500-step cadence (``cifar10cnn.py:226-241``).
This keeps its exact console lines and also writes every record as one
JSON line, with the JAX package's record kinds and field names
(``dml_cnn_cifar10_tpu/utils/logging.py``), so
``tools/check_jsonl_schema.py`` reads the port's stream too.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Optional


def _finite(v):
    """NaN/Inf → None so every line stays strict JSON (faithful runs with
    the reference's LR 0.1 on raw pixels do NaN)."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


class MetricsLogger:
    def __init__(self, jsonl_path: Optional[str] = None, task_index: int = 0):
        self.task_index = task_index
        self._lock = threading.Lock()
        self._file = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._file = open(jsonl_path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, kind: str, **fields) -> None:
        if self._file is None:
            return
        rec = {"kind": kind, "t": round(time.time() - self._t0, 4),
               "task": self.task_index,
               **{k: _finite(v) for k, v in fields.items()}}
        line = json.dumps(rec, allow_nan=False) + "\n"
        with self._lock:
            if self._file is not None:
                self._file.write(line)

    def train_print(self, global_step: int, local_step: int,
                    train_accuracy: float) -> None:
        # Byte-for-byte the reference's training line (cifar10cnn.py:234-235).
        print("global_step %s, task:%d_step %d, training accuracy %g"
              % (global_step, self.task_index, local_step, train_accuracy))

    def eval_print(self, test_accuracy: float) -> None:
        # Reference's eval line (cifar10cnn.py:240-241).
        print(" --- Test Accuracy = {:.2f}%.".format(100.0 * test_accuracy))

    def flush(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
