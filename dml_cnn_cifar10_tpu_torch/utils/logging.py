"""Console + JSONL metrics logging.

The reference prints at a 200/500-step cadence (``cifar10cnn.py:226-241``).
This keeps its exact console lines and also writes every record as one
JSON line, with the JAX package's record kinds and field names
(``dml_cnn_cifar10_tpu/utils/logging.py``), so
``tools/check_jsonl_schema.py`` reads the port's stream too.

With ``tensorboard_dir`` every numeric field of a record that carries a
``step`` also goes to TensorBoard event files as the scalar
``<kind>/<field>``, the JAX logger's tags, through ``tensorboardX``,
imported only then: without the package the logger raises ``ImportError``
at construction, before any step runs.

Every record also feeds the process-local metrics registry
(``utils/metrics_registry.py:observe_record``, what ``GET /metrics``
renders) and any observer attached with :meth:`MetricsLogger.add_observer`,
as the JAX logger does. Both are host work on numbers the record already
carries, and both are fail-open.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Optional

from dml_cnn_cifar10_tpu_torch.utils import metrics_registry


def _finite(v):
    """NaN/Inf → None so every line stays strict JSON (faithful runs with
    the reference's LR 0.1 on raw pixels do NaN)."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


class MetricsLogger:
    def __init__(self, jsonl_path: Optional[str] = None, task_index: int = 0,
                 tensorboard_dir: Optional[str] = None):
        self.task_index = task_index
        self._lock = threading.Lock()
        self._file = None
        # Observers see (kind, fields) for every record, called outside
        # the write lock (an observer may log in turn).
        self._observers = []
        # The TensorBoard writer first: without tensorboardX nothing is
        # created before the ImportError.
        self._tb = None
        if tensorboard_dir:
            try:
                from tensorboardX import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    f"--tensorboard_dir {tensorboard_dir!r} needs the "
                    f"tensorboardX package, which this Python cannot "
                    f"import ({e}); install it or drop the flag") from e
            self._tb = SummaryWriter(log_dir=tensorboard_dir)
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._file = open(jsonl_path, "a", buffering=1)
        self._t0 = time.time()

    def add_observer(self, fn) -> None:
        """Attach ``fn(kind, fields)`` to every later record (idempotent
        by identity)."""
        if fn not in self._observers:
            self._observers.append(fn)

    def log(self, kind: str, **fields) -> None:
        if self._file is not None:
            rec = {"kind": kind, "t": round(time.time() - self._t0, 4),
                   "task": self.task_index,
                   **{k: _finite(v) for k, v in fields.items()}}
            line = json.dumps(rec, allow_nan=False) + "\n"
            with self._lock:
                if self._file is not None:
                    self._file.write(line)
        if self._tb is not None and "step" in fields:
            step = fields["step"]
            for k, v in fields.items():
                # bool is an int: flag fields (hbm's available) stay out.
                if k != "step" and isinstance(v, (int, float)) \
                        and not isinstance(v, bool) \
                        and _finite(v) is not None:
                    self._tb.add_scalar(f"{kind}/{k}", v, step)
        # The live feeds come after the sink, so a broken observer cannot
        # lose the persisted record.
        metrics_registry.observe_record(kind, fields)
        for fn in self._observers:
            try:
                fn(kind, fields)
            except Exception:
                pass

    def train_print(self, global_step: int, local_step: int,
                    train_accuracy: float) -> None:
        # Byte-for-byte the reference's training line (cifar10cnn.py:234-235).
        print("global_step %s, task:%d_step %d, training accuracy %g"
              % (global_step, self.task_index, local_step, train_accuracy))

    def eval_print(self, test_accuracy: float) -> None:
        # Reference's eval line (cifar10cnn.py:240-241).
        print(" --- Test Accuracy = {:.2f}%.".format(100.0 * test_accuracy))

    def flush(self) -> None:
        """Force both sinks to disk (tensorboardX writes from a daemon
        thread that dies unflushed at interpreter exit)."""
        with self._lock:
            if self._file is not None:
                self._file.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
