"""Graceful shutdown: SIGTERM/SIGINT set a flag instead of killing.

A copy of ``dml_cnn_cifar10_tpu/utils/preemption.py``, read by two
loops. The trainer (``train/loop.py:Trainer.fit``) polls it after every
dispatch: on SIGTERM (the standard preemption warning on managed pools)
or SIGINT it finishes the dispatch, checkpoints, logs a ``preempt``
record and returns; several ranks first agree on the flag, so they stop
at the same step. ``--mode serve`` (``serve/server.py:main_serve``) stops
accepting, drains what is queued, flushes its final metrics and exits 0.
``installed`` says whether the handlers are in place: Python lets only the
main thread set them, and a caller off it must say so rather than leave
SIGTERM to kill the process unnoticed.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional


class PreemptionGuard:
    """Context manager: installs SIGTERM/SIGINT handlers that set a flag
    instead of killing the process. Poll ``requested``. No-ops (flag
    stays False, no handlers touched) when not in the main thread, where
    Python forbids ``signal.signal``."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.requested = False
        #: True while this guard's handlers are installed.
        self.installed = False
        self.signum: Optional[int] = None
        self._saved = {}

    def _handle(self, signum, frame):
        del frame
        self.requested = True
        self.signum = signum

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for s in self.SIGNALS:
                self._saved[s] = signal.signal(s, self._handle)
            self.installed = True
        return self

    def __exit__(self, *exc) -> None:
        for s, old in self._saved.items():
            signal.signal(s, old)
        self._saved.clear()
        self.installed = False
        return None
