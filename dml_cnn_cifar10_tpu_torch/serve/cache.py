"""Exact-match response cache: (input digest, serving version) -> the
finished response payload.

A copy of ``dml_cnn_cifar10_tpu/serve/cache.py``. Inputs repeat more than
one would think (health probes, canaries, replayed load-generator
corpora, client retries), and an exact hit costs one SHA-1 over 3 KB of
pixels where a miss costs a queue wait and a device dispatch. Hits bypass
the batcher and count as ``cache_hit`` in the serve windows.

Every entry generation is bound to ONE serving version, and the cache
flushes itself the moment a lookup or store sees another one (the
hot-swap flush): a response computed by version N never answers while
version M serves. ``--serve_cache_size`` (0 = off) bounds the LRU. One
instance is shared by every handler thread, all mutation under one lock.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional


class ResponseCache:
    """Thread-safe exact-match LRU, one generation per serving version."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("ResponseCache needs capacity >= 1 "
                             "(0 means: don't construct one)")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self._version: Optional[str] = None
        self.hits = 0
        self.misses = 0
        self.flushes = 0   # version-change flushes (hot-swaps observed)

    @staticmethod
    def digest(body: bytes) -> bytes:
        return hashlib.sha1(body).digest()

    def _sync_version(self, version: str) -> None:
        # caller holds the lock
        if version != self._version:
            if self._version is not None and self._entries:
                self.flushes += 1
            self._entries.clear()
            self._version = version

    def lookup(self, body: bytes, version: str) -> Optional[dict]:
        """The cached payload for this exact input under the CURRENT
        serving version, or None. Seeing a new version flushes the
        previous generation (the hot-swap flush)."""
        key = self.digest(body)
        with self._lock:
            self._sync_version(str(version))
            payload = self._entries.get(key)
            if payload is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return payload

    def store(self, body: bytes, version: str, payload: dict) -> None:
        """Cache a finished response under the version that COMPUTED it
        (``VersionedLogits.version``) — if a swap landed between
        dispatch and completion, the generation check just drops it."""
        key = self.digest(body)
        with self._lock:
            self._sync_version(str(version))
            self._entries[key] = payload
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
