"""Device-side shuffled index generation: the host-free data stream.

Port of ``dml_cnn_cifar10_tpu/data/device_stream.py``. The shuffled
dataset row for any (seed, global stream position) is a pure function,
computed on the device, so a resident training dispatch
(``parallel/step.py:make_train_chunk_resident`` with ``index_stream``)
moves nothing host→device and a resumed run continues the data order
exactly: the stream position is ``state.step · batch``.

Design (the JAX module's): a per-epoch pseudo-random permutation of
``[0, n)`` by a cycle-walking balanced Feistel network over the next
even-bit power-of-two domain ``2^bits``, keyed on (seed, epoch). Every
epoch visits every record exactly once. The rows are bit-equal to the JAX
module's for every (seed, position, n) (``tests/test_torch_device_stream.py``).

Integers. The JAX module computes in uint32. torch on the CPU has no
uint32 ``>>``, ``%`` or ``//``, so every value here is an int64 tensor
holding a uint32 (``0 <= v < 2^32``), masked back into that range after
every operation that can leave it. A product of two 32-bit values can
reach 2^64 and overflow int64, so :func:`_mul32` splits the constant into
16-bit halves and keeps every intermediate below 2^49; nothing relies on
signed wrap-around. ``seed * _C0 ^ epoch * _C1`` is ``(seed·C0) ^
(epoch·C1)``, both mod 2^32, and ``j0 + arange`` wraps mod 2^32, as in
the JAX module.

Cycle walking. ``bits = max(2, bitlen(n - 1))``, rounded up to even, so
``n <= 2^bits < 4n``. A walk pass takes a value outside ``[0, n)`` back
inside with chance ``n / 2^bits``, which lies in (1/4, 1]: 0.763 at n =
50,000 (2^16), 0.610 at 10,000 (2^14), 0.250 at 4,097 (2^14). (The JAX
comment's "> 3/4" holds only when ``2^bits < 4n/3``.) So after w passes an
element is still outside with chance up to about 0.75^w, and in the worst
case a walk is as long as the domain has points outside ``[0, n)``
(12,287 at n = 4,097): no fixed pass count is safe. :func:`_rows` walks
exactly, a ``while (o >= n).any()`` loop that reads the device once a
pass, as the JAX ``while_loop`` does.

Inside a CUDA graph no host read is allowed, so the graphed chunk does not
walk. :class:`EpochRows` computes each epoch's whole permutation with the
exact walk, outside the capture, into a device table of a few epochs, and
the captured chunk only gathers its ``[K, B]`` rows from it by
``state.step``. The table is refreshed between replays when a chunk reaches
a new epoch: a handful of host reads once per epoch (every ~390 steps of
CIFAR-10 at batch 128), not once per chunk, and no host→device copy. A
fixed number of walk passes inside the graph was rejected: each pass is
~90 tensor operations, and the worst case above needs on the order of a
hundred passes a chunk. The graph counts on the device every row it
gathered from a slot that did not hold its epoch (``misses``); the trainer
reads that count at every boundary and :meth:`EpochRows.check` raises if
it is not 0.

Supported range: positions are uint32, so the stream is exact for the
first 2^32 samples (``step · batch + i < 2^32``); past that the position
wraps. :func:`check_supported_range` raises at build time from the planned
``total_steps × batch``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_C0 = 0x9E3779B9
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B

_ROUNDS = 4

Step = Union[int, torch.Tensor]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x · c) mod 2^32`` for an int64 tensor ``x`` in ``[0, 2^32)`` and a
    constant ``c`` in ``[0, 2^32)``: ``c`` in 16-bit halves, every
    intermediate below 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 integer hash (uint32 → uint32), the Feistel round
    function's mixer; also the port's counter-based draw for the device
    augmentations (``ops/preprocess.py``)."""
    x = _mul32(x ^ (x >> 16), _MIX1)
    x = _mul32(x ^ (x >> 15), _MIX2)
    return x ^ (x >> 16)


def _round_keys(key: torch.Tensor):
    """The JAX ``_feistel``'s per-round ``_mix(key ^ r·C2)``, which do not
    change along a walk: computed once."""
    return [_mix(key ^ ((r * _C2) & _M32)) for r in range(_ROUNDS)]


def _feistel(pos: torch.Tensor, round_keys, half_bits: int) -> torch.Tensor:
    """One balanced-Feistel pass over a ``2·half_bits``-bit domain."""
    mask = (1 << half_bits) - 1
    hi = pos >> half_bits
    lo = pos & mask
    for rk in round_keys:
        f = _mix(lo ^ rk) & mask
        hi, lo = lo, hi ^ f
    return (hi << half_bits) | lo


def _half_bits(n: int) -> int:
    if n <= 0:
        raise ValueError(f"need a positive dataset size, got {n}")
    bits = max(2, (n - 1).bit_length())
    bits += bits % 2                      # balanced halves
    return bits // 2


def _rows(seed: int, epoch: torch.Tensor, pos: torch.Tensor,
          n: int) -> Tuple[torch.Tensor, int]:
    """Rows of positions ``pos`` (int64, in ``[0, n)``) of the
    epoch-``epoch`` permutation, by the exact cycle walk; with the number
    of host reads the walk made (one a pass)."""
    half_bits = _half_bits(n)
    key = _mix(((seed & _M32) * _C0 & _M32) ^ _mul32(epoch, _C1))
    rks = _round_keys(key)
    out = _feistel(pos, rks, half_bits)
    reads = 0
    while True:
        outside = out >= n
        reads += 1
        if not bool(outside.any()):
            return out, reads
        out = torch.where(outside, _feistel(out, rks, half_bits), out)


def _as_u32(x: Step, device: Optional[torch.device]) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.tensor(int(x) & _M32, dtype=torch.int64, device=device)


def _positions_to_rows(seed: int, j0: Step, count: int, n: int,
                       device: Optional[torch.device] = None
                       ) -> torch.Tensor:
    """``[count]`` int64 rows of the infinite shuffled stream ``perm_0 ++
    perm_1 ++ …`` at positions ``j0 .. j0+count-1`` (mod 2^32), where
    ``perm_e`` is the epoch-``e`` pseudo-permutation of ``[0, n)``. ``j0``
    is an int or a 0-d integer tensor (then the rows are on its device)."""
    _half_bits(n)
    j0 = _as_u32(j0, device)
    j = (j0 + torch.arange(count, dtype=torch.int64, device=j0.device)) \
        & _M32
    return _rows(seed, j // n, j % n, n)[0]


def check_supported_range(total_steps: int, batch: int) -> None:
    """Raise if a planned run would walk the stream past the uint32
    position domain (the silent-wrap hazard: module docstring)."""
    if total_steps * batch >= 1 << 32:
        raise ValueError(
            f"device index stream positions are uint32: total_steps="
            f"{total_steps} x batch={batch} = {total_steps * batch} "
            f"samples >= 2^32 would wrap the stream position and repeat "
            f"the epoch sequence. Use --device_index_stream=false for "
            f"runs this long.")


def _start(step: Step, batch: int,
           device: Optional[torch.device]) -> torch.Tensor:
    """Stream position ``step · batch`` mod 2^32 (uint32 product)."""
    return _mul32(_as_u32(step, device), batch & _M32)


def epoch_shuffle_indices(seed: int, step: Step, batch: int, n: int,
                          device: Optional[torch.device] = None
                          ) -> torch.Tensor:
    """``[batch]`` rows for global ``step``: one batch of the stream
    (position ``step · batch``)."""
    return _positions_to_rows(seed, _start(step, batch, device), batch, n)


def chunk_shuffle_indices(seed: int, step0: Step, batch: int, k: int,
                          n: int, device: Optional[torch.device] = None
                          ) -> torch.Tensor:
    """``[k, batch]`` rows for steps ``step0 .. step0+k-1``, the whole
    chunk's indices in one vectorized call."""
    flat = _positions_to_rows(seed, _start(step0, batch, device),
                              batch * k, n)
    return flat.reshape(k, batch)


class EpochRows:
    """The stream's rows for a ``k``-step chunk of ``batch``, gathered
    from a device table of whole epochs: the form a captured CUDA graph
    runs (module docstring).

    :meth:`prepare` (host, outside any capture) makes the table hold every
    epoch of the chunk that starts at a host-known step; :meth:`lookup`
    (device only, capturable) returns that chunk's ``[k, batch]`` rows
    from ``state.step`` and adds to :attr:`misses` every row whose slot
    held another epoch; :meth:`check` reads :attr:`misses` and raises if
    it is not 0. The rows equal :func:`chunk_shuffle_indices`'s.
    """

    def __init__(self, seed: int, batch: int, k: int, n: int,
                 device: torch.device):
        _half_bits(n)
        self.seed, self.batch, self.k, self.n = seed, batch, k, n
        # A chunk spans at most this many consecutive epochs, and
        # consecutive epochs land in distinct slots (epoch mod slots).
        self.slots = (k * batch - 1) // n + 2
        self.table = torch.zeros((self.slots, n), dtype=torch.int64,
                                 device=device)
        self.slot_epoch = torch.full((self.slots,), -1, dtype=torch.int64,
                                     device=device)
        self.misses = torch.zeros((), dtype=torch.int64, device=device)
        self._offsets = torch.arange(k * batch, dtype=torch.int64,
                                     device=device)
        self._pos = torch.arange(n, dtype=torch.int64, device=device)
        # Epochs in one 2^32 cycle of positions. A chunk that wraps past
        # 2^32 runs on into epoch 0; its epochs are numbered on from the
        # cycle's last (epoch + _wrap), so a chunk's epochs stay
        # consecutive and never share a slot.
        self._wrap = _M32 // n + 1
        self._held = [-1] * self.slots
        #: Epoch tables built, and the host reads their walks made.
        self.epochs_built = 0
        self.host_reads = 0

    def prepare(self, step: int) -> None:
        """Fill the slots of the epochs that the chunk starting at global
        ``step`` reads (host arithmetic; the walk runs on the device)."""
        j0 = ((step & _M32) * (self.batch & _M32)) & _M32
        u = j0 + np.arange(self.k * self.batch, dtype=np.uint64)
        numbered = (u & _M32) // self.n + (u >> 32) * self._wrap
        for v in np.unique(numbered).tolist():
            s = v % self.slots
            if self._held[s] == v:
                continue
            epoch = torch.full_like(self._pos, v % self._wrap)
            rows, reads = _rows(self.seed, epoch, self._pos, self.n)
            self.table[s].copy_(rows)
            self.slot_epoch[s].fill_(v)
            self._held[s] = v
            self.epochs_built += 1
            self.host_reads += reads

    def lookup(self, step: torch.Tensor) -> torch.Tensor:
        """``[k, batch]`` rows of the chunk at ``step`` (a 0-d device
        tensor), from the table; no host read."""
        u = _start(step, self.batch, None) + self._offsets    # < 2^33
        j = u & _M32
        numbered = j // self.n + (u >> 32) * self._wrap
        slot = numbered % self.slots
        self.misses += (self.slot_epoch[slot] != numbered).sum()
        return self.table[slot, j % self.n].reshape(self.k, self.batch)

    def check(self) -> None:
        """Raise if a graphed chunk gathered a row from a slot that did
        not hold its epoch (a host read: call it at a boundary)."""
        missed = int(self.misses)
        if missed:
            raise RuntimeError(
                f"device index stream: {missed} row(s) were gathered from "
                f"a table slot that did not hold their epoch (the chunk's "
                f"host step and state.step disagree); the data order of "
                f"this window is wrong")
