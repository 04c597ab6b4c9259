"""Shuffled batching + host→device prefetch.

The reference's input pipeline is a TF queue graph drained 128 at a time
(``cifar10cnn.py:72-91,223``). As in the JAX package, the port keeps the
contract — an endless stream of shuffled, decoded, cropped batches — as
vectorized numpy on the host, with a background thread that copies each
batch to the card from pinned memory ahead of the step. The batches are
the JAX package's for the same seed (same numpy draws in the same order).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from dml_cnn_cifar10_tpu_torch.config import DataConfig
from dml_cnn_cifar10_tpu_torch.data import download, records as rec


class Batch(NamedTuple):
    images: np.ndarray  # [B, crop_h, crop_w, C] float32
    labels: np.ndarray  # [B] int32


def _load_split(files: List[str], cfg: DataConfig):
    """Decode all shards once, as uint8 HWC (cast happens per batch); the
    records lead with the dataset's label bytes (``download.label_bytes``:
    CIFAR-100's fine label is the second, ``imagenet_synth``'s two are one
    big-endian uint16)."""
    nlb = download.label_bytes(cfg)
    record_bytes = cfg.record_bytes + (nlb - 1)
    imgs, labs = [], []
    for path in files:
        r = rec.read_record_file(path, record_bytes)
        i, l = rec.decode_records(r, cfg, label_offset=nlb - 1,
                                  dtype=np.uint8,
                                  wide_label=download.wide_label(cfg))
        imgs.append(i)
        labs.append(l)
    return np.concatenate(imgs, axis=0), np.concatenate(labs, axis=0)


class ShuffleBatchIterator:
    """Endless shuffled batches over an in-memory decoded split.

    Contract parity with ``tf.train.shuffle_batch`` (``cifar10cnn.py:85-90``):
    endless repetition, per-epoch reshuffle (a fresh uniform permutation),
    fixed batch size. ``shard``/``num_shards`` keep every
    ``num_shards``-th record from ``shard`` on (the JAX package's
    ``[shard::num_shards]`` split); ``total_records`` stays the count
    before the split, the denominator of a distributed full-split eval.
    """

    def __init__(self, files: List[str], cfg: DataConfig, batch_size: int,
                 train: bool = True, seed: int = 0, shard: int = 0,
                 num_shards: int = 1, _arrays=None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.train = train
        self.rng = np.random.default_rng(seed)
        images, labels = _arrays if _arrays is not None \
            else _load_split(files, cfg)
        self.total_records = images.shape[0]
        self.num_shards = num_shards
        if num_shards > 1:
            images, labels = images[shard::num_shards], labels[shard::num_shards]
        self.images, self.labels = images, labels
        self.n = images.shape[0]
        self._perm = self.rng.permutation(self.n)
        self._cursor = 0

    def clone(self, seed: int) -> "ShuffleBatchIterator":
        """Second independent stream over the SAME decoded arrays — the
        fresh-batch train-accuracy stream (``cifar10cnn.py:235``)."""
        it = ShuffleBatchIterator([], self.cfg, self.batch_size,
                                  train=self.train, seed=seed,
                                  _arrays=(self.images, self.labels))
        it.total_records, it.num_shards = self.total_records, self.num_shards
        return it

    def _next_indices(self, k: int) -> np.ndarray:
        out = np.empty(k, dtype=np.int64)
        filled = 0
        while filled < k:
            take = min(k - filled, self.n - self._cursor)
            out[filled : filled + take] = self._perm[
                self._cursor : self._cursor + take]
            filled += take
            self._cursor += take
            if self._cursor == self.n:  # epoch boundary: reshuffle, repeat
                self._perm = self.rng.permutation(self.n)
                self._cursor = 0
        return out

    def _finish(self, images: np.ndarray) -> np.ndarray:
        """uint8 [N,H,W,C] → cropped/augmented/normalized float32 batch."""
        cfg = self.cfg
        images = images.astype(np.float32)
        if self.train and cfg.random_crop:
            images = rec.random_crop(images, cfg.crop_height, cfg.crop_width,
                                     self.rng)
        else:
            images = rec.center_crop(images, cfg.crop_height, cfg.crop_width)
        if self.train and cfg.random_flip:
            images = rec.random_flip(images, self.rng)
        if self.train and cfg.random_brightness:
            images = rec.random_brightness(images, cfg.random_brightness,
                                           self.rng)
        if self.train and cfg.random_contrast:
            images = rec.random_contrast(images, cfg.random_contrast,
                                         self.rng)
        return np.ascontiguousarray(rec.normalize(images, cfg.normalize))

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        idx = self._next_indices(self.batch_size)
        return Batch(self._finish(self.images[idx]), self.labels[idx])

    #: The shuffled stream has an index view (:meth:`next_index_chunk`),
    #: which the device-resident chunked path needs.
    supports_index_stream = True

    #: :meth:`skip_batches` can fast-forward the stream: the basis of the
    #: exact-resume data order (``train/loop.py``).
    supports_skip = True

    # The augmentations skip_batches replays. A new field in
    # DataConfig._AUG_OFF needs its draw mirrored below (and a case in
    # tests/test_torch_resume.py or tests/test_torch_augment.py);
    # skip_batches raises until it has one.
    _SKIP_MIRRORED_AUGS = frozenset({"random_crop", "random_flip",
                                     "random_brightness",
                                     "random_contrast"})

    def skip_batches(self, n: int, aug: bool = False) -> None:
        """Fast-forward the stream by ``n`` batches without building them:
        the same index draws and, with ``aug=True``, the same per-batch
        augmentation draws that ``_finish`` makes on the host-decode path,
        so the next batch is the one an unskipped iterator of the same
        seed gives after ``n`` (the JAX package's
        ``data/pipeline.py:158-210``)."""
        cfg = self.cfg
        b = self.batch_size
        if not (aug and self.train and cfg.augmented):
            # A chunked draw is cursor-equivalent to n single draws; draw
            # at most one epoch at a time (memory O(dataset)).
            remaining = b * n
            cap = max(self.n, 1)
            while remaining > 0:
                take = min(remaining, cap)
                self._next_indices(take)
                remaining -= take
            return
        active = {name for name, off in cfg._AUG_OFF
                  if getattr(cfg, name) != off}
        unmirrored = active - self._SKIP_MIRRORED_AUGS
        if unmirrored:
            raise NotImplementedError(
                f"skip_batches has no draw mirror for {sorted(unmirrored)}")
        for _ in range(n):
            self._next_indices(b)
            if cfg.random_crop:
                self.rng.integers(
                    0, cfg.image_height - cfg.crop_height + 1, size=b)
                self.rng.integers(
                    0, cfg.image_width - cfg.crop_width + 1, size=b)
            if cfg.random_flip:
                self.rng.random(b)
            if cfg.random_brightness:
                self.rng.uniform(-cfg.random_brightness,
                                 cfg.random_brightness, b)
            if cfg.random_contrast:
                self.rng.uniform(1.0 - cfg.random_contrast,
                                 1.0 + cfg.random_contrast, b)

    def next_index_chunk(self, k: int) -> np.ndarray:
        """``[k, B]`` int64 shuffled indices into ``self.images`` /
        ``self.labels``: the stream of :meth:`next_raw_chunk` without the
        gather, for the resident path, which gathers on the device."""
        return self._next_indices(self.batch_size * k).reshape(
            k, self.batch_size)

    def next_raw_chunk(self, k: int) -> Batch:
        """``k`` stacked shuffled batches of RAW uint8 full-size images
        (``[k, B, H, W, C]``; no crop, cast or normalize) for the device
        decode (``ops/preprocess.py``): one gather a chunk."""
        idx = self._next_indices(self.batch_size * k)
        ims = self.images[idx].reshape(
            k, self.batch_size, *self.images.shape[1:])
        return Batch(ims, self.labels[idx].reshape(k, self.batch_size))

    def num_padded_sweep_batches(self) -> int:
        """Batches every shard contributes, so a sharded sweep issues the
        same number of collective steps on every rank (strided shards
        differ by at most one record)."""
        max_shard = -(-self.total_records // max(self.num_shards, 1))
        return -(-max_shard // self.batch_size)

    def full_sweep_padded(self) -> Iterator[Batch]:
        """Fixed-shape single pass: every batch has exactly ``batch_size``
        rows; pad rows carry label -1 (never an argmax in [0, K)), so they
        add 0 correct predictions. Every shard yields the same count."""
        for b in range(self.num_padded_sweep_batches()):
            start = min(b * self.batch_size, self.n)
            stop = min(start + self.batch_size, self.n)
            images = self._finish(self.images[start:stop])
            labels = self.labels[start:stop]
            pad = self.batch_size - images.shape[0]
            if pad:
                images = np.pad(images, ((0, pad), (0, 0), (0, 0), (0, 0)))
                labels = np.pad(labels, (0, pad), constant_values=-1)
            yield Batch(images, labels)


def to_device(batch: Batch, device: torch.device):
    """``(images, labels)`` tensors on ``device``. On the card the copy
    goes through pinned host memory and does not block the host."""
    images = torch.from_numpy(batch.images)
    labels = torch.from_numpy(batch.labels.astype(np.int64, copy=False))
    if device.type == "cuda":
        return (images.pin_memory().to(device, non_blocking=True),
                labels.pin_memory().to(device, non_blocking=True))
    return images.to(device), labels.to(device)


class PrefetchIterator:
    """Background-thread prefetch: overlap host batching and the
    host→device copy with the running step (the queue-runner role,
    ``cifar10cnn.py:223``). ``place`` runs on the prefetch thread."""

    _DONE = object()

    def __init__(self, it: Iterator[Batch], depth: int = 2,
                 place: Optional[Callable] = None):
        self._it = it
        self._place = place or (lambda b: b)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that re-checks the stop flag — never parks forever."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set() or not self._put(self._place(item)):
                    return
        except BaseException as e:  # re-raised on the consumer side
            self._err = e
        finally:
            if not self._stop.is_set():
                self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the producer and join it (drains so its pending put can
        observe the stop flag)."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)


def input_pipeline(cfg: DataConfig, batch_size: int, train: bool = True,
                   seed: int = 0, shard: int = 0,
                   num_shards: int = 1) -> ShuffleBatchIterator:
    """Batch iterator for the train or test split (``input_pipeline``,
    ``cifar10cnn.py:72-91``). Like the reference, the test split is
    shuffle-batched too; ``full_sweep_padded`` is the full-split eval.

    A multi-rank run shards by DATA rank (``shard`` = data rank,
    ``num_shards`` = data ranks), so the seq ranks of one data row read
    the same batch and split its tokens (or, the CNN, its image rows),
    and its pipeline stages read it too. The JAX package shards by
    process (``train/loop.py:376-397``) because its sequence parallelism
    runs inside one process's mesh."""
    download.ensure_dataset(cfg)
    files = download.train_files(cfg) if train else download.test_files(cfg)
    return ShuffleBatchIterator(files, cfg, batch_size, train=train,
                                seed=seed, shard=shard,
                                num_shards=num_shards)
