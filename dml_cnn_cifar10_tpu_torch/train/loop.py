"""The training driver.

Port of ``dml_cnn_cifar10_tpu/train/loop.py``'s single-device,
one-step-per-dispatch path, which replaces the reference's worker branch
(``cifar10cnn.py:193-242``): restore-if-present, the step loop, periodic
checkpoints, stop at the global step. Console cadence is parity: the
training line every ``output_every`` (200) local steps, an eval line
every ``eval_every`` (500) (``cifar10cnn.py:232-241``).

Faithful-mode details mirrored deliberately:
- Train accuracy at the 200-step mark is computed on a *fresh* train batch
  (``cifar10cnn.py:235``), not the batch just trained on.
- Eval is one *shuffled* test batch (``cifar10cnn.py:202,238``);
  ``eval_full_test_set=True`` (fixed mode) sweeps the whole split.
- The stop condition is the *global* step, like ``StopAtStepHook``
  (``cifar10cnn.py:219``), so restore + finish works.

The host reads the device only at those boundaries: the loss and the
fresh-batch accuracy (one copy), the eval count, and the checkpoint.

Several processes (``ParallelConfig.num_processes`` > 1) form one
``data x seq`` mesh (``parallel/mesh.py``), one card each at
``cuda:{rank % device_count}``: each data rank trains on its
``batch_size // data`` slice of the global batch, read from its own
``[data_rank::data]`` shard of the records; the seq ranks of one data
row read the same slice and split its tokens. The chief generates the
synthetic data and writes the checkpoints; every rank prints its own
console lines, and only the chief writes the metrics JSONL. ``images/s``
counts the global batch.

Chunked dispatch (``steps_per_dispatch`` K > 1, one process): K steps a
call through ``parallel/step.py:make_train_chunk*``, one CUDA graph replay
a chunk on the card. By default the uint8 train split is resident on the
device (``resident_data``, up to ``resident_data_max_bytes``) and the
device index stream (``data.device_index_stream``) draws its rows from
``state.step``: a training dispatch moves nothing host→device, the
boundary evals gather from resident splits too, and a resumed run
continues the data order exactly, because the stream position is the
step. With the device stream off the host ships each chunk's indices;
past the size cap it ships raw uint8 chunks. The cadences and the steps
to run must be multiples of K. Several processes with K > 1 raise:
capturing NCCL collectives in the graph is not ported.

Left out: the supervisor, peers, fault injection, the autopilot, and
exact-resume data order on the host streams (a resumed run restarts the
host data stream from its seed, as the reference's MonitoredTrainingSession
restart does).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from dml_cnn_cifar10_tpu_torch import ckpt as ckpt_lib
from dml_cnn_cifar10_tpu_torch.config import TrainConfig
from dml_cnn_cifar10_tpu_torch.data import device_stream, download
from dml_cnn_cifar10_tpu_torch.data import pipeline as pipe
from dml_cnn_cifar10_tpu_torch.models.registry import get_model
from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
from dml_cnn_cifar10_tpu_torch.parallel import multihost
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
from dml_cnn_cifar10_tpu_torch.train import optim as optim_lib
from dml_cnn_cifar10_tpu_torch.utils.logging import MetricsLogger
from dml_cnn_cifar10_tpu_torch.utils.platform import (default_backend,
                                                      rank_device)


@dataclasses.dataclass
class TrainResult:
    final_step: int
    images_per_sec: float
    state: step_lib.TrainState


class Trainer:
    def __init__(self, cfg: TrainConfig, task_index: int = 0):
        self.cfg = cfg
        self.task_index = task_index
        par = cfg.parallel
        k = self.steps_per_dispatch = max(1, cfg.steps_per_dispatch)
        if k > 1 and par.num_processes > 1:
            raise ValueError(
                f"steps_per_dispatch={k} runs on one process only: a chunk "
                f"is one CUDA graph, and capturing the NCCL collectives of "
                f"{par.num_processes} ranks in it is not ported yet "
                f"(ROADMAP.md Queue 1); use steps_per_dispatch=1")
        self.device = rank_device(cfg.device, par.process_id)
        if par.num_processes > 1:
            backend = par.dist_backend or default_backend(self.device)
            multihost.initialize(par, backend, self.device)
        self.mesh = mesh_lib.build_mesh(par)
        m = self.mesh
        if cfg.batch_size % m.data:
            raise ValueError(f"batch_size {cfg.batch_size} does not split "
                             f"over {m.data} data rank(s)")
        self.local_batch = cfg.batch_size // m.data
        if m.world > 1:
            print(f"[dist] rank {m.rank}/{m.world} (data {m.data_rank}/"
                  f"{m.data}, seq {m.seq_rank}/{m.seq}) on {self.device}, "
                  f"backend {m.backend}, {self.local_batch} images a step",
                  flush=True)
            # One writer for the shared synthetic files; the others wait.
            if m.chief:
                download.ensure_dataset(cfg.data)
            m.barrier()
        self.model = get_model(cfg.model.name)(cfg.model, cfg.data, mesh=m)
        self.logger = MetricsLogger(cfg.metrics_jsonl if m.chief else None,
                                    task_index=task_index)
        self.train_step = step_lib.make_train_step(self.model, cfg.optim, m)
        self.eval_step = step_lib.make_eval_step(self.model, m)
        if k > 1:
            # The steps to run are checked in fit(), against the resume
            # point.
            for name in ("output_every", "eval_every", "checkpoint_every"):
                if getattr(cfg, name) % k:
                    raise ValueError(
                        f"{name}={getattr(cfg, name)} must be a multiple "
                        f"of steps_per_dispatch={k} so every observable "
                        f"boundary lands on a dispatch edge")
            self.train_chunk = step_lib.make_train_chunk(
                self.model, cfg.optim, data_cfg=cfg.data)
        # Resident-eval functions, set up by fit() on the resident path.
        self._resident_full_eval = None
        self._resident_test_eval = None
        #: The last fit's step or chunk function (its graph's replay
        #: count, its index stream's table: for inspection).
        self.train_fn = None

    def init_or_restore(self) -> step_lib.TrainState:
        """Fresh state from ``cfg.seed``, overwritten by the newest
        verifiable checkpoint in ``log_dir`` when there is one."""
        gen = torch.Generator().manual_seed(self.cfg.seed)
        state = step_lib.init_train_state(self.model, self.cfg.optim,
                                          self.device, gen)
        return ckpt_lib.restore_checkpoint(self.cfg.log_dir, state)

    def _placed(self, batch: pipe.Batch):
        return pipe.to_device(batch, self.device)

    def input_pipeline(self, train: bool, seed: int
                       ) -> pipe.ShuffleBatchIterator:
        """This data rank's shard of a split, at the per-rank batch."""
        shard = self.mesh.data_rank
        return pipe.input_pipeline(self.cfg.data, self.local_batch,
                                   train=train, seed=seed + shard,
                                   shard=shard, num_shards=self.mesh.data)

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(idx).to(self.device)

    def evaluate(self, state: step_lib.TrainState,
                 test_it: pipe.ShuffleBatchIterator) -> float:
        """Faithful: accuracy on ONE shuffled test batch
        (``cifar10cnn.py:202,238``); fixed: full-split sweep with
        fixed-shape padded batches, the count summed on the device (and
        over the data ranks' shards) and read once. On the resident path
        (set up by ``fit``) the test split is on the device and the batch
        is index-fed, or the sweep is one call."""
        if self.cfg.eval_full_test_set:
            if self._resident_full_eval is not None:
                fn, total = self._resident_full_eval
                return int(fn(state)) / max(total, 1)
            correct = None
            for batch in test_it.full_sweep_padded():
                c = self.eval_step(state, *self._placed(batch))["correct"]
                correct = c if correct is None else correct + c
            if correct is None:
                return 0.0
            return int(correct) / max(test_it.total_records, 1)
        if self._resident_test_eval is not None:
            idx = self._index(test_it.next_index_chunk(1)[0])
            return float(self._resident_test_eval(state, idx))
        m = self.eval_step(state, *self._placed(next(test_it)))
        return float(m["accuracy"])

    def fit(self, total_steps: Optional[int] = None,
            state: Optional[step_lib.TrainState] = None) -> TrainResult:
        cfg = self.cfg
        total_steps = total_steps or cfg.total_steps
        state = state if state is not None else self.init_or_restore()
        start_step = int(state.step)
        k = self.steps_per_dispatch
        if (total_steps - start_step) % k:
            # The loop advances k at a time and must land exactly on the
            # stop step (StopAtStepHook parity, cifar10cnn.py:219).
            raise ValueError(
                f"remaining steps {total_steps - start_step} (stop "
                f"{total_steps}, resume {start_step}) must be a multiple "
                f"of steps_per_dispatch={k}")
        train_it = self.input_pipeline(train=True, seed=cfg.seed)
        test_it = self.input_pipeline(train=False, seed=cfg.seed)
        # Fresh-batch train accuracy (cifar10cnn.py:235) — an independent
        # stream over the same decoded arrays.
        acc_it = train_it.clone(seed=cfg.seed + 7 + self.mesh.data_rank)
        self._resident_full_eval = self._resident_test_eval = None
        acc_eval = None        # index-fed boundary accuracy (resident)
        stream_check = None    # the device stream's miss check
        resident = (k > 1 and cfg.resident_data
                    and getattr(train_it, "supports_index_stream", False)
                    and _split_bytes(train_it)
                    <= cfg.resident_data_max_bytes)
        if resident:
            # The uint8 splits live on the device; a chunk gathers and
            # decodes its rows there (parallel/step.py).
            host_imgs, host_lbls = _full_split_arrays(
                train_it, lambda: pipe.input_pipeline(
                    cfg.data, self.local_batch, train=True, seed=cfg.seed))
            ds_images = torch.from_numpy(host_imgs).to(self.device)
            ds_labels = torch.from_numpy(
                host_lbls.astype(np.int64)).to(self.device)
            dev_stream = cfg.data.device_index_stream
            if dev_stream:
                # uint32 stream positions: refuse runs that would wrap.
                device_stream.check_supported_range(total_steps,
                                                    cfg.batch_size)
            step_fn = step_lib.make_train_chunk_resident(
                self.model, cfg.optim, ds_images, ds_labels,
                data_cfg=cfg.data,
                index_stream=((cfg.data.seed, cfg.batch_size, k)
                              if dev_stream else None))
            acc_eval = step_lib.make_batch_eval_resident(
                self.model, ds_images, ds_labels, cfg.data)
            if cfg.eval_full_test_set:
                self._resident_full_eval = step_lib.make_eval_resident(
                    self.model, test_it.images, test_it.labels, cfg.data,
                    self.device, batch_size=self.local_batch,
                    expected_batches=test_it.num_padded_sweep_batches())
            else:
                self._resident_test_eval = step_lib.make_batch_eval_resident(
                    self.model,
                    torch.from_numpy(test_it.images).to(self.device),
                    torch.from_numpy(test_it.labels.astype(np.int64)).to(
                        self.device), cfg.data)
            if dev_stream:
                # The chunk generates its own rows: no inputs at all.
                prefetch = _NoInputs()
                stream_check = step_fn.check
            else:
                prefetch = pipe.PrefetchIterator(
                    iter(lambda: (self._index(train_it.next_index_chunk(k)),),
                         None), depth=cfg.data.prefetch)
        elif k > 1:
            # Host-fed chunks: the host gathers raw uint8 bytes; the decode
            # runs on the device inside the chunk.
            def produce():
                b = train_it.next_raw_chunk(k)
                return (torch.from_numpy(b.images).to(self.device),
                        torch.from_numpy(b.labels.astype(np.int64)).to(
                            self.device))

            prefetch = pipe.PrefetchIterator(iter(produce, None),
                                             depth=cfg.data.prefetch)
            step_fn = self.train_chunk
        else:
            prefetch = pipe.PrefetchIterator(train_it,
                                             depth=cfg.data.prefetch,
                                             place=self._placed)
            step_fn = self.train_step

        self.train_fn = step_fn

        def boundary_check():
            # Before anything of the window is logged or saved.
            if stream_check is not None:
                stream_check()

        ckpt_mgr = ckpt_lib.CheckpointManager(
            cfg.log_dir, cfg.checkpoint_every, keep=cfg.keep_checkpoints,
            mesh=self.mesh)
        metrics = None
        # Throughput windows run between drained boundaries and skip the
        # boundary work (eval, checkpoint) itself.
        mark_t, mark_step = None, start_step
        run_t0 = None

        print("Starting Training")  # parity: cifar10cnn.py:225
        i = 0  # local step, like the reference's `i` (cifar10cnn.py:224)
        global_step = start_step
        try:
            while global_step < total_steps:
                state, metrics = step_fn(state, *next(prefetch))
                global_step += k
                if run_t0 is None:
                    # First dispatch done enqueueing: one-time set-up (CUDA
                    # context, cuDNN plans, the graph's capture) is behind
                    # us.
                    run_t0 = mark_t = time.perf_counter()
                    mark_step = global_step
                drained = False
                if (i + k) % cfg.output_every == 0:
                    if acc_eval is not None:
                        acc_t = acc_eval(state, self._index(
                            acc_it.next_index_chunk(1)[0]))
                    else:
                        acc_t = self.eval_step(
                            state, *self._placed(next(acc_it)))["accuracy"]
                    fetched = torch.stack([metrics["loss"], acc_t]).tolist()
                    boundary_check()
                    now = time.perf_counter()
                    rate = ((global_step - mark_step) * cfg.batch_size
                            / max(now - mark_t, 1e-9))
                    loss, acc = fetched
                    self.logger.train_print(global_step, i + k - 1, acc)
                    self.logger.log(
                        "train", step=global_step, loss=loss,
                        train_accuracy=acc, images_per_sec=rate,
                        lr=_current_lr(cfg, global_step),
                        # Device-side step estimates and the optimizer
                        # profile are not ported: null, never a host number.
                        device_step_ms=None, drain_wait_ms=None,
                        optimizer_ms=None)
                    drained = True
                if (i + k) % cfg.eval_every == 0:
                    boundary_check()
                    ta = self.evaluate(state, test_it)
                    self.logger.eval_print(ta)
                    self.logger.log("eval", step=global_step,
                                    test_accuracy=ta)
                    drained = True
                if ckpt_mgr.due(global_step):
                    boundary_check()
                if ckpt_mgr.maybe_save(state, global_step):
                    drained = True
                if drained:
                    mark_t, mark_step = time.perf_counter(), global_step
                i += k
            avg_rate = 0.0
            if run_t0 is not None:
                float(metrics["loss"])  # waits for the last step
                avg_rate = ((global_step - start_step) * cfg.batch_size
                            / max(time.perf_counter() - run_t0, 1e-9))
            boundary_check()
            ckpt_mgr.maybe_save(state, global_step, force=True)
            self.logger.log("done", step=global_step, images_per_sec=avg_rate)
        finally:
            prefetch.close()
            self.logger.flush()
        return TrainResult(global_step, avg_rate, state)


class _NoInputs:
    """The device stream's "prefetch": a chunk that takes no inputs."""

    def __next__(self):
        return ()

    def close(self):
        pass


def _split_bytes(it: pipe.ShuffleBatchIterator) -> int:
    """Bytes of the FULL split behind ``it`` (the resident size cap is
    judged on it)."""
    per_record = int(np.prod(it.images.shape[1:])) * it.images.dtype.itemsize
    return it.total_records * per_record


def _full_split_arrays(it: pipe.ShuffleBatchIterator, reload_fn):
    """``(images, labels)`` of the FULL split backing a possibly-sharded
    iterator. A sharded iterator holds strided views (``arr[shard::
    num_shards]``) whose ``.base`` is the full decoded split in order:
    reuse it instead of decoding the files again, or reload the split if
    the views stop matching."""
    if it.num_shards == 1:
        return it.images, it.labels
    base_i, base_l = it.images.base, it.labels.base
    n = it.total_records
    if (isinstance(base_i, np.ndarray) and isinstance(base_l, np.ndarray)
            and base_i.shape == (n, *it.images.shape[1:])
            and base_l.shape[:1] == (n,)):
        return base_i, base_l
    full = reload_fn()
    return full.images, full.labels


def _current_lr(cfg: TrainConfig, step: int) -> float:
    """Host mirror of ``optim.learning_rate`` for the metrics log (no
    device read at the boundary)."""
    return float(optim_lib.learning_rate(
        cfg.optim, torch.tensor(step, dtype=torch.int32)))
