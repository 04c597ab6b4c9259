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
Left out of this slice: the supervisor, peers, fault injection, the
autopilot, chunked/resident dispatch and exact-resume data order (a
resumed run restarts the data stream from its seed, as the reference's
MonitoredTrainingSession restart does).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from dml_cnn_cifar10_tpu_torch import ckpt as ckpt_lib
from dml_cnn_cifar10_tpu_torch.config import TrainConfig
from dml_cnn_cifar10_tpu_torch.data import pipeline as pipe
from dml_cnn_cifar10_tpu_torch.models.registry import get_model
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
from dml_cnn_cifar10_tpu_torch.train import optim as optim_lib
from dml_cnn_cifar10_tpu_torch.utils.logging import MetricsLogger
from dml_cnn_cifar10_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass
class TrainResult:
    final_step: int
    images_per_sec: float
    state: step_lib.TrainState


class Trainer:
    def __init__(self, cfg: TrainConfig, task_index: int = 0):
        self.cfg = cfg
        self.task_index = task_index
        self.device = resolve_device(cfg.device)
        self.model = get_model(cfg.model.name)(cfg.model, cfg.data)
        self.logger = MetricsLogger(cfg.metrics_jsonl, task_index=task_index)
        self.train_step = step_lib.make_train_step(self.model, cfg.optim)
        self.eval_step = step_lib.make_eval_step(self.model)

    def init_or_restore(self) -> step_lib.TrainState:
        """Fresh state from ``cfg.seed``, overwritten by the newest
        verifiable checkpoint in ``log_dir`` when there is one."""
        gen = torch.Generator().manual_seed(self.cfg.seed)
        state = step_lib.init_train_state(self.model, self.cfg.optim,
                                          self.device, gen)
        return ckpt_lib.restore_checkpoint(self.cfg.log_dir, state)

    def _placed(self, batch: pipe.Batch):
        return pipe.to_device(batch, self.device)

    def evaluate(self, state: step_lib.TrainState,
                 test_it: pipe.ShuffleBatchIterator) -> float:
        """Faithful: accuracy on ONE shuffled test batch
        (``cifar10cnn.py:202,238``); fixed: full-split sweep with
        fixed-shape padded batches, the count summed on the device and
        read once."""
        if self.cfg.eval_full_test_set:
            correct = None
            for batch in test_it.full_sweep_padded():
                c = self.eval_step(state, *self._placed(batch))["correct"]
                correct = c if correct is None else correct + c
            if correct is None:
                return 0.0
            return int(correct) / max(test_it.total_records, 1)
        m = self.eval_step(state, *self._placed(next(test_it)))
        return float(m["accuracy"])

    def fit(self, total_steps: Optional[int] = None,
            state: Optional[step_lib.TrainState] = None) -> TrainResult:
        cfg = self.cfg
        total_steps = total_steps or cfg.total_steps
        state = state if state is not None else self.init_or_restore()
        start_step = int(state.step)
        train_it = pipe.input_pipeline(cfg.data, cfg.batch_size, train=True,
                                       seed=cfg.seed)
        test_it = pipe.input_pipeline(cfg.data, cfg.batch_size, train=False,
                                      seed=cfg.seed)
        # Fresh-batch train accuracy (cifar10cnn.py:235) — an independent
        # stream over the same decoded arrays.
        acc_it = train_it.clone(seed=cfg.seed + 7)
        prefetch = pipe.PrefetchIterator(train_it, depth=cfg.data.prefetch,
                                         place=self._placed)
        ckpt_mgr = ckpt_lib.CheckpointManager(
            cfg.log_dir, cfg.checkpoint_every, keep=cfg.keep_checkpoints)
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
                images, labels = next(prefetch)
                state, metrics = self.train_step(state, images, labels)
                global_step += 1
                if run_t0 is None:
                    # First step done enqueueing: one-time set-up (CUDA
                    # context, cuDNN plans) is behind us.
                    run_t0 = mark_t = time.perf_counter()
                    mark_step = global_step
                drained = False
                if (i + 1) % cfg.output_every == 0:
                    acc_t = self.eval_step(
                        state, *self._placed(next(acc_it)))["accuracy"]
                    fetched = torch.stack([metrics["loss"], acc_t]).tolist()
                    now = time.perf_counter()
                    rate = ((global_step - mark_step) * cfg.batch_size
                            / max(now - mark_t, 1e-9))
                    loss, acc = fetched
                    self.logger.train_print(global_step, i, acc)
                    self.logger.log(
                        "train", step=global_step, loss=loss,
                        train_accuracy=acc, images_per_sec=rate,
                        lr=_current_lr(cfg, global_step),
                        # Device-side step estimates and the optimizer
                        # profile are not ported: null, never a host number.
                        device_step_ms=None, drain_wait_ms=None,
                        optimizer_ms=None)
                    drained = True
                if (i + 1) % cfg.eval_every == 0:
                    ta = self.evaluate(state, test_it)
                    self.logger.eval_print(ta)
                    self.logger.log("eval", step=global_step,
                                    test_accuracy=ta)
                    drained = True
                if ckpt_mgr.maybe_save(state, global_step):
                    drained = True
                if drained:
                    mark_t, mark_step = time.perf_counter(), global_step
                i += 1
            avg_rate = 0.0
            if run_t0 is not None:
                float(metrics["loss"])  # waits for the last step
                avg_rate = ((global_step - start_step) * cfg.batch_size
                            / max(time.perf_counter() - run_t0, 1e-9))
            ckpt_mgr.maybe_save(state, global_step, force=True)
            self.logger.log("done", step=global_step, images_per_sec=avg_rate)
        finally:
            prefetch.close()
            self.logger.flush()
        return TrainResult(global_step, avg_rate, state)


def _current_lr(cfg: TrainConfig, step: int) -> float:
    """Host mirror of ``optim.learning_rate`` for the metrics log (no
    device read at the boundary)."""
    return float(optim_lib.learning_rate(
        cfg.optim, torch.tensor(step, dtype=torch.int32)))
