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
``data x model x seq x pipe`` mesh (``parallel/mesh.py``), one card each,
a rank's card being its index among the ranks of its own host in
``--worker_hosts`` (``utils/platform.py:rank_device``): each data rank
trains on its ``batch_size // data`` slice of the global batch, read from
its own ``[data_rank::data]`` shard of the records; the model, seq and
pipe ranks of one data row read the same slice, the model ranks to split
the Megatron layers' weights (``--model_axis``, ``parallel/tp.py``), the
seq ranks to split the ViT's tokens or, after the decode, the CNN's image
rows (``parallel/spatial.py``), the pipe ranks to run the ViT's blocks as
pipeline stages (``--pipe_axis``, ``parallel/pipeline.py``). The chief
(rank 0: data rank 0, stage 0) generates the synthetic data and writes
the checkpoints; every rank prints its own
console lines, and only the chief writes the metrics JSONL. ``images/s``
counts the global batch.

Chunked dispatch (``steps_per_dispatch`` K > 1): K steps a call through
``parallel/step.py:make_train_chunk*``, one CUDA graph replay a chunk on
the card, its NCCL collectives captured in it. By default the uint8 train
split is resident on the device (``resident_data``, up to
``resident_data_max_bytes``, judged on the whole split) and the device
index stream (``data.device_index_stream``) draws its rows from
``state.step``: a training dispatch moves nothing host→device, the
boundary evals gather from resident splits too, and a resumed run
continues the data order exactly, because the stream position is the
step. With the device stream off the host ships each chunk's indices;
past the size cap it ships raw uint8 chunks. The cadences and the steps
to run must be multiples of K. Over several processes (JAX ``train/
loop.py:455-545``) every rank holds the whole split and takes its data
rank's columns of the global rows; host indices, drawn from the rank's
shard, ship as rows of the whole split; the full-split eval sums each
data rank's strided shard; the host-fed path ships each rank its own
shard's raw chunks. Over gloo on the card a chunk runs its K steps
eagerly (its collectives stage through host memory); the ``[dist]`` line
says which.

Exact resume (JAX ``train/loop.py:449-455,702-727``): every checkpoint
gets a ``data_state_{step}.json`` sidecar with the batches each host
stream (train, fresh-batch accuracy, single-batch test) has consumed, and
a resumed run skips its streams past them (``skip_batches``, replaying
the augmentation draws the host decode makes), so the eager, host-index
and host-fed runs continue their data order exactly, as the device index
stream does by construction.

Run telemetry, all on numbers the host already has (JAX
``train/loop.py:752-1055``): each ``train`` record carries
``device_step_ms`` and ``drain_wait_ms`` (``utils/devprof.py``
``DeviceStepEstimator``: two clock reads around the boundary's one fetch),
``tflops_per_sec_per_chip`` (the step's FLOPs, the update's included,
counted once at start by ``utils/profiling.py:step_flops``, times the
steps a second) and, with ``peak_tflops``, ``mfu``; the first also carries
``flops_stack``, what the count means. ``profile_at_steps`` arms a
torch.profiler window whose trace becomes ``devtime`` records, and later
``train`` records carry its ``optimizer_ms``. On a chunked run the window
opens no earlier than the second dispatch (the first captures the graph,
whose profiled warm-up tells the window which replayed kernels are the
update's).

Run safety (JAX ``train/loop.py:582-1215``):

- ``check_numerics`` reads the loss the boundary already read; a
  non-finite one triggers ``on_nonfinite``: ``halt`` logs
  ``numerics_halt`` and raises ``FloatingPointError``; ``rollback`` logs a
  ``fault`` and raises it for the run supervisor (``train/
  supervisor.py``); ``skip`` logs
  ``fault`` and ``recovery``, copies the state kept at the last finite
  boundary back INTO the state's tensors (a chunk's CUDA graph is bound to
  their addresses, and K1/K2 update them in place: holding a reference is
  not a snapshot) and sets the step counter in place to the detection
  step, so the data, which the device index stream draws from the step,
  moves forward as in JAX; past ``recovery_retries`` skips it halts. A
  due save under ``check_numerics`` reads the last dispatch's loss first
  (the only extra device read, and only then) and never writes a
  non-finite state.
- ``fault_spec`` fires its step-seam faults (``utils/faults.py``) before
  the dispatch.
- ``PreemptionGuard``: one process stops after the dispatch that follows a
  SIGTERM/SIGINT; several ranks exchange ``[preempt, time_due]`` once
  every ``max(1, preempt_sync_every // k)`` dispatches, in one all-reduce
  over the mesh, eagerly between dispatches (never inside a graph), and
  stop, or take a wall-clock save, together. The stop saves a checkpoint
  (with its data-state sidecar, so the resume is exact), logs ``preempt``
  and returns ``preempted``. A trainer off the main thread cannot catch
  signals: it says so on stderr, and refuses a ``sigterm`` fault.
- ``checkpoint_every_secs`` saves on the clock too; ``async_checkpoint``
  writes on the manager's writer thread (``ckpt/checkpoint.py``), closed
  in ``finally``.
- ``telemetry``: spans (``data_wait``, ``compile_first_dispatch`` then
  ``dispatch``, ``boundary_drain``, ``eval``, ``checkpoint``,
  ``preempt_allgather``; ``utils/telemetry.py``), flushed as ``span``,
  ``goodput`` and ``hbm`` records at each metrics boundary and once at the
  end (``final``), and the Chrome trace written at exit, a failed run's
  too. ``health_metrics``: the step's three health scalars join the
  boundary's one device read. ``tensorboard_dir``: the logger's event
  files.
- A model with experts (``vit_moe``): its router stats ride the same read
  into the ``train`` records, ``moe_aux_loss``, ``moe_dropped_frac`` and
  ``moe_expert_load`` (a list of E), rounded to 5 places (JAX
  ``train/loop.py:961-1003``).
- On the card the start-up line ``[trainer] <model> on cuda:N: ...``
  names the cuDNN mode the step builders set
  (``parallel/step.py:f32_parity``: deterministic algorithms).

Sharded state (JAX ``train/loop.py:143-188``): ``--optimizer_sharding
zero1`` or ``--fsdp`` builds one layout (``parallel/zero.py``) from the
model's rule table (``--partition_rules``, ``--partition_rules_strict``);
the state is allocated as each rank's shards, and the step, the chunks
(eager or graphed) and the evals read the layout from the state.
``--partition_report`` prints the which-rule-matched-which-param table on
the chief. ``--ckpt_format sharded`` writes ``ckpt_<step>.sharded/``
(every rank its own shards, ``--shard_io_threads`` files at once) and its
``shard_io`` records join the metrics stream; restore reads either
format into any layout.

A run supervisor drives the trainer as the JAX package's does (JAX
``train/loop.py:66-69``): it passes ONE ``fault_injector``, ONE
``cluster`` monitor and ONE ``logger`` to every attempt's trainer, and the
trainer closes only what it built itself. With a cluster monitor
(``--cluster_dir``, ``parallel/cluster.py``) each dispatch seam publishes a
beat, checks for eviction and arms the watchdog (``begin_step``), fires the
step faults (which may stall the beats, end the process or wedge the
seam), waits at the lockstep barrier (``sync``, simulation only) and
disarms (``end_step``); the checkpoint and eval phases name themselves in
the beats (``set_phase``). ``init_or_restore`` fires the faults' ``@restore``
seam, and every checkpoint the restore walk skips is a ``ckpt_fallback``
record (``--restore_deadline_s`` budgets the walk). With
``--peer_redundancy`` every committed save also pushes this rank's shard
payload to the peer store (``ckpt/peerstore.py``), and a restart decided
``source="peer"`` restores from the replicas before any disk walk. A
data-seam failure is a ``DataPipelineError``. With
``cluster_lockstep`` the trainer opens no process group, whatever
``num_processes`` says: each process is a world of its own (the JAX
package's CPU simulation), and a preempted non-chief (``process_id`` > 0)
exits without saving, since the chief owns the checkpoints (JAX
``train/loop.py:1148-1170``).

Left out: the autopilot.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Optional

import numpy as np
import torch

from dml_cnn_cifar10_tpu_torch import ckpt as ckpt_lib
from dml_cnn_cifar10_tpu_torch.ckpt import peerstore as peerstore_lib
from dml_cnn_cifar10_tpu_torch.config import TrainConfig
from dml_cnn_cifar10_tpu_torch.data import device_stream, download
from dml_cnn_cifar10_tpu_torch.data import pipeline as pipe
from dml_cnn_cifar10_tpu_torch.models.registry import get_model
from dml_cnn_cifar10_tpu_torch.parallel import cluster as cluster_lib
from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
from dml_cnn_cifar10_tpu_torch.parallel import multihost
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
from dml_cnn_cifar10_tpu_torch.parallel import zero
from dml_cnn_cifar10_tpu_torch.train import optim as optim_lib
from dml_cnn_cifar10_tpu_torch.utils import devprof, profiling
from dml_cnn_cifar10_tpu_torch.utils import faults as faults_lib
from dml_cnn_cifar10_tpu_torch.utils import telemetry as telemetry_lib
from dml_cnn_cifar10_tpu_torch.utils.logging import MetricsLogger
from dml_cnn_cifar10_tpu_torch.utils.preemption import PreemptionGuard
from dml_cnn_cifar10_tpu_torch.utils.platform import (default_backend,
                                                      rank_device)


@dataclasses.dataclass
class TrainResult:
    final_step: int
    images_per_sec: float
    state: step_lib.TrainState
    preempted: bool = False


class Trainer:
    def __init__(self, cfg: TrainConfig, task_index: int = 0,
                 fault_injector=None, cluster=None, logger=None):
        self.cfg = cfg
        self.task_index = task_index
        if cfg.on_nonfinite not in ("halt", "skip", "rollback"):
            raise ValueError(
                f"on_nonfinite={cfg.on_nonfinite!r} must be one of "
                f"halt | skip | rollback")
        if cfg.trace_events_path and not cfg.telemetry:
            raise ValueError("trace_events_path needs telemetry=True (the "
                             "spans it writes are the tracer's)")
        # Deterministic fault injection (utils/faults.py); a bad spec
        # fails here, before any set-up. The supervisor passes ONE
        # injector across its attempts so fired events stay fired.
        self.faults = fault_injector if fault_injector is not None \
            else faults_lib.FaultInjector.from_spec(cfg.fault_spec)
        par = cfg.parallel
        k = self.steps_per_dispatch = max(1, cfg.steps_per_dispatch)
        self.device = rank_device(cfg.device, par.process_id,
                                  par.worker_hosts)
        if par.num_processes > 1 and not par.cluster_lockstep:
            backend = par.dist_backend or default_backend(self.device)
            multihost.initialize(par, backend, self.device)
        self.mesh = mesh_lib.build_mesh(par)
        m = self.mesh
        if cfg.batch_size % m.data:
            raise ValueError(f"batch_size {cfg.batch_size} does not split "
                             f"over {m.data} data rank(s)")
        self.local_batch = cfg.batch_size // m.data
        if m.world > 1:
            chunks = ""
            if k > 1:
                if self.device.type != "cuda":
                    how = "the eager body, on the CPU"
                elif step_lib.chunk_is_graphed(m):
                    how = ("one CUDA graph replay each, its NCCL "
                           "collectives captured")
                else:
                    how = ("the eager body: gloo stages each collective "
                           "through host memory, which a CUDA graph "
                           "cannot hold")
                chunks = f"; chunks of {k} steps: {how}"
            stage = f", pipe {m.pipe_rank}/{m.pipe}" if m.pipe > 1 else ""
            print(f"[dist] rank {m.rank}/{m.world} (data {m.data_rank}/"
                  f"{m.data}, model {m.model_rank}/{m.model}, seq "
                  f"{m.seq_rank}/{m.seq}{stage}) on {self.device}, "
                  f"backend {m.backend}, {self.local_batch} images a step"
                  f"{chunks}", flush=True)
            # One writer for the shared synthetic files; the others wait.
            if m.chief:
                download.ensure_dataset(cfg.data)
            m.barrier()
        self.model = get_model(cfg.model.name)(cfg.model, cfg.data, mesh=m)
        if self.device.type == "cuda":
            # The step builders below set it (parallel/step.py:f32_parity).
            print(f"[trainer] {cfg.model.name} on {self.device}: "
                  f"{step_lib.CUDNN_MODE}", flush=True)
        # The state layout, built once (parallel/zero.py): None keeps every
        # leaf whole on every rank.
        self.layout = zero.build_layout(self.model, cfg.model.name,
                                        cfg.optim, par, m)
        if par.partition_report and m.chief:
            print("[shardings] partition report (params):")
            print(zero.partition_report(self.model, cfg.model.name, par))
        split = getattr(self.model, "split", None)
        if split is not None and split.over == "pipe":
            rows = next(iter(split.slices.values())).length
            print(f"[shardings] pipe_axis={m.pipe}: stage {m.pipe_rank} "
                  f"holds {rows} of {cfg.model.vit_depth} blocks "
                  f"({len(split.slices)} stacked leaves), schedule "
                  f"{cfg.model.pipe_schedule}, "
                  f"{cfg.model.pipe_microbatches or m.pipe} microbatches",
                  flush=True)
        elif split is not None:
            print(f"[shardings] model_axis={m.model}: model rank "
                  f"{m.model_rank} holds {len(split.slices)} leaves' "
                  f"slices ({', '.join(split.slices)})", flush=True)
        if self.layout is not None:
            lay = self.layout
            print(f"[shardings] {lay.mode} over {lay.n} data ranks: "
                  f"{len(lay.split)} of {len(lay.leaves)} leaves split, "
                  f"{lay.size} elements a rank in each sharded entry "
                  f"({', '.join(k for k in lay.keys)})", flush=True)
        # An injected logger (the supervisor's: one stream for every
        # attempt) is its owner's to close.
        self._owns_logger = logger is None
        self.logger = logger if logger is not None else MetricsLogger(
            cfg.metrics_jsonl if m.chief else None, task_index=task_index,
            tensorboard_dir=cfg.tensorboard_dir if m.chief else None)
        # The cluster monitor (parallel/cluster.py): the supervisor passes
        # ONE across its attempts (epoch and world must survive them); a
        # bare trainer builds its own and closes it with the fit.
        self._owns_cluster = cluster is None and par.cluster_dir is not None
        self.cluster = cluster if cluster is not None \
            else cluster_lib.ClusterMonitor.from_config(par,
                                                        logger=self.logger)
        self.train_step = step_lib.make_train_step(
            self.model, cfg.optim, m, health_metrics=cfg.health_metrics)
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
                self.model, cfg.optim, data_cfg=cfg.data, mesh=m,
                health_metrics=cfg.health_metrics)
        # Resident-eval functions, set up by fit() on the resident path.
        self._resident_full_eval = None
        self._resident_test_eval = None
        #: The last fit's step or chunk function (its graph's replay
        #: count, its index stream's table: for inspection), and its span
        #: tracer.
        self.train_fn = None
        self.tracer = None

    def init_or_restore(self) -> step_lib.TrainState:
        """Fresh state from ``cfg.seed``, overwritten by the newest
        verifiable checkpoint in ``log_dir`` when there is one."""
        gen = torch.Generator().manual_seed(self.cfg.seed)
        state = step_lib.init_train_state(self.model, self.cfg.optim,
                                          self.device, gen, self.layout)
        if self.faults is not None:
            # The recovery-phase seam (utils/faults.py): a `kind@restore`
            # fault strikes here, before the walk reads anything. Only
            # recovery restores count (the supervisor arms it).
            self.faults.phase_hook("restore", self.cfg.log_dir,
                                   logger=self.logger, cluster=self.cluster)

        def note_fallback(step, path, reason, walk_ms):
            # A candidate the newest-verifiable walk skipped.
            self.logger.log("ckpt_fallback", step=step, path=path,
                            error=str(reason), walk_ms=walk_ms)

        if self._restore_from_peers(state):
            return state
        return ckpt_lib.restore_checkpoint(
            self.cfg.log_dir, state, self.cfg.shard_io_threads,
            self._shard_io, on_fallback=note_fallback,
            deadline_s=self.cfg.restore_deadline_s)

    def _restore_from_peers(self, state: step_lib.TrainState) -> bool:
        """Diskless restore (``ckpt/peerstore.py``; JAX ``train/loop.py:
        281-316``): when the adopted restart decision says
        ``source="peer"``, rebuild ``state`` in place (its tensors on the
        device, in the port's layouts) from this process's payload in
        memory and the lost hosts' replicas, with zero checkpoint reads.
        A classified miss (a replica missing, stale or corrupt) logs a
        ``peer_replica`` ``fallback`` record and returns False, and the
        caller runs the unchanged disk walk; so does no pending peer
        decision."""
        cluster = self.cluster
        if cluster is None or cluster.peer_store is None:
            return False
        pending = cluster.take_peer_restore()
        if pending is None:
            return False
        decision, world, lost = pending
        try:
            cluster.peer_store.restore(state, decision.restore_step, world,
                                       lost=lost, on_event=self._shard_io)
        except peerstore_lib.ReplicaMiss as e:
            cluster.log("peer_replica", op="fallback",
                        step=decision.restore_step, owner=None, bytes=None,
                        secs=None, ok=False, error=str(e)[:300],
                        staleness=None)
            print(f"[ckpt] peer restore at step {decision.restore_step} "
                  f"not servable ({e}); falling back to the disk restore "
                  f"walk", file=sys.stderr)
            return False
        print(f"[ckpt] restored step {decision.restore_step} from peer "
              f"replicas (zero checkpoint reads)")
        return True

    def _shard_io(self, kind: str, **fields) -> None:
        """The sharded codec's per-shard records, into the metrics
        stream."""
        self.logger.log(kind, **fields)

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
        """Indices drawn from this data rank's shard, as rows of the whole
        split on the device (the resident splits are whole)."""
        return torch.from_numpy(step_lib.global_rows(idx, self.mesh)).to(
            self.device)

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
        # Exact resume: skip each host stream past what the checkpointed
        # run consumed (its data_state sidecar). Only the eager path
        # decodes training batches on the host (their augmentation draws
        # replay); the accuracy stream does unless resident.
        base = {"train": 0, "acc": 0, "test": 0}
        prior = (ckpt_lib.load_data_state(cfg.log_dir, start_step)
                 if start_step > 0 else None)
        if prior:
            base.update({name: int(prior.get(name, 0)) for name in base})
            train_it.skip_batches(base["train"], aug=(k == 1))
            acc_it.skip_batches(base["acc"], aug=not resident)
            test_it.skip_batches(base["test"])
        consumed = {"acc": 0, "test": 0}
        if resident:
            # The uint8 splits live on the device, whole on every rank; a
            # chunk gathers and decodes its rows there (parallel/step.py).
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
                              if dev_stream else None), mesh=self.mesh,
                health_metrics=cfg.health_metrics)
            acc_eval = step_lib.make_batch_eval_resident(
                self.model, ds_images, ds_labels, cfg.data, mesh=self.mesh)
            if cfg.eval_full_test_set:
                self._resident_full_eval = step_lib.make_eval_resident(
                    self.model, test_it.images, test_it.labels, cfg.data,
                    self.device, batch_size=self.local_batch,
                    expected_batches=test_it.num_padded_sweep_batches(),
                    mesh=self.mesh, total_records=test_it.total_records)
            else:
                t_imgs, t_lbls = _full_split_arrays(
                    test_it, lambda: pipe.input_pipeline(
                        cfg.data, self.local_batch, train=False,
                        seed=cfg.seed))
                self._resident_test_eval = step_lib.make_batch_eval_resident(
                    self.model, torch.from_numpy(t_imgs).to(self.device),
                    torch.from_numpy(t_lbls.astype(np.int64)).to(
                        self.device), cfg.data, mesh=self.mesh)
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
        graph = getattr(step_fn, "graph", None)

        def boundary_check():
            # Before anything of the window is logged or saved.
            if stream_check is not None:
                stream_check()

        ckpt_mgr = ckpt_lib.CheckpointManager(
            cfg.log_dir, cfg.checkpoint_every, keep=cfg.keep_checkpoints,
            mesh=self.mesh, async_save=cfg.async_checkpoint,
            every_secs=cfg.checkpoint_every_secs, fmt=cfg.ckpt_format,
            shard_io_threads=cfg.shard_io_threads, on_event=self._shard_io)

        def data_state(step):
            return {"train": base["train"] + step - start_step,
                    "acc": base["acc"] + consumed["acc"],
                    "test": base["test"] + consumed["test"]}

        # on_nonfinite="skip": a copy of every state tensor, refreshed at
        # each finite metrics boundary; a detection copies it back into
        # the state's own tensors.
        tensors = step_lib._state_tensors(state)
        snapshot = ([t.detach().clone() for t in tensors]
                    if cfg.check_numerics and cfg.on_nonfinite == "skip"
                    else None)
        skips = 0
        last_metrics = None

        def numerics_halt(loss, step):
            self.logger.log("numerics_halt", step=step)
            raise FloatingPointError(
                f"non-finite train loss ({loss}) at step {step}; halting "
                f"without checkpointing the poisoned state "
                f"(check_numerics=True)")

        def nonfinite(loss, step):
            """The on_nonfinite policy for a non-finite loss at ``step``
            (the same verdict on every rank: the loss is the data
            mean)."""
            nonlocal skips
            if cfg.on_nonfinite == "rollback":
                self.logger.log("fault", step=step, fault="nonfinite",
                                injected=False)
                raise FloatingPointError(
                    f"non-finite train loss ({loss}) at step {step}; "
                    f"raising for supervisor rollback "
                    f"(on_nonfinite=rollback)")
            if snapshot is None or skips >= cfg.recovery_retries:
                numerics_halt(loss, step)
            skips += 1
            self.logger.log("fault", step=step, fault="nonfinite",
                            injected=False)
            self.logger.log("recovery", step=step, fault="nonfinite",
                            action="skip", attempt=skips)
            print(f"[recover] non-finite loss at step {step}: discarding "
                  f"updates since the last finite boundary (skip "
                  f"{skips}/{cfg.recovery_retries})")
            with torch.no_grad():
                for t, saved in zip(tensors, snapshot):
                    t.copy_(saved)
                # The updates are gone but the steps happened: the data
                # stream, the cadences and the checkpoint names key on it.
                state.step.fill_(step)

        def guarded_save(step, force=False):
            """``ckpt_mgr.maybe_save``; under ``check_numerics`` the last
            dispatch's loss is read first (only when a save is due), and
            a non-finite state is never written: halt and rollback raise,
            skip restores the snapshot and skips this save."""
            nonlocal last_metrics
            if not ckpt_mgr.due(step, force):
                return False
            boundary_check()
            if cfg.check_numerics and last_metrics is not None:
                loss = float(last_metrics["loss"])
                if not math.isfinite(loss):
                    nonfinite(loss, step)
                    last_metrics = None
                    return False
            if self.cluster is not None:
                self.cluster.set_phase("checkpoint")
            with tracer.span("checkpoint", cat="checkpoint"):
                saved = ckpt_mgr.maybe_save(state, step, force=force,
                                            data_state=data_state(step))
            store = self.cluster.peer_store \
                if self.cluster is not None else None
            if saved and store is not None and store.enabled:
                # Peer redundancy: this boundary's payload to the ring
                # successor, copied to host memory here on the step
                # thread (the next step's K1/K2 update the tensors in
                # place); only the file push runs in the store's thread.
                store.push_state_async(step, state, self.mesh.rank)
            return saved

        metrics = None
        # Throughput windows run between drained boundaries and skip the
        # boundary work (eval, checkpoint) itself; the device step-time
        # estimate shares their marks.
        meter = profiling.DrainMeter(cfg.batch_size)
        dev_est = devprof.DeviceStepEstimator()
        devwin = devprof.ProfileWindow.from_config(cfg, logger=self.logger)
        if graph is not None:
            graph.learn_update = devwin is not None
        # One step's FLOPs on this rank and what the figure means, counted
        # once (utils/profiling.py); none when the count fails.
        try:
            flops, flops_label = profiling.step_flops(
                cfg, data=self.mesh.data, seq=self.mesh.seq,
                model=self.mesh.model, pipe=self.mesh.pipe)
        except Exception as e:      # telemetry must not stop a run
            print(f"[profiling] step FLOP count failed: {e!r}; no "
                  "TFLOP/s or MFU in this run", file=sys.stderr)
            flops, flops_label = None, "count_failed"
        run_t0 = None
        # Host-loop spans (utils/telemetry.py); disabled, each span is a
        # shared no-op.
        tracer = self.tracer = telemetry_lib.SpanTracer(
            enabled=cfg.telemetry)
        # Dispatches between the ranks' preemption exchanges: about
        # preempt_sync_every steps whatever the chunk size.
        sync_stride = max(1, cfg.preempt_sync_every // k)
        n_dispatch = 0
        stop = False

        print("Starting Training")  # parity: cifar10cnn.py:225
        i = 0  # local step, like the reference's `i` (cifar10cnn.py:224)
        global_step = start_step
        try:
            # A profile window owns the profiler when armed; else
            # profile_dir alone captures the whole loop.
            with PreemptionGuard() as preempt, profiling.profile_trace(
                    cfg.profile_dir if devwin is None else None):
                if not preempt.installed:
                    if self.faults is not None and any(
                            e.kind == "sigterm" for e in self.faults.events):
                        raise RuntimeError(
                            "--fault_spec sigterm needs the trainer on the "
                            "main thread: only there can it catch SIGTERM")
                    print("[preempt] the trainer runs off the main thread, "
                          "where Python installs no signal handler: "
                          "SIGTERM/SIGINT end the process without a "
                          "checkpoint", file=sys.stderr)
                tracer.start()
                while global_step < total_steps and not stop:
                    if devwin is not None and (k == 1 or run_t0 is not None):
                        devwin.maybe_start(global_step)
                    if self.cluster is not None:
                        # Publish a beat, check for eviction, arm the
                        # watchdog; raises PeerLostError when a peer's
                        # beats went stale.
                        self.cluster.begin_step(global_step)
                    if self.faults is not None:
                        if any(e.kind == "ckpt_corrupt" and e.phase is None
                               and e.step <= global_step
                               for e in self.faults.pending()):
                            ckpt_mgr.flush()   # corrupt a written file
                        state = self.faults.step_hook(
                            global_step, state, cfg.log_dir, self.logger,
                            chief=self.mesh.chief, cluster=self.cluster)
                    if self.cluster is not None:
                        # The lockstep barrier (simulation only).
                        self.cluster.sync(global_step)
                    first = run_t0 is None
                    with tracer.span("data_wait", cat="data"):
                        try:
                            inputs = next(prefetch)
                        except pipe.DataPipelineError:
                            raise
                        except Exception as e:
                            # A failure drawing input is a pipeline
                            # failure the supervisor may restart from the
                            # last checkpoint, not a model bug.
                            raise pipe.DataPipelineError(
                                f"input pipeline failed at step "
                                f"{global_step}: {e!r}") from e
                    # The first dispatch sets up (CUDA context, cuDNN
                    # plans, a chunk's graph capture): goodput's compile.
                    with tracer.span(
                            "compile_first_dispatch" if first
                            else "dispatch", cat="compile" if first
                            else None):
                        state, metrics = step_fn(state, *inputs)
                    last_metrics = metrics
                    global_step += k
                    if self.cluster is not None:
                        # The dispatch came back: disarm the watchdog.
                        # Boundary work runs unarmed while the publisher
                        # keeps this process looking alive.
                        self.cluster.end_step(global_step)
                    if first:
                        # First dispatch done enqueueing: one-time set-up
                        # is behind us.
                        run_t0 = time.perf_counter()
                        meter.mark(global_step)
                        dev_est.mark(global_step)
                        if devwin is not None and graph is not None:
                            devwin.update_signature = graph.update_signature
                    drained = False
                    if (i + k) % cfg.output_every == 0:
                        if acc_eval is not None:
                            acc_t = acc_eval(state, self._index(
                                acc_it.next_index_chunk(1)[0]))
                        else:
                            acc_t = self.eval_step(
                                state, *self._placed(next(acc_it)))["accuracy"]
                        consumed["acc"] += 1
                        # The boundary's one device read (the health
                        # scalars ride it); the clock reads around it feed
                        # the device step-time estimate.
                        # The router stats of a model with experts ride
                        # it too (JAX train/loop.py:961-1003), the
                        # per-expert load as a list.
                        fused_keys = sorted(
                            key for key in metrics
                            if key.startswith(("moe_", "health_")))
                        t_drain0 = time.perf_counter()
                        with tracer.span("boundary_drain"):
                            fetched = torch.cat(
                                [torch.stack([metrics["loss"].float(),
                                              acc_t.float()])]
                                + [metrics[key].float().reshape(-1)
                                   for key in fused_keys]).tolist()
                        t_drain1 = time.perf_counter()
                        loss, acc = fetched[0], fetched[1]
                        boundary_check()
                        device_step_ms, drain_wait_ms = dev_est.boundary(
                            global_step, t_drain0, t_drain1)
                        rate = meter.rate(global_step)
                        perf, off = {}, 2
                        for key in fused_keys:
                            n = metrics[key].numel()
                            vals = [round(v, 5)
                                    for v in fetched[off:off + n]]
                            off += n
                            perf[key] = vals if metrics[key].dim() \
                                else vals[0]
                        if flops and rate > 0:
                            tf = flops * (rate / cfg.batch_size) / 1e12
                            perf["tflops_per_sec_per_chip"] = round(tf, 3)
                            if cfg.peak_tflops:
                                perf["mfu"] = round(tf / cfg.peak_tflops, 4)
                        if flops_label is not None:
                            # Once, outside the rate guard: what the count
                            # means (utils/profiling.py).
                            perf["flops_stack"] = flops_label
                            flops_label = None
                        self.logger.train_print(global_step, i + k - 1, acc)
                        self.logger.log(
                            "train", step=global_step, loss=loss,
                            train_accuracy=acc, images_per_sec=rate,
                            lr=_current_lr(cfg, global_step),
                            device_step_ms=device_step_ms,
                            drain_wait_ms=drain_wait_ms,
                            optimizer_ms=(devwin.optimizer_step_ms
                                          if devwin is not None else None),
                            **perf)
                        telemetry_lib.flush_boundary(
                            tracer, self.logger, global_step,
                            device=self.device)
                        if cfg.check_numerics:
                            if not math.isfinite(loss):
                                nonfinite(loss, global_step)
                                last_metrics = None
                            elif snapshot is not None:
                                with torch.no_grad():
                                    for saved, t in zip(snapshot, tensors):
                                        saved.copy_(t)
                        drained = True
                    if (i + k) % cfg.eval_every == 0:
                        boundary_check()
                        if self.cluster is not None:
                            self.cluster.set_phase("eval")
                        with tracer.span("eval", cat="eval"):
                            ta = self.evaluate(state, test_it)
                        if not cfg.eval_full_test_set:
                            consumed["test"] += 1
                        self.logger.eval_print(ta)
                        self.logger.log("eval", step=global_step,
                                        test_accuracy=ta)
                        drained = True
                    if guarded_save(global_step):
                        drained = True
                    i += k
                    n_dispatch += 1
                    # Preemption: one process reacts at once; several
                    # ranks agree first (a rank that left alone would hang
                    # its peers in the next collective), in one exchange
                    # that also carries the clock-save trigger.
                    if self.mesh.world == 1:
                        stop = preempt.requested
                        if ckpt_mgr.time_due() and guarded_save(
                                global_step, force=True):
                            drained = True
                    elif n_dispatch % sync_stride == 0:
                        with tracer.span("preempt_allgather", cat="sync"):
                            flags = torch.tensor(
                                [int(preempt.requested),
                                 int(ckpt_mgr.time_due())],
                                dtype=torch.int32, device=self.device)
                            self.mesh.all_reduce_(flags, "world")
                            stop_any, save_any = flags.tolist()
                        stop = stop_any > 0
                        if save_any > 0 and guarded_save(global_step,
                                                         force=True):
                            drained = True
                    if drained:
                        # The next window starts after this boundary's work.
                        meter.mark(global_step)
                        dev_est.mark(global_step)
                    if devwin is not None:
                        devwin.maybe_stop(global_step, drained=drained)

                # The final save, at the end or on a preemption stop (the
                # dispatch in flight finished, so it loses no work),
                # inside the guard so a second signal cannot cut the
                # write short.
                avg_rate = 0.0
                if run_t0 is not None:
                    float(metrics["loss"])  # waits for the last step
                    avg_rate = ((global_step - start_step) * cfg.batch_size
                                / max(time.perf_counter() - run_t0, 1e-9))
                # A preempted non-chief of a world of its own (the
                # lockstep simulation) does not save: the chief owns the
                # checkpoints. In a real process group every rank enters
                # the save together.
                nonchief_preempt = (stop and self.mesh.world == 1
                                    and not multihost.is_chief(cfg.parallel))
                if nonchief_preempt:
                    self.logger.log("peer_lost", step=global_step,
                                    process_id=cfg.parallel.process_id,
                                    reason="preempt_nonchief_exit")
                    print(f"[preempt] signal {preempt.signum} on non-chief "
                          f"process {cfg.parallel.process_id}: exiting "
                          f"cleanly without saving (chief owns the "
                          f"checkpoint)")
                else:
                    guarded_save(global_step, force=True)
                if stop and not nonchief_preempt:
                    print(f"[preempt] signal {preempt.signum}: checkpointed "
                          f"at step {global_step}, exiting cleanly")
                if stop:
                    self.logger.log("preempt", step=global_step,
                                    signum=preempt.signum)
                self.logger.log("done", step=global_step,
                                images_per_sec=avg_rate)
                telemetry_lib.flush_boundary(tracer, self.logger,
                                             global_step, final=True,
                                             device=self.device)
        finally:
            try:
                # A failed background write surfaces here, beside any
                # error already on its way out.
                ckpt_mgr.close()
            finally:
                if devwin is not None:
                    devwin.close(global_step)
                prefetch.close()
                # A supervisor's monitor keeps its threads across
                # attempts; one this trainer built dies with the fit.
                if self._owns_cluster and self.cluster is not None:
                    self.cluster.close()
                # A failed or preempted run leaves its host-loop timeline
                # too.
                if tracer.enabled and cfg.trace_events_path:
                    path = cfg.trace_events_path
                    if self.task_index:
                        path += f".task{self.task_index}"
                    tracer.export_chrome_trace(path, pid=self.task_index)
                self.logger.flush()
        return TrainResult(global_step, avg_rate, state, preempted=stop)

    def close(self) -> None:
        """Close the metrics stream and the cluster monitor when this
        trainer built them, and free the chunk graphs (over NCCL before
        the process group goes: a graph holds resources of the
        communicators it captured) and the last fit's device-resident
        data, so a supervisor's next attempt captures on free memory."""
        if self._owns_logger:
            self.logger.close()
        if self._owns_cluster and self.cluster is not None:
            self.cluster.close()
        for fn in (self.train_fn, getattr(self, "train_chunk", None)):
            graph = getattr(fn, "graph", None)
            if graph is not None:
                graph.release()
        self.train_fn = self.train_chunk = None
        self._resident_full_eval = self._resident_test_eval = None


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
