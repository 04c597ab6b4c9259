"""Run supervisor: a classified retry loop around ``Trainer.fit``.

Port of ``dml_cnn_cifar10_tpu/train/supervisor.py`` without its
autopilot, alert-engine and flight-recorder wiring (ROADMAP.md Queue 1
item 9: the port has none of those modules). The reference's recovery
story is "the scheduler restarts the worker and MonitoredTrainingSession
restores the latest checkpoint", which under synchronous data
parallelism makes any single failure a whole-job failure. The save half
of that contract is in the trainer (atomic checkpoints, the preemption
guard, exact-resume data sidecars); this module is the recover half:

1. it classifies the exception (:func:`classify_failure`): a non-finite
   loss under ``on_nonfinite=rollback``, a data-pipeline failure, a
   checkpoint-restore failure, a lost peer or a rejoining one are
   recoverable; anything else re-raises unchanged;
2. the next attempt's trainer restores the last *verifiable* checkpoint
   (the walk skips corrupt candidates by their sidecars) and rewinds the
   exact-resume data state (the host streams' sidecar, or the device
   index stream, which draws its rows from the restored step);
3. it waits a bounded exponential backoff (``recovery_backoff_s *
   2^(attempt-1)``, capped at ``recovery_backoff_max_s``;
   ``utils/backoff.py``) and retries, up to ``recovery_retries``
   attempts; past the budget the failure re-raises.

A rollback of a non-finite loss may also cut the learning rate
(``rollback_lr_scale``): the next attempt's trainer builds its step from
the cut ``cfg.optim.learning_rate``, so K1/K2, eager or replayed in a
newly captured CUDA graph, read the cut value. ``retry_budget_window``
refills the budget after sustained checkpoint progress.

With the cluster layer armed (``--cluster_dir``, ``parallel/cluster.py``)
the supervisor is cluster-aware: a ``peer_lost`` failure makes the chief
record a shrink decision (survivors, world size, restore step), the
others adopt it, and a process the decision excludes fences itself
(:class:`~parallel.cluster.EvictedError`: a clean, saveless exit) or,
under ``--elastic_expand``, announces a rejoin and waits for the chief's
expand decision. With ``--peer_redundancy`` the chief's decision may say
``source="peer"`` (every host advertised a pushed replica): adopting it
stages the peer restore, and the next attempt's trainer rebuilds the
state from the replicas, or, on a classified miss, walks the disk as
before; ``elastic_restart`` and ``elastic_expand`` records carry the
source. The recovery-phase fault seams (``@decide``, ``@adopt``;
``@restore`` in ``Trainer.init_or_restore``) fire here.

ONE injector, ONE cluster monitor and ONE logger span every attempt: a
fired ``nan@15`` stays fired on the replay, the epoch and world survive
the restart, and one JSONL stream holds the whole run. Each attempt's
trainer is closed (its chunk graph and device-resident data freed)
before the next one is built.
"""

from __future__ import annotations

import gc
import time
from typing import Optional

from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
from dml_cnn_cifar10_tpu_torch.config import TrainConfig
from dml_cnn_cifar10_tpu_torch.data.pipeline import DataPipelineError
from dml_cnn_cifar10_tpu_torch.parallel import cluster as cluster_lib
from dml_cnn_cifar10_tpu_torch.utils import backoff
from dml_cnn_cifar10_tpu_torch.utils import faults as faults_lib
from dml_cnn_cifar10_tpu_torch.utils.logging import MetricsLogger

#: Failure classes the supervisor may retry. "remediation" is the JAX
#: package's autopilot restart request, which never charges the budget;
#: the port has no autopilot (ROADMAP.md Queue 1 item 9), so nothing
#: raises it yet, and the name stays for the classes to match.
RECOVERABLE_FAULTS = ("nonfinite", "data", "ckpt_restore", "peer_lost",
                      "peer_rejoin", "remediation")


def classify_failure(exc: BaseException) -> Optional[str]:
    """Name the recoverable failure class of ``exc``, or None.

    - injected or real data-pipeline failures → ``"data"``
    - a non-finite loss (``FloatingPointError``) → ``"nonfinite"`` (only
      actionable under ``on_nonfinite=rollback``; the caller checks)
    - checkpoint-restore failures (the ``ValueError`` every restore path
      raises, the all-candidates-failed walk included) →
      ``"ckpt_restore"``
    - a peer declared lost → ``"peer_lost"`` (recoverable by a
      coordinated shrink)
    - a returning host announced a rejoin → ``"peer_rejoin"`` (a
      coordinated expand; chief seat only)
    """
    if isinstance(exc, cluster_lib.PeerRejoinError):
        return "peer_rejoin"
    if isinstance(exc, cluster_lib.PeerLostError):
        return "peer_lost"
    if isinstance(exc, (faults_lib.DataStallError, DataPipelineError)):
        return "data"
    if isinstance(exc, FloatingPointError):
        return "nonfinite"
    if isinstance(exc, ValueError) and "checkpoint" in str(exc) \
            and ("restore" in str(exc) or "restorable" in str(exc)):
        return "ckpt_restore"
    return None


def _newest_restore_step(cfg: TrainConfig) -> int:
    steps = ckpt_lib.all_checkpoint_steps(cfg.log_dir)
    return max(steps) if steps else 0


def _fire_phase(injector, phase: str, cfg: TrainConfig, logger,
                monitor) -> None:
    """Fire the phase-qualified faults (``kind@decide`` /
    ``kind@adopt``) at their supervisor seam."""
    if injector is not None:
        injector.phase_hook(phase, cfg.log_dir, logger=logger,
                            cluster=monitor)


def _adopt_decision(cfg: TrainConfig, monitor, decision, logger,
                    attempt: int, lost=(), injector=None):
    """Enter the decided world from any seat: adopt, resize the config,
    and log ``elastic_restart`` (shrink) or ``elastic_expand`` (grow)
    keyed on the decision's kind."""
    prev = set(monitor.live_set())
    monitor.adopt(decision)
    _fire_phase(injector, "adopt", cfg, logger, monitor)
    cfg.parallel.num_processes = decision.world_size
    fields = dict(step=decision.restore_step,
                  restore_step=decision.restore_step,
                  world_size=decision.world_size, epoch=decision.epoch,
                  attempt=attempt, source=decision.source)
    if decision.kind == "expand":
        joined = [p for p in decision.survivors if p not in prev]
        logger.log("elastic_expand", joined=joined, **fields)
        print(f"[supervisor] elastic expand epoch {decision.epoch}: "
              f"joined {joined}, world size {decision.world_size}, "
              f"restoring from step {decision.restore_step}")
    else:
        logger.log("elastic_restart", lost=list(lost), **fields)
        print(f"[supervisor] elastic restart epoch {decision.epoch}: "
              f"lost {list(lost)}, world size {decision.world_size}, "
              f"restoring from step {decision.restore_step}")
    return decision


def _coordinate_restart(cfg: TrainConfig, monitor, exc, logger,
                        attempt: int, injector=None):
    """The coordinated elastic restart, from this process's seat. A
    decision at a newer epoch that already includes us is adopted as it
    is (never race the chief's decision file). Otherwise the chief
    shrinks the survivor set by the lost peers (halting below
    ``min_hosts``), picks the restore source and step (the peer replicas'
    step when every host pushed one, else the newest checkpoint on disk)
    and commits the decision; a non-chief polls for it, fencing if excluded, and when the
    poll times out (the chief died between classifying and committing)
    the presumed-dead chief joins the lost set and, if that makes this
    process the lowest live survivor, it re-decides at a higher epoch.
    Every seat then adopts the new world and logs its record."""
    lost = list(exc.process_ids)
    pending = monitor.coordinator.read()
    if pending is not None and pending.epoch > monitor.epoch \
            and monitor.process_id in pending.survivors:
        decision = pending
    elif monitor.is_chief:
        decision = monitor.decide_restart(lost, _newest_restore_step(cfg))
        _fire_phase(injector, "decide", cfg, logger, monitor)
    else:
        timeout = max(30.0, cfg.parallel.peer_dead_after_s * 6)
        try:
            decision = monitor.await_restart(timeout)
        except cluster_lib.PeerLostError:
            # Coordinator loss mid-decision: mark the chief dead and let
            # the pen fall to the lowest live survivor; if that is not
            # us, re-raise (the new chief's decision reaches us through
            # the next attempt's seam check).
            live = [p for p in monitor.live_set()
                    if p not in monitor.watchdog.dead_peers
                    and p not in lost]
            dead_chief = min(live) if live else None
            if dead_chief is None or dead_chief == monitor.process_id:
                raise
            monitor.watchdog.dead_peers.add(dead_chief)
            lost = sorted(set(lost) | {dead_chief})
            monitor.log("peer_lost", step=monitor._step,
                        process_id=dead_chief, reason="coordinator_lost")
            print(f"[supervisor] chief {dead_chief} never committed a "
                  f"restart decision; presuming it lost")
            if not monitor.is_chief:
                raise
            decision = monitor.decide_restart(lost,
                                              _newest_restore_step(cfg))
            _fire_phase(injector, "decide", cfg, logger, monitor)
    return _adopt_decision(cfg, monitor, decision, logger, attempt,
                           lost=lost, injector=injector)


def _coordinate_expand(cfg: TrainConfig, monitor, exc, logger,
                       attempt: int, injector=None):
    """Chief half of the scale-up (only the chief raises
    ``PeerRejoinError``): grow the world by the announced joiners,
    restore from the newest checkpoint, commit, adopt."""
    decision = monitor.decide_expand(exc.process_ids,
                                     _newest_restore_step(cfg))
    _fire_phase(injector, "decide", cfg, logger, monitor)
    return _adopt_decision(cfg, monitor, decision, logger, attempt,
                           injector=injector)


def _request_rejoin(cfg: TrainConfig, monitor, logger, attempt: int,
                    injector=None):
    """Returning-host half: announce with ``rejoin``-phase beats, wait
    (bounded) for an expand decision that includes us, adopt it. Returns
    the decision, or None when the rejoin was refused or timed out (the
    caller fences, as without ``--elastic_expand``)."""
    monitor.request_rejoin()
    logger.log("host_rejoin", step=monitor._step,
               process_id=monitor.process_id, epoch=monitor.epoch)
    print(f"[supervisor] process {monitor.process_id} announcing rejoin "
          f"(epoch {monitor.epoch}); awaiting an expand decision")
    timeout = max(60.0, cfg.parallel.peer_dead_after_s * 24)
    try:
        decision = monitor.await_inclusion(timeout)
    except cluster_lib.PeerLostError as e:
        print(f"[supervisor] rejoin not granted: {e}")
        return None
    return _adopt_decision(cfg, monitor, decision, logger, attempt,
                           injector=injector)


def fit_supervised(cfg: TrainConfig, total_steps: Optional[int] = None,
                   task_index: int = 0, logger=None, on_attempt=None):
    """``Trainer.fit`` under the recovery supervisor; returns the final
    :class:`~train.loop.TrainResult`. Unrecoverable failures, and
    recoverable ones past the ``recovery_retries`` budget, re-raise
    unchanged. A process a restart decision evicted returns ``None`` after
    a clean notice: it was fenced, not failed.

    ``logger`` is the caller's to close (one is built and closed here
    otherwise). ``on_attempt()``, when given, is called after each
    attempt's trainer is closed, however the attempt ended (the card's
    smoke run reads device memory there, and the tests snapshot the log
    directory the next attempt restores from)."""
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer

    # ONE injector across every attempt: fired faults stay fired. The
    # same for the cluster monitor (epoch, world and the beat publisher
    # span restarts) and the logger (one stream for the run).
    injector = faults_lib.FaultInjector.from_spec(cfg.fault_spec)
    owns_logger = logger is None
    if owns_logger:
        # Every process of a lockstep simulation is a world of its own
        # and writes its own stream; in a process group only rank 0 does.
        chief = cfg.parallel.cluster_lockstep \
            or cfg.parallel.num_processes <= 1 or cfg.parallel.process_id == 0
        logger = MetricsLogger(cfg.metrics_jsonl if chief else None,
                               task_index=task_index,
                               tensorboard_dir=(cfg.tensorboard_dir
                                                if chief else None))
    monitor = cluster_lib.ClusterMonitor.from_config(cfg.parallel,
                                                     logger=logger)
    attempt = 0
    # The newest checkpoint step when the budget was last charged
    # (--retry_budget_window).
    budget_anchor = 0
    try:
        while True:
            trainer = Trainer(cfg, task_index=task_index,
                              fault_injector=injector, cluster=monitor,
                              logger=logger)
            try:
                result = trainer.fit(total_steps)
            except cluster_lib.EvictedError as e:
                # The surviving world restarted without this process.
                # Without --elastic_expand: exit cleanly and saveless.
                # With it, the fence is an invitation: announce a rejoin
                # and wait for the chief's expand decision.
                if monitor is not None and cfg.parallel.elastic_expand \
                        and attempt < cfg.recovery_retries:
                    attempt += 1
                    if injector is not None:
                        injector.recovering = True
                    decision = _request_rejoin(cfg, monitor, logger,
                                               attempt, injector=injector)
                    if decision is not None:
                        continue
                print(f"[supervisor] fenced: {e}")
                return None
            except Exception as e:
                fault = classify_failure(e)
                if fault is None:
                    raise
                if fault == "nonfinite" and cfg.on_nonfinite != "rollback":
                    # halt stays a halt; an exhausted skip budget already
                    # degraded to halt inside the loop.
                    raise
                if fault in ("peer_lost", "peer_rejoin") and monitor is None:
                    raise
                # Progress-based budget reset (off at window 0).
                progress = _newest_restore_step(cfg)
                if cfg.retry_budget_window > 0 and attempt > 0 \
                        and progress - budget_anchor \
                        >= cfg.retry_budget_window:
                    logger.log("recovery", step=progress, fault=fault,
                               action="budget_reset", attempt=attempt)
                    print(f"[supervisor] {progress - budget_anchor} steps "
                          f"of progress since the last retry (>= "
                          f"retry_budget_window={cfg.retry_budget_window}"
                          f"): retry budget reset")
                    attempt = 0
                if attempt >= cfg.recovery_retries:
                    raise
                attempt += 1
                budget_anchor = progress
                if injector is not None:
                    # Arm the recovery-phase injections (@restore fires at
                    # the next attempt's checkpoint restore).
                    injector.recovering = True
                if fault == "peer_rejoin":
                    decision = _coordinate_expand(cfg, monitor, e, logger,
                                                  attempt, injector=injector)
                    restore_step = decision.restore_step
                elif fault == "peer_lost":
                    try:
                        decision = _coordinate_restart(
                            cfg, monitor, e, logger, attempt,
                            injector=injector)
                    except cluster_lib.EvictedError as ev:
                        if cfg.parallel.elastic_expand:
                            decision = _request_rejoin(cfg, monitor, logger,
                                                       attempt,
                                                       injector=injector)
                            if decision is not None:
                                continue
                        print(f"[supervisor] fenced: {ev}")
                        return None
                    restore_step = decision.restore_step
                else:
                    restore_step = _newest_restore_step(cfg)
                backoff_s = backoff.delay_s(cfg.recovery_backoff_s,
                                            cfg.recovery_backoff_max_s,
                                            attempt)
                logger.log("fault", step=restore_step, fault=fault,
                           injected=False, error=str(e)[:300])
                if fault == "nonfinite" and cfg.rollback_lr_scale != 1.0:
                    # The next attempt's trainer builds its step from it.
                    cfg.optim.learning_rate *= cfg.rollback_lr_scale
                if fault == "nonfinite":
                    logger.log("rollback", step=restore_step,
                               restore_step=restore_step, attempt=attempt,
                               lr=cfg.optim.learning_rate)
                logger.log("recovery", step=restore_step, fault=fault,
                           action="restart", attempt=attempt,
                           backoff_s=backoff_s)
                print(f"[supervisor] recoverable {fault} failure (attempt "
                      f"{attempt}/{cfg.recovery_retries}): {e}; restoring "
                      f"from step {restore_step} after {backoff_s:.2f}s "
                      f"backoff")
                time.sleep(backoff_s)
                continue
            finally:
                trainer.close()
                # The attempt's frames (an exception's traceback holds its
                # fit) go now, not at the next cyclic collection, so the
                # device memory they hold is free before the next capture.
                del trainer
                gc.collect()
                if on_attempt is not None:
                    on_attempt()
            if attempt:
                logger.log("recovery", step=result.final_step,
                           fault="none", action="recovered",
                           attempt=attempt)
                print(f"[supervisor] recovered: reached step "
                      f"{result.final_step} after {attempt} restart(s)")
            return result
    finally:
        if monitor is not None:
            monitor.close()
        if owns_logger:
            logger.close()
