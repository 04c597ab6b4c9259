"""Cluster resilience: heartbeats, collective watchdog, coordinated restart.

A framework-free copy of ``dml_cnn_cifar10_tpu/parallel/cluster.py``. The
on-disk formats are the JAX module's, byte for byte, so a beat or a
decision written by either package reads back field for field in the
other. Beats and decisions go through files in a shared directory, or,
with ``transport="net"`` (``--cluster_transport net``), over the HTTP
coordination service of ``parallel/net.py``, which process 0 hosts over
the same directory. With ``peer_redundancy`` the monitor carries the
peer-replica store (``ckpt/peerstore.py``): a chief may decide a restart
``source="peer"``, and the survivors rebuild the state from the replicas
instead of the disk walk.

Synchronous data parallelism turns one hung or dead host into a stall
of every collective, with no error and no log line. This module is the
liveness layer around the training loop's dispatch seam:

- :class:`HeartbeatStore` — a file-backed beat store under
  ``<cluster_dir>/heartbeats/``. Every process publishes ``{process_id,
  step, wallclock, phase}`` by atomic rename; peers read without locks.
- :class:`CollectiveWatchdog` — a daemon thread armed around each
  dispatch. When the seam overruns ``straggler_after_s`` it reads the
  peer beats: a peer beating but behind is a **straggler** (a
  ``straggler`` record); a peer whose beat is stale past
  ``peer_dead_after_s`` is **lost** (recorded in ``dead_peers``; the
  seam raises :class:`PeerLostError`). A seam armed past
  ``collective_timeout_s`` means the main thread is wedged inside a
  collective (NCCL or gloo), which Python cannot unwind: the watchdog
  logs and ends the process (``os._exit``).
- :class:`RestartCoordinator` — the chief records a restart decision
  ``{epoch, world_size, restore_step, survivors, kind, source}`` (atomic
  rename, a sha256 sidecar); survivors poll for it; a process the
  decision excludes fences itself (:class:`EvictedError`), or, under
  ``elastic_expand``, announces a rejoin and waits for an **expand**
  decision.
- :class:`ClusterMonitor` — the per-process facade the trainer and the
  run supervisor use: the beat publisher thread, the watchdog, the seam
  hooks (``begin_step`` / ``sync`` / ``end_step``) and the eviction
  check.

Simulation: with ``cluster_lockstep`` the ``sync`` seam waits for every
live peer's beat to reach the local step, a software stand-in for the
collective barrier, and each process is a world of its own (the trainer
opens no process group), so a 2-process run exercises the straggler,
death and restart paths end to end on the CPU or on one card. Real
multi-process runs leave lockstep off: the collectives already hold the
ranks together, and the watchdog only observes and, past
``collective_timeout_s``, ends the process. It never re-forms a live
process group after a shrink (the JAX package has no such step either).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

from dml_cnn_cifar10_tpu_torch.utils import backoff

#: Exit code of a watchdog abort (dead peer while blocked in a
#: collective, or self-classified hang) — distinct from a crash so the
#: scheduler can tell "fenced by the resilience layer" from "bug".
EXIT_WATCHDOG_ABORT = 78


class PeerLostError(RuntimeError):
    """One or more peers' heartbeats went stale past
    ``peer_dead_after_s`` — the run cannot continue at this world size.
    Classified as recoverable by the supervisor (``peer_lost``). Also
    raised (with an EMPTY ``process_ids``) when a newer coordinator
    epoch is observed mid-step: the chief already committed a new world
    and the clean move is to exit the step loop and adopt it, not to
    race the decision file."""

    def __init__(self, process_ids: Sequence[int], message: str):
        super().__init__(message)
        self.process_ids = sorted(process_ids)


class PeerRejoinError(RuntimeError):
    """A returning (or brand-new) host announced itself with a
    ``rejoin``-phase beat while this chief was mid-run. Classified as
    recoverable by the supervisor (``peer_rejoin``): the chief answers
    with a coordinated **expand** restart growing the world to the live
    hosts."""

    def __init__(self, process_ids: Sequence[int], message: str):
        super().__init__(message)
        self.process_ids = sorted(process_ids)


class EvictedError(RuntimeError):
    """A restart decision excluded this process: the surviving world
    declared it dead (stalled heartbeats look identical to a dead host
    from outside). The only correct move is a clean, saveless exit —
    rejoining would split-brain the run."""


@dataclasses.dataclass
class Beat:
    process_id: int
    step: int
    wallclock: float
    phase: str
    # Free-form payload beyond the train-loop fields: the peer store's
    # {"replica_step": N} (the JAX package's serving fleet publishes here
    # too). None without one; beat files without the key still decode.
    extra: Optional[Dict] = None

    def age_s(self, now: Optional[float] = None) -> float:
        return (now if now is not None else time.time()) - self.wallclock


@dataclasses.dataclass
class RestartDecision:
    epoch: int
    world_size: int
    restore_step: int
    survivors: List[int]
    # "shrink" (a host was lost) or "expand" (a host rejoined /
    # arrived; the scale-UP half). Default keeps pre-expand decision
    # files decodable.
    kind: str = "shrink"
    # Where survivors restore from: "disk" (the newest-verifiable
    # checkpoint walk) or "peer" (the peer-replica store,
    # ckpt/peerstore.py: lost hosts' shards from their replicas, placed
    # first, own shards from memory, zero checkpoint reads). The default
    # keeps decision files without the key decodable, restoring from disk.
    source: str = "disk"


class HeartbeatStore:
    """Atomic-rename JSON beats under ``<cluster_dir>/heartbeats/``.

    File-backed deliberately: the store must work where the collectives
    do NOT (that is the whole point), must be inspectable post-mortem
    with ``cat``, and must be simulatable on CPU without a network
    stack. A socket/KV backend can replace it behind the same
    publish/read API."""

    def __init__(self, cluster_dir: str, process_id: int, log_fn=None):
        self.dir = os.path.join(cluster_dir, "heartbeats")
        self.process_id = process_id
        os.makedirs(self.dir, exist_ok=True)
        self.started_at = time.time()
        # Telemetry sink for torn/undecodable beats found mid-scan
        # (read_all). Rate-limited per path: a poll loop scans often and
        # one corrupt file must not flood the stream.
        self._log = log_fn
        self._last_decode_note: Dict[str, float] = {}

    def _path(self, pid: int) -> str:
        return os.path.join(self.dir, f"proc_{pid}.json")

    def publish(self, step: int, phase: str,
                extra: Optional[Dict] = None) -> Beat:
        beat = Beat(self.process_id, int(step), time.time(), phase,
                    extra=extra)
        # Tmp name unique per pid AND thread: the background publisher
        # thread and a dispatch-seam publish from the main thread would
        # otherwise race on one tmp file (write/replace interleaving →
        # FileNotFoundError on the loser's replace).
        tmp = self._path(self.process_id) \
            + f".tmp{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(beat), f)
        os.replace(tmp, self._path(self.process_id))
        return beat

    def read(self, pid: int) -> Optional[Beat]:
        """The peer's latest beat, or None if it never published (a
        torn read — mid-rename on exotic filesystems — reads as None
        too and self-heals on the next poll)."""
        try:
            with open(self._path(pid)) as f:
                return Beat(**json.load(f))
        except (OSError, ValueError, TypeError):
            return None

    def read_peers(self, expected: Sequence[int]) -> Dict[int, Optional[Beat]]:
        return {pid: self.read(pid) for pid in expected
                if pid != self.process_id}

    def _note_decode(self, path: str, error: str) -> None:
        if self._log is None:
            return
        now = time.time()
        if now - self._last_decode_note.get(path, 0.0) < 1.0:
            return
        self._last_decode_note[path] = now
        self._log("beat_decode_error", path=path, error=error[:200])

    def read_all(self) -> Dict[int, Beat]:
        """Every beat present on disk, keyed by process id — discovery
        for consumers that do NOT know the membership up front (the
        rejoin scan looks for hosts outside the survivor set). Self
        included. A file that VANISHES
        mid-scan is a benign rename race and is skipped silently; a
        file that is present but undecodable (torn/partial write on a
        non-atomic filesystem) is skipped with a classified
        ``beat_decode_error`` record — the scan must survive one bad
        peer, and the stream must say which one."""
        out: Dict[int, Beat] = {}
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            if not (name.startswith("proc_") and name.endswith(".json")):
                continue
            try:
                pid = int(name[len("proc_"):-len(".json")])
            except ValueError:
                continue
            path = os.path.join(self.dir, name)
            try:
                with open(path) as f:
                    text = f.read()
            except OSError:
                continue  # mid-rename; self-heals on the next poll
            try:
                out[pid] = Beat(**json.loads(text))
            except (ValueError, TypeError) as e:
                self._note_decode(path, str(e))
        return out


class RestartCoordinator:
    """Chief-written, survivor-polled restart decisions.

    The decision file is the cluster's only piece of mutable shared
    truth, so it follows the checkpoint rules: written to a tmp name,
    committed by atomic rename, monotone ``epoch`` so a stale decision
    can never be mistaken for a new one — and, like a checkpoint, it
    carries a sha256 integrity sidecar (``restart_decision.json.sha256``)
    committed AFTER the payload. A decision every survivor is about to
    rebuild its world around must not be trusted on a successful JSON
    parse alone: bit rot / a half-synced shared filesystem can serve a
    decodable-but-wrong payload. :meth:`read` therefore returns **None
    with a classified ``decision_corrupt`` telemetry record** on an
    undecodable or sidecar-mismatched file, instead of either crashing
    unclassified or silently adopting garbage; the poll loops that call
    it self-heal on the next read. A payload without any sidecar is a
    pre-hardening (or mid-commit) decision file and still decodes."""

    def __init__(self, cluster_dir: str, log_fn=None):
        self.path = os.path.join(cluster_dir, "restart_decision.json")
        self.sidecar_path = self.path + ".sha256"
        os.makedirs(cluster_dir, exist_ok=True)
        # Telemetry sink for corrupt-decision reads; the owning
        # ClusterMonitor wires its (locked) log method in. Rate-limited
        # per payload digest — await_decision polls at 20 Hz and one
        # corrupt file must not flood the stream.
        self._log = log_fn
        self._last_bad_digest: Optional[str] = None

    def _note_corrupt(self, digest: str, error: str) -> None:
        if digest == self._last_bad_digest:
            return
        self._last_bad_digest = digest
        print(f"[cluster] corrupt restart decision {self.path}: "
              f"{error}; reading as absent", file=sys.stderr)
        if self._log is not None:
            self._log("decision_corrupt", path=self.path, error=error)

    def read(self) -> Optional[RestartDecision]:
        try:
            with open(self.path, "rb") as f:
                payload = f.read()
        except OSError:
            return None
        digest = hashlib.sha256(payload).hexdigest()
        want = None
        try:
            with open(self.sidecar_path) as f:
                want = json.load(f)["digest"]
        except OSError:
            want = None  # no sidecar: legacy / mid-commit — decode only
        except (ValueError, TypeError, KeyError) as e:
            self._note_corrupt(digest, f"undecodable sidecar: {e}")
            return None
        if want is not None and want != digest:
            self._note_corrupt(
                digest, f"sidecar digest mismatch (have {digest[:12]}…, "
                        f"sidecar says {str(want)[:12]}…)")
            return None
        try:
            return RestartDecision(**json.loads(payload))
        except (ValueError, TypeError) as e:
            self._note_corrupt(digest, f"undecodable decision: {e}")
            return None

    def record(self, decision: RestartDecision) -> RestartDecision:
        prior = self.read()
        if prior is not None and prior.epoch >= decision.epoch:
            raise ValueError(
                f"restart epoch must be monotone: have {prior.epoch}, "
                f"recording {decision.epoch}")
        payload = json.dumps(dataclasses.asdict(decision)).encode()
        # Commit order is payload → sidecar (each via atomic rename):
        # a reader between the two renames sees new payload + stale
        # sidecar, reads it as corrupt-absent, and self-heals on the
        # next poll — strictly better than a window where a mismatched
        # pair could be half-trusted.
        tmp = self.path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, self.path)
        sidecar = {"algo": "sha256",
                   "digest": hashlib.sha256(payload).hexdigest()}
        tmp = self.sidecar_path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(sidecar, f)
        os.replace(tmp, self.sidecar_path)
        return decision

    def await_decision(self, min_epoch: int, timeout_s: float,
                       poll_s: float = 0.05) -> RestartDecision:
        """Non-chief survivors block here until the chief commits a
        decision at/after ``min_epoch``. A chief that never decides is
        a coordinator loss: raise ``PeerLostError(chief)`` so the
        caller fails deterministically instead of polling forever."""
        deadline = time.time() + timeout_s
        attempt = 0
        while True:
            d = self.read()
            if d is not None and d.epoch >= min_epoch:
                return d
            if time.time() > deadline:
                raise PeerLostError(
                    [0], f"no restart decision at epoch >= {min_epoch} "
                         f"within {timeout_s:.1f}s — coordinator lost")
            # Shared bounded backoff (utils/backoff.py) instead of a
            # fixed-cadence poll: N survivors polling one shared file
            # at 20 Hz hammers the store at larger world sizes; the
            # cap keeps adoption latency bounded at ~10x the base.
            attempt += 1
            time.sleep(backoff.delay_s(poll_s, poll_s * 10.0, attempt))


class CollectiveWatchdog(threading.Thread):
    """Deadline thread around the dispatch seam.

    ``arm(step)`` starts the clock; ``disarm()`` stops it. While armed
    past ``straggler_after_s`` the thread polls the beat store and
    classifies each peer: stale past ``peer_dead_after_s`` → dead
    (recorded in ``dead_peers``; the seam raises ``PeerLostError``
    deterministically); beating but behind → ``straggler`` telemetry,
    rate-limited per peer. Armed past ``collective_timeout_s`` the main
    thread is presumed wedged inside a collective (a state Python cannot
    unwind) and the watchdog aborts the process after logging —
    classification ``peer_dead`` if a corpse was found, ``self_hang``
    otherwise."""

    def __init__(self, store: HeartbeatStore, monitor: "ClusterMonitor",
                 straggler_after_s: float, peer_dead_after_s: float,
                 collective_timeout_s: float, abort_fn=None):
        super().__init__(daemon=True, name="collective-watchdog")
        self.store = store
        self.monitor = monitor
        self.straggler_after_s = straggler_after_s
        self.peer_dead_after_s = peer_dead_after_s
        self.collective_timeout_s = collective_timeout_s
        self.dead_peers: set = set()
        self._abort_fn = abort_fn if abort_fn is not None else self._abort
        self._armed_at: Optional[float] = None
        self._armed_step = 0
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()
        self._last_straggle_log: Dict[int, float] = {}

    def arm(self, step: int) -> None:
        with self._lock:
            self._armed_at = time.time()
            self._armed_step = step

    def disarm(self) -> None:
        with self._lock:
            self._armed_at = None

    def stop(self) -> None:
        self._stop_evt.set()

    def _abort(self, verdict: str) -> None:  # pragma: no cover - os._exit
        os._exit(EXIT_WATCHDOG_ABORT)

    def check_peers(self, now: Optional[float] = None) -> None:
        """One classification pass (also called directly by the seam's
        sync wait, so detection does not depend on thread timing)."""
        now = now if now is not None else time.time()
        step = self._armed_step
        for pid, beat in self.store.read_peers(self.monitor.live_set()).items():
            if pid in self.dead_peers:
                continue
            # A peer that never published counts from the store's birth:
            # a host that failed to even start is as dead as one that
            # stopped.
            age = beat.age_s(now) if beat is not None \
                else now - self.store.started_at
            if age > self.peer_dead_after_s:
                self.dead_peers.add(pid)
                self.monitor.log("peer_lost", step=step, process_id=pid,
                                 reason="stale_heartbeat",
                                 beat_age_s=round(age, 3))
                print(f"[cluster] process {pid} heartbeat stale "
                      f"{age:.1f}s > {self.peer_dead_after_s:.1f}s: "
                      f"declaring host lost")
            elif beat is not None and beat.step < step:
                last = self._last_straggle_log.get(pid, 0.0)
                if now - last >= self.straggler_after_s:
                    self._last_straggle_log[pid] = now
                    self.monitor.log("straggler", step=step,
                                     process_id=pid,
                                     behind_steps=step - beat.step,
                                     beat_age_s=round(age, 3))

    def run(self) -> None:
        poll = max(0.02, min(self.straggler_after_s / 4, 0.25))
        while not self._stop_evt.wait(poll):
            with self._lock:
                armed_at, step = self._armed_at, self._armed_step
            if armed_at is None:
                continue
            now = time.time()
            overrun = now - armed_at
            if overrun < self.straggler_after_s:
                continue
            self.check_peers(now)
            if overrun > self.collective_timeout_s:
                # The seam did not come back: the main thread is blocked
                # (a real collective with a dead peer, or a wedged
                # dispatch). raising in this thread cannot unwind it —
                # abort deterministically.
                verdict = "peer_dead" if self.dead_peers else "self_hang"
                self.monitor.log(
                    "peer_lost", step=step,
                    process_id=self.store.process_id,
                    reason=f"watchdog_abort_{verdict}",
                    beat_age_s=round(overrun, 3))
                print(f"[cluster] dispatch seam armed {overrun:.1f}s > "
                      f"collective_timeout_s="
                      f"{self.collective_timeout_s:.1f}; aborting "
                      f"({verdict})")
                self.monitor.flush()
                self._abort_fn(verdict)
                self.disarm()  # only reached when abort_fn is a test stub


class ClusterMonitor:
    """Per-process cluster-resilience runtime.

    Owns the beat publisher thread (beats keep flowing while the main
    thread compiles, blocks, or sleeps in backoff — a slow host must
    look SLOW, not dead), the watchdog, and the restart coordinator.
    Created once by the supervisor and threaded through every fit
    attempt, like the fault injector, so epoch/world state survives
    restarts."""

    def __init__(self, cluster_dir: str, process_id: int,
                 num_processes: int, heartbeat_interval_s: float = 0.5,
                 straggler_after_s: float = 2.0,
                 peer_dead_after_s: float = 10.0,
                 collective_timeout_s: float = 120.0,
                 min_hosts: int = 1, lockstep: bool = False,
                 elastic_expand: bool = False,
                 peer_redundancy: bool = False, replica_keep: int = 2,
                 transport: str = "file", net_timeout_s: float = 5.0,
                 net_retries: int = 2, logger=None, abort_fn=None):
        self.cluster_dir = cluster_dir
        self.process_id = process_id
        self.min_hosts = min_hosts
        self.lockstep = lockstep
        self.elastic_expand = elastic_expand
        self.heartbeat_interval_s = heartbeat_interval_s
        self.peer_dead_after_s = peer_dead_after_s
        self._logger = logger
        self._log_lock = threading.Lock()
        self._survivors = list(range(num_processes))
        self.epoch = 0
        self._step = 0
        self._phase = "init"
        self._stalled = False
        self._last_beat_log = 0.0
        self._last_rejoin_scan = 0.0
        # The transport: "file" is the shared directory; "net" carries the
        # same store and coordinator contracts over parallel/net.py, the
        # service hosted by process 0 over cluster_dir, and every process
        # (process 0 too, over loopback: one code path) a client of it.
        self.net_server = None
        self.net_client = None
        if transport == "net":
            from dml_cnn_cifar10_tpu_torch.parallel import net as net_lib
            if process_id == 0:
                self.net_server = net_lib.CoordServer(cluster_dir)
            self.net_client = net_lib.CoordClient(
                cluster_dir, process_id, timeout_s=net_timeout_s,
                retries=net_retries, log_fn=self.log)
            self.store = net_lib.NetHeartbeatStore(
                cluster_dir, process_id, self.net_client, log_fn=self.log)
            self.coordinator = net_lib.NetRestartCoordinator(
                cluster_dir, self.net_client, log_fn=self.log)
        elif transport == "file":
            self.store = HeartbeatStore(cluster_dir, process_id,
                                        log_fn=self.log)
            self.coordinator = RestartCoordinator(cluster_dir,
                                                  log_fn=self.log)
        else:
            raise ValueError(f"unknown cluster transport {transport!r} "
                             f"(want 'file' or 'net')")
        # The peer-replica store rides the monitor, so its payload cache,
        # push thread and committed steps span the supervisor's attempts,
        # like the epoch and the world. None: diskless recovery off.
        self.peer_store = None
        self._pending_peer_restore = None
        if peer_redundancy:
            from dml_cnn_cifar10_tpu_torch.ckpt.peerstore import \
                PeerReplicaStore
            self.peer_store = PeerReplicaStore(
                cluster_dir, process_id, list(range(num_processes)),
                keep=replica_keep, log_fn=self.log, client=self.net_client)
        self.watchdog = CollectiveWatchdog(
            self.store, self, straggler_after_s, peer_dead_after_s,
            collective_timeout_s, abort_fn=abort_fn)
        self._stop = threading.Event()
        self._publisher = threading.Thread(
            target=self._publish_loop, daemon=True,
            name="heartbeat-publisher")
        self.store.publish(0, "init", extra=self._beat_extra())
        self._publisher.start()
        self.watchdog.start()

    @classmethod
    def from_config(cls, parallel_cfg, logger=None,
                    abort_fn=None) -> Optional["ClusterMonitor"]:
        """None when the cluster layer is off (no ``cluster_dir``)."""
        if not getattr(parallel_cfg, "cluster_dir", None):
            return None
        return cls(
            parallel_cfg.cluster_dir, parallel_cfg.process_id,
            max(parallel_cfg.num_processes, 1),
            heartbeat_interval_s=parallel_cfg.heartbeat_interval_s,
            straggler_after_s=parallel_cfg.straggler_after_s,
            peer_dead_after_s=parallel_cfg.peer_dead_after_s,
            collective_timeout_s=parallel_cfg.collective_timeout_s,
            min_hosts=parallel_cfg.min_hosts,
            lockstep=parallel_cfg.cluster_lockstep,
            elastic_expand=parallel_cfg.elastic_expand,
            peer_redundancy=parallel_cfg.peer_redundancy,
            replica_keep=parallel_cfg.replica_keep,
            transport=parallel_cfg.cluster_transport,
            net_timeout_s=parallel_cfg.net_timeout_s,
            net_retries=parallel_cfg.net_retries,
            logger=logger, abort_fn=abort_fn)

    # -- identity / world ------------------------------------------------

    @property
    def is_chief(self) -> bool:
        """Lowest LIVE process id plays chief: when process 0 itself is
        the lost host, the next survivor inherits the restart decision
        (coordinator-loss handling)."""
        live = [p for p in self._survivors
                if p not in self.watchdog.dead_peers]
        return bool(live) and self.process_id == min(live)

    def live_set(self) -> List[int]:
        return list(self._survivors)

    def world_size(self) -> int:
        return len(self._survivors)

    # -- logging (watchdog + publisher + seam threads share the sink) ---

    def log(self, kind: str, **fields) -> None:
        if self._logger is not None:
            with self._log_lock:
                self._logger.log(kind, **fields)

    def flush(self) -> None:
        if self._logger is not None and hasattr(self._logger, "flush"):
            with self._log_lock:
                self._logger.flush()

    # -- heartbeat publishing -------------------------------------------

    def _beat_extra(self) -> Optional[Dict]:
        """The replica's staleness rides the beat: the chief's decide seam
        learns every host's newest pushed replica step (a LOST host's from
        its last beat) without reading the replica store."""
        if self.peer_store is None:
            return None
        return {"replica_step": self.peer_store.replica_step}

    def _publish_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval_s):
            if not self._stalled:
                self.store.publish(self._step, self._phase,
                                   extra=self._beat_extra())

    def set_phase(self, phase: str) -> None:
        self._phase = phase

    def flush_replicas(self) -> None:
        """Wait (bounded) for this process's pending replica pushes, then
        publish a beat advertising the newest committed replica step. The
        ``host_lost`` drill calls it before the exit: a host lost after a
        boundary's replica committed, so the chief's peer decision does
        not hang on how far the push thread got."""
        if self.peer_store is None:
            return
        self.peer_store.flush()
        if not self._stalled:
            self.store.publish(self._step, self._phase,
                               extra=self._beat_extra())

    def stall_heartbeats(self) -> None:
        """Fault hook (``heartbeat_stall@N``): stop publishing while the
        process keeps running — from outside, indistinguishable from a
        dead host. The peers will declare this process lost; the
        eviction check is how it finds out."""
        self._stalled = True

    # -- dispatch-seam hooks --------------------------------------------

    def begin_step(self, step: int, phase: str = "train") -> None:
        """Publish a beat, check for eviction, arm the watchdog. Raises
        ``PeerLostError`` immediately when a peer was already declared
        dead (detected while this process was off in eval/checkpoint)."""
        self._step = step
        self._phase = phase
        if not self._stalled:
            self.store.publish(step, phase, extra=self._beat_extra())
            now = time.time()
            if now - self._last_beat_log >= self.heartbeat_interval_s:
                self._last_beat_log = now
                # wallclock anchors cross-host clock alignment: each
                # process's JSONL `t` is relative to ITS logger start,
                # so tools/trace_aggregate.py recovers a per-stream
                # unix offset from (wallclock - t) to merge streams
                # onto one timeline.
                self.log("heartbeat", step=step,
                         process_id=self.process_id, phase=phase,
                         wallclock=round(now, 3))
                self._export_gauges(now)
        self.check_evicted(step)
        self.watchdog.arm(step)
        self._raise_if_dead(step)
        self._maybe_raise_rejoin(step)

    def _export_gauges(self, now: float) -> None:
        """The JAX module's live gauges (world size, epoch, each peer's
        beat age) feed the trainer's ``GET /metrics``, whose server is
        not ported (ROADMAP.md Queue 1 item 6): nothing would read them,
        so this does nothing until it comes."""
        del now

    def sync(self, step: int, poll_s: float = 0.02) -> None:
        """Simulated collective barrier (``cluster_lockstep``): wait for
        every live peer's beat to reach ``step``. The wait is where a
        2-process CPU simulation "blocks in the collective" — and where
        the watchdog's classification frees it: a dead peer raises
        ``PeerLostError``, an eviction raises ``EvictedError``."""
        if not self.lockstep:
            return
        attempt = 0
        while True:
            self._raise_if_dead(step)
            self.check_evicted(step)
            beats = self.store.read_peers(self.live_set())
            if all(b is not None and b.step >= step
                   for b in beats.values()):
                return
            self.watchdog.check_peers()
            # Bounded backoff (utils/backoff.py), reset per barrier: an
            # in-sync world pays the base poll; a straggler-bound wait
            # decays to the cap instead of re-scanning the store at
            # 50 Hz for the whole gap.
            attempt += 1
            time.sleep(backoff.delay_s(poll_s, 0.2, attempt))

    def end_step(self, step: int) -> None:
        self._step = step
        self.watchdog.disarm()

    def _raise_if_dead(self, step: int) -> None:
        dead = sorted(self.watchdog.dead_peers)
        if dead:
            self.watchdog.disarm()
            raise PeerLostError(
                dead, f"process(es) {dead} lost (heartbeats stale > "
                      f"{self.peer_dead_after_s:.1f}s) at step {step}")

    def check_evicted(self, step: int) -> None:
        """Seam check against the coordinator's decision file. Three
        outcomes for a decision at a NEWER epoch than ours:

        - this process excluded → :class:`EvictedError` (fence; under
          ``elastic_expand`` the supervisor turns the fence into a
          rejoin request instead of exiting);
        - this process included → the chief already committed a new
          world while we were mid-step (a shrink we have not classified
          yet, or an expand). Re-read with bounded backoff so we settle
          on the NEWEST epoch instead of racing a chief that may be
          writing again, then exit through the clean ``peer_lost`` path
          (empty ``process_ids``) — the supervisor adopts the pending
          decision rather than deciding one of its own."""
        d = self.coordinator.read()
        if d is None or d.epoch <= self.epoch:
            return
        if self.process_id in d.survivors:
            # Bounded re-read + backoff (utils/backoff.py): one decision
            # write can be chased by another (e.g. shrink then expand in
            # quick succession); settle before acting.
            for attempt in range(1, 4):
                time.sleep(backoff.delay_s(0.02, 0.2, attempt))
                d2 = self.coordinator.read()
                if d2 is None or d2.epoch <= d.epoch:
                    break
                d = d2
        if self.process_id not in d.survivors:
            self.log("peer_lost", step=step, process_id=self.process_id,
                     reason="evicted")
            raise EvictedError(
                f"restart epoch {d.epoch} excluded process "
                f"{self.process_id} (survivors {d.survivors}); fencing")
        self.watchdog.disarm()
        self.log("peer_lost", step=step, process_id=self.process_id,
                 reason="stale_epoch")
        raise PeerLostError(
            [], f"coordinator epoch {d.epoch} > adopted epoch "
                f"{self.epoch} at step {step}: a new world was already "
                f"committed; re-entering through the restart path")

    # -- coordinated elastic restart ------------------------------------

    def decide_restart(self, lost: Sequence[int],
                       restore_step: int) -> RestartDecision:
        """Chief half of the protocol: shrink the world by the lost
        hosts, pick the restore source (the peer replicas when every
        old-world host, the lost one included, advertised a pushed
        replica; the disk walk otherwise) and commit the decision
        survivors will poll. ``restore_step`` is the disk candidate (the
        newest checkpoint); a peer-sourced decision restores at the
        replica step instead. Raises ``PeerLostError`` (unrecoverable by
        world-shrink) when the survivor set would fall under
        ``min_hosts``."""
        survivors = [p for p in self._survivors if p not in set(lost)]
        if len(survivors) < self.min_hosts:
            raise PeerLostError(
                sorted(lost),
                f"only {len(survivors)} survivor(s) left, below "
                f"min_hosts={self.min_hosts}; halting")
        source, step = self._choose_restore_source(restore_step)
        return self.coordinator.record(RestartDecision(
            epoch=self.epoch + 1, world_size=len(survivors),
            restore_step=step, survivors=survivors, source=source))

    def _choose_restore_source(self, disk_step: int):
        """Peer or disk, from the beats: the restore step is the MINIMUM
        replica step the old world's hosts advertised (a lost host's last
        beat persists), the newest every replica set can serve; viable
        when every host pushed once. Logged as a ``peer_replica``
        ``decide`` record with its staleness (beat steps ahead of the
        replica step)."""
        if self.peer_store is None or not self.peer_store.enabled:
            return "disk", disk_step
        beats = self.store.read_all()
        steps = []
        for pid in self._survivors:
            if pid == self.process_id:
                steps.append(self.peer_store.replica_step)
                continue
            beat = beats.get(pid)
            extra = beat.extra if beat is not None else None
            steps.append(int((extra or {}).get("replica_step", -1)))
        peer_step = min(steps) if steps else -1
        beat_step = max([b.step for p, b in beats.items()
                         if p in self._survivors] + [self._step])
        ok = peer_step >= 0
        self.log("peer_replica", op="decide",
                 step=peer_step if ok else disk_step, owner=None,
                 bytes=None, secs=None, ok=ok, error=None,
                 staleness=max(beat_step - peer_step, 0) if ok else None)
        if not ok:
            return "disk", disk_step
        return "peer", peer_step

    def await_restart(self, timeout_s: float) -> RestartDecision:
        """Non-chief half: poll for the chief's decision; fence if it
        excludes this process."""
        d = self.coordinator.await_decision(self.epoch + 1, timeout_s)
        if self.process_id not in d.survivors:
            self.log("peer_lost", step=d.restore_step,
                     process_id=self.process_id, reason="evicted")
            raise EvictedError(
                f"restart epoch {d.epoch} excluded process "
                f"{self.process_id}; fencing")
        return d

    def adopt(self, decision: RestartDecision) -> None:
        """Enter the new world: the decision's survivor set (smaller on
        a shrink, larger on an expand), next epoch, dead bookkeeping
        cleared (the dead are no longer expected — and a rejoined host
        must stop counting as a corpse). A peer-sourced decision is
        staged for the next attempt's restore seam
        (:meth:`take_peer_restore`); the replica ring re-forms over the
        new world."""
        old_world = list(self._survivors)
        self.epoch = decision.epoch
        self._survivors = list(decision.survivors)
        self.watchdog.dead_peers.clear()
        self._phase = "restart"
        if self.peer_store is not None:
            if decision.source == "peer":
                new = set(decision.survivors)
                lost = [p for p in old_world if p not in new]
                self._pending_peer_restore = (
                    decision, sorted(set(old_world) | new), lost)
            self.peer_store.set_world(list(decision.survivors))

    def take_peer_restore(self):
        """One-shot handoff to the restore seam: ``(decision, old world,
        lost)`` of an adopted peer-sourced decision, or None. Taking it
        clears it: a disk fallback must not replay the peer attempt on
        the attempt after."""
        pending = self._pending_peer_restore
        self._pending_peer_restore = None
        return pending

    # -- coordinated elastic scale-UP (expand) ---------------------------

    def rejoin_candidates(self) -> List[int]:
        """Process ids OUTSIDE the current survivor set with a FRESH
        ``rejoin``-phase beat — hosts asking to be let back in (or
        brand-new hosts announcing themselves). Read-only; any seat may
        query it (the fault injector's ``host_return`` drill polls it
        to make the 2→1→2 CPU sim deterministic)."""
        out = []
        now = time.time()
        for pid, beat in self.store.read_all().items():
            if pid == self.process_id or pid in self._survivors:
                continue
            if beat.phase == "rejoin" \
                    and beat.age_s(now) <= self.peer_dead_after_s:
                out.append(pid)
        return sorted(out)

    def _maybe_raise_rejoin(self, step: int) -> None:
        """Chief-side expand trigger, rate-limited to the heartbeat
        cadence: a fresh rejoin announcement raises
        :class:`PeerRejoinError` so the supervisor coordinates the
        expand. Off unless ``elastic_expand`` — the shrink-only
        behavior (returning hosts stay fenced) is the default."""
        if not self.elastic_expand or not self.is_chief:
            return
        now = time.time()
        if now - self._last_rejoin_scan < self.heartbeat_interval_s:
            return
        self._last_rejoin_scan = now
        joiners = self.rejoin_candidates()
        if not joiners:
            return
        self.watchdog.disarm()
        for pid in joiners:
            self.log("host_rejoin", step=step, process_id=pid,
                     epoch=self.epoch)
        raise PeerRejoinError(
            joiners, f"process(es) {joiners} announced rejoin at step "
                     f"{step}; coordinating elastic expand")

    def decide_expand(self, joiners: Sequence[int],
                      restore_step: int) -> RestartDecision:
        """Chief half of the expand protocol: grow the survivor set by
        the announced joiners and commit the monotone-epoch decision
        (atomic rename, same file the shrink path uses). The joiners
        poll it via :meth:`await_inclusion`; surviving non-chiefs
        observe the newer epoch at their next seam check and re-enter
        through the clean ``peer_lost`` path."""
        survivors = sorted(set(self._survivors) | set(joiners))
        return self.coordinator.record(RestartDecision(
            epoch=self.epoch + 1, world_size=len(survivors),
            restore_step=restore_step, survivors=survivors,
            kind="expand"))

    def request_rejoin(self) -> None:
        """Returning-host half: adopt the world that excluded us as the
        current truth (so :meth:`await_inclusion` waits for a STRICTLY
        newer epoch), clear the stall/death bookkeeping a previous life
        may have left, and start announcing with ``rejoin``-phase beats
        (one published immediately; the background publisher keeps them
        flowing)."""
        d = self.coordinator.read()
        if d is not None and d.epoch > self.epoch:
            self.epoch = d.epoch
            self._survivors = list(d.survivors)
        self.watchdog.dead_peers.clear()
        self.watchdog.disarm()
        self._stalled = False
        self._phase = "rejoin"
        self.store.publish(self._step, "rejoin", extra=self._beat_extra())

    def await_inclusion(self, timeout_s: float,
                        poll_s: float = 0.05) -> RestartDecision:
        """Block until a decision at a NEWER epoch includes this
        process. A chief that never answers within ``timeout_s`` is a
        refused (or coordinator-lost) rejoin: raise ``PeerLostError``
        so the caller can fence cleanly instead of polling forever."""
        deadline = time.time() + timeout_s
        attempt = 0
        while True:
            d = self.coordinator.read()
            if d is not None and d.epoch > self.epoch \
                    and self.process_id in d.survivors:
                return d
            if time.time() > deadline:
                raise PeerLostError(
                    [], f"no expand decision including process "
                        f"{self.process_id} at epoch > {self.epoch} "
                        f"within {timeout_s:.1f}s — rejoin refused or "
                        f"coordinator lost")
            # Same bounded-backoff poll as await_decision: a waiting
            # joiner must not hammer the shared decision file.
            attempt += 1
            time.sleep(backoff.delay_s(poll_s, poll_s * 10.0, attempt))

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        self._stop.set()
        self.watchdog.stop()
        if self.peer_store is not None:
            self.peer_store.close()
        self._publisher.join(timeout=2.0)
        self.watchdog.join(timeout=2.0)
        if self.net_server is not None:
            self.net_server.stop()
