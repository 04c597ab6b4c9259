"""Peer-redundant shard replicas: the diskless-recovery transport.

The protocol of ``dml_cnn_cifar10_tpu/ckpt/peerstore.py``, rebuilt on the
port's own shard code (``ckpt/sharded.py``) instead of ``jax.tree_util``.
Its files are the JAX module's, so a replica directory written by either
package reads back in the other.

Every recovery walks disk checkpoints; this module keeps a **cold replica
of each host's shard payload on a peer**, so an elastic restart can
rebuild a lost host's state from a surviving peer's copy (zero checkpoint
reads) and fall back to the disk walk only when a replica is missing,
stale or corrupt.

- **Ring.** Hosts form a ring over the sorted live world; each pushes its
  payload to its ring successor (:func:`ring_successor`). A 1-host world
  degrades to a no-op: the flag stays legal, nothing is pushed.
- **Push.** At every committed checkpoint boundary the trainer collects
  its shard payload (``sharded.collect_local_shards``: its data shards
  and model slices with their JAX-layout index ranges) on the step
  thread, since the next step's K1/K2 update the tensors in place, and
  hands it to a bounded background thread: the step never waits on
  replica IO. The payload is written as one part file with the sharded
  codec's sha256 sidecar into
  ``<cluster_dir>/replicas/host_<owner>/step_<step:08d>/`` with an
  ``INDEX.json`` commit marker, committed by an atomic rename of the
  whole directory, and kept for the newest ``keep`` steps. A failed push
  retries over the shared bounded backoff (``utils/backoff.py``) and is
  logged, never raised into training.
- **Staleness.** The owner's newest committed step
  (:attr:`PeerReplicaStore.replica_step`) rides the heartbeat's
  ``extra``, so the chief's ``decide_restart`` can tell whether a peer
  restore is viable without reading the store.
- **Restore.** A survivor takes its own payload from memory (its own
  replica file when the cache misses the step), each other owner's from
  its committed replica, verifies every sidecar, and assembles the whole
  state with a coverage mask (:func:`assemble`), the lost owners'
  entries placed first: fully duplicate ranges (the lockstep simulation,
  where every payload covers everything) are skipped, so there the state
  is the lost host's replica, and a partial overlap or a hole is a
  :class:`ReplicaMiss`. The whole leaves then go through
  ``checkpoint.load_tree_into``, which converts them to the port's
  layouts and copies them, in place, into the target state's tensors on
  the card (into this rank's shards and slices where the state keeps
  them), so K1/K2 see the contiguous leaves a trained state has, and a
  chunk's CUDA graph, bound to those tensors, stays valid.

Over the network transport (``parallel/net.py``) a push stages its files
locally, uploads them under a ``.tmpnet`` directory and commits with one
server-side rename; a read downloads a committed replica into a scratch
directory shaped like the on-disk one.

Telemetry: pushes, verifies, reconstructs and fallbacks are
``peer_replica`` records; replica reads are ``shard_io`` records with
``source="peer"`` (disk reads say ``"disk"``), so a peer restore's zero
checkpoint reads show in the stream.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dml_cnn_cifar10_tpu_torch.ckpt import sharded
from dml_cnn_cifar10_tpu_torch.utils import backoff

#: Store directory under ``cluster_dir``, beside ``heartbeats/``.
REPLICAS_DIRNAME = "replicas"

#: Per-replica commit marker, written INSIDE the step directory before
#: the atomic directory rename publishes it.
INDEX = "INDEX.json"

#: Push attempts over the shared bounded backoff before a push is
#: abandoned (logged ``ok=False``; the next boundary pushes a fresher
#: payload anyway).
PUSH_ATTEMPTS = 3


class ReplicaMiss(ValueError):
    """A needed replica is missing, stale, or failed its integrity check.
    Classified (a ``ValueError`` naming the replica), so the restore seam
    falls back to the disk walk instead of crashing."""


def ring_successor(pid: int, world: Sequence[int]) -> int:
    """The host ``pid`` pushes its replica TO: the next id on the sorted
    ring. A 1-host world maps a host to itself (no-op)."""
    ring = sorted(world)
    return ring[(ring.index(pid) + 1) % len(ring)]


def ring_predecessor(pid: int, world: Sequence[int]) -> int:
    """The host whose replica ``pid`` holds: the previous ring id."""
    ring = sorted(world)
    return ring[(ring.index(pid) - 1) % len(ring)]


def _entries(entries) -> list:
    """A leaf's entries as a list (a msgpack round trip through flax
    turns a list into a ``{"0": ...}`` dict)."""
    return list(entries.values()) if isinstance(entries, dict) else entries


def _payload_nbytes(payload: Dict[str, list]) -> int:
    return sum(int(np.asarray(e["data"]).nbytes)
               for entries in payload.values() for e in _entries(entries))


class PeerReplicaStore:
    """File-backed peer-replica store beside the heartbeat directory.

    One background thread drains a queue of at most two pending payloads
    (the newest wins: under a slow store the freshest state is the one
    worth replicating). ``client`` (a ``parallel/net.py`` ``CoordClient``)
    carries pushes and reads over the network transport; its
    ``TransportError`` is an ``OSError``, so every retry and miss path
    below treats a network failure like a filesystem one."""

    def __init__(self, cluster_dir: str, process_id: int,
                 world: Sequence[int], keep: int = 2,
                 log_fn: Optional[Callable[..., None]] = None,
                 client=None):
        self._client = client
        self.root = os.path.join(cluster_dir, REPLICAS_DIRNAME)
        self.process_id = process_id
        self.world = sorted(world) if world else [process_id]
        self.keep = max(int(keep), 1)
        self._log = log_fn
        #: Committed pushes (the pushes-against-boundaries pin reads it).
        self.pushes = 0
        self._mem: Dict[int, Dict[str, list]] = {}
        self._queue: List[Tuple[int, Dict[str, list]]] = []
        self._cv = threading.Condition()
        self._closing = False
        self._inflight = 0
        # The store spans the supervisor's attempts, but a rebuilt one
        # still counts the newest replica it committed.
        steps = self.committed_steps(process_id)
        self._replica_step = steps[-1] if steps else -1
        self._worker = threading.Thread(
            target=self._drain, daemon=True, name="peer-replica-push")
        self._worker.start()

    # -- identity ---------------------------------------------------------

    @property
    def enabled(self) -> bool:
        """Redundancy means something only with a peer to hold the copy."""
        return len(self.world) > 1

    @property
    def replica_step(self) -> int:
        """Newest OWN committed replica step (-1: none yet), the number
        the heartbeat's ``extra`` advertises."""
        return self._replica_step

    def successor(self) -> int:
        return ring_successor(self.process_id, self.world)

    def set_world(self, world: Sequence[int]) -> None:
        """Adopt a restart decision's survivor set: the ring re-forms over
        the new world (a 1-host world stops pushing)."""
        with self._cv:
            self.world = sorted(world) if world else [self.process_id]

    # -- paths ------------------------------------------------------------

    def _host_dir(self, owner: int) -> str:
        return os.path.join(self.root, f"host_{owner}")

    def _step_dir(self, owner: int, step: int) -> str:
        return os.path.join(self._host_dir(owner), f"step_{step:08d}")

    def _host_rel(self, owner: int) -> str:
        """An owner's replica directory relative to the served one."""
        return f"{REPLICAS_DIRNAME}/host_{owner}"

    def _step_rel(self, owner: int, step: int) -> str:
        return f"{self._host_rel(owner)}/step_{step:08d}"

    def committed_steps(self, owner: int) -> List[int]:
        """Sorted committed replica steps of ``owner`` (commit marker
        present; half-renamed tmp directories are invisible). Over the
        network an unreachable coordinator reads as no commits, so the
        decide seam falls back to disk."""
        out: List[int] = []
        if self._client is not None:
            try:
                names = self._client.list_dir(self._host_rel(owner))
            except OSError:
                return out
            # Visible means committed: the server publishes a step
            # directory only by the rename that ends a push.
            for name in names:
                if name.startswith("step_") and ".tmp" not in name:
                    try:
                        out.append(int(name[len("step_"):]))
                    except ValueError:
                        continue
            return sorted(out)
        try:
            names = os.listdir(self._host_dir(owner))
        except OSError:
            return out
        for name in names:
            if not name.startswith("step_") or ".tmp" in name:
                continue
            try:
                step = int(name[len("step_"):])
            except ValueError:
                continue
            if os.path.isfile(os.path.join(self._host_dir(owner), name,
                                           INDEX)):
                out.append(step)
        return sorted(out)

    # -- telemetry --------------------------------------------------------

    def _emit(self, op: str, step=None, owner=None, nbytes=None,
              secs=None, ok=None, error=None, staleness=None) -> None:
        if self._log is not None:
            self._log("peer_replica", op=op, step=step, owner=owner,
                      bytes=nbytes, secs=secs, ok=ok, error=error,
                      staleness=staleness)

    # -- push side --------------------------------------------------------

    def push_state_async(self, step: int, state, rank: int = 0) -> bool:
        """The trainer's checkpoint-boundary seam: copy THIS rank's shard
        payload to host memory now (the next step updates the tensors in
        place) and hand it to the push thread. False in a 1-host world."""
        if not self.enabled:
            return False
        return self.push_async(step, sharded.collect_local_shards(state,
                                                                  rank))

    def push_async(self, step: int, payload: Dict[str, list]) -> bool:
        if not self.enabled:
            return False
        with self._cv:
            self._mem[int(step)] = payload
            for old in sorted(self._mem)[:-self.keep]:
                del self._mem[old]
            self._queue.append((int(step), payload))
            if len(self._queue) > 2:
                self._queue.pop(0)   # the newest wins under a slow store
            self._cv.notify()
        return True

    def _drain(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closing:
                    self._cv.wait()
                if not self._queue:
                    return
                step, payload = self._queue.pop(0)
                self._inflight += 1
            try:
                self._push_with_retry(step, payload)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _push_with_retry(self, step: int, payload: Dict[str, list]) -> None:
        err = None
        for attempt in range(1, PUSH_ATTEMPTS + 1):
            try:
                self._push(step, payload)
                return
            except OSError as e:
                err = e
                if attempt < PUSH_ATTEMPTS:
                    time.sleep(backoff.delay_s(0.05, 1.0, attempt))
        # Abandoned: logged, never raised. The next boundary replicates a
        # fresher payload, and the decide seam sees the gap in the
        # advertised replica_step.
        self._emit("push", step=step, owner=self.process_id, ok=False,
                   error=str(err)[:300])

    def _write_parts(self, d: str, payload: Dict[str, list]
                     ) -> Tuple[List[str], int]:
        """The payload's part file and its sidecar in ``d``: (names,
        bytes). One part, as the JAX store writes it."""
        name = "part_0.msgpack"
        return [name], sharded._write_one_shard(d, name, payload, None,
                                                source="peer")

    def _index(self, step: int, names: List[str]) -> dict:
        return {"owner": self.process_id, "dest": self.successor(),
                "step": int(step), "files": names}

    def _push(self, step: int, payload: Dict[str, list]) -> None:
        t0 = time.perf_counter()
        if self._client is not None:
            total = self._push_net(step, payload)
        else:
            final = self._step_dir(self.process_id, step)
            if os.path.isfile(os.path.join(final, INDEX)):
                return   # already committed (a replayed boundary)
            tmp = final + f".tmp{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            names, total = self._write_parts(tmp, payload)
            idx_tmp = os.path.join(tmp, INDEX + ".tmp")
            with open(idx_tmp, "w") as f:
                json.dump(self._index(step, names), f)
            os.replace(idx_tmp, os.path.join(tmp, INDEX))
            os.rename(tmp, final)   # the commit point
        if total is None:
            return
        self._replica_step = max(self._replica_step, int(step))
        self.pushes += 1
        self._emit("push", step=step, owner=self.process_id, nbytes=total,
                   secs=round(time.perf_counter() - t0, 6), ok=True)
        self._prune()

    def _push_net(self, step: int, payload: Dict[str, list]
                  ) -> Optional[int]:
        """Stage the parts and sidecars locally, upload them under a
        ``.tmpnet`` step directory (the commit marker last), then commit
        with ONE server-side rename. None: already committed."""
        if step in self.committed_steps(self.process_id):
            return None
        rel_final = self._step_rel(self.process_id, step)
        rel_tmp = rel_final + f".tmpnet{os.getpid()}"
        scratch = tempfile.mkdtemp(prefix="dml_peer_push_")
        try:
            names, total = self._write_parts(scratch, payload)
            for fname in sorted(os.listdir(scratch)):
                with open(os.path.join(scratch, fname), "rb") as f:
                    self._client.put(f"{rel_tmp}/{fname}", f.read())
            self._client.put(f"{rel_tmp}/{INDEX}",
                             json.dumps(self._index(step, names)).encode())
            self._client.rename(rel_tmp, rel_final)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        return total

    def _prune(self) -> None:
        for step in self.committed_steps(self.process_id)[:-self.keep]:
            if self._client is not None:
                try:
                    self._client.delete_tree(
                        self._step_rel(self.process_id, step))
                except OSError:
                    pass   # the next boundary's prune retries
            else:
                shutil.rmtree(self._step_dir(self.process_id, step),
                              ignore_errors=True)

    def flush(self, timeout_s: float = 10.0) -> None:
        """Wait for the pending pushes (tests and the fault drills; never
        on the step path)."""
        deadline = time.time() + timeout_s
        with self._cv:
            while (self._queue or self._inflight) \
                    and time.time() < deadline:
                self._cv.wait(timeout=0.05)

    # -- read side --------------------------------------------------------

    def _fetch_replica(self, owner: int, step: int) -> str:
        """Net mode: download one committed replica (marker, parts,
        sidecars) into a scratch directory shaped like the on-disk one.
        An unreachable or uncommitted replica is a :class:`ReplicaMiss`."""
        rel = self._step_rel(owner, step)
        try:
            idx_payload = self._client.get(f"{rel}/{INDEX}")
        except OSError as e:
            raise ReplicaMiss(
                f"replica of host {owner} at step {step} unreachable over "
                f"the net transport: {e}")
        if idx_payload is None:
            raise ReplicaMiss(
                f"replica of host {owner} at step {step} is missing or "
                f"stale (committed steps: "
                f"{self.committed_steps(owner) or 'none'})")
        try:
            files = json.loads(idx_payload)["files"]
        except (ValueError, TypeError, KeyError) as e:
            raise ReplicaMiss(
                f"replica of host {owner} at step {step} has an "
                f"undecodable commit marker: {e}")
        scratch = os.path.join(tempfile.mkdtemp(prefix="dml_peer_read_"),
                               f"step_{step:08d}")
        os.makedirs(scratch)
        with open(os.path.join(scratch, INDEX), "wb") as f:
            f.write(idx_payload)
        for fname in files:
            for name in (fname, sharded.shard_checksum_path(fname)):
                try:
                    payload = self._client.get(f"{rel}/{name}")
                except OSError as e:
                    raise ReplicaMiss(
                        f"replica of host {owner} at step {step} "
                        f"unreachable mid-read: {e}")
                if payload is None:
                    continue   # a sidecar-less replica still decodes
                with open(os.path.join(scratch, name), "wb") as f:
                    f.write(payload)
        return scratch

    def read_replica(self, owner: int, step: int,
                     on_event=None) -> Dict[str, list]:
        """Read and sidecar-verify one committed replica. Every failure
        (missing directory or marker, truncated file, digest mismatch) is
        a :class:`ReplicaMiss`. A replica without sidecars decodes (the
        sharded codec's rule)."""
        if self._client is not None:
            d = self._fetch_replica(owner, step)
            try:
                return self._read_replica_dir(d, owner, step, on_event)
            finally:
                shutil.rmtree(os.path.dirname(d), ignore_errors=True)
        return self._read_replica_dir(self._step_dir(owner, step), owner,
                                      step, on_event)

    def _read_replica_dir(self, d: str, owner: int, step: int,
                          on_event=None) -> Dict[str, list]:
        idx = os.path.join(d, INDEX)
        if not os.path.isfile(idx):
            raise ReplicaMiss(
                f"replica of host {owner} at step {step} is missing or "
                f"stale (committed steps: "
                f"{self.committed_steps(owner) or 'none'})")
        t0 = time.perf_counter()
        try:
            with open(idx) as f:
                files = json.load(f)["files"]
        except (OSError, ValueError, KeyError) as e:
            raise ReplicaMiss(
                f"replica of host {owner} at step {step} has an "
                f"undecodable commit marker: {e}")
        payload: Dict[str, list] = {}
        total = 0
        for fname in files:
            try:
                part = sharded._read_one_shard(d, fname, on_event,
                                               source="peer")
            except (OSError, ValueError) as e:
                self._emit("verify", step=step, owner=owner, ok=False,
                           error=str(e)[:300])
                raise ReplicaMiss(
                    f"replica of host {owner} at step {step} failed "
                    f"verification: {e}") from e
            total += os.path.getsize(os.path.join(d, fname))
            for path, entries in part.items():
                payload.setdefault(path, []).extend(_entries(entries))
        self._emit("verify", step=step, owner=owner, nbytes=total,
                   secs=round(time.perf_counter() - t0, 6), ok=True)
        return payload

    def gather(self, step: int, world: Sequence[int],
               lost: Sequence[int] = (), on_event=None
               ) -> List[Tuple[int, Dict[str, list]]]:
        """Every owner's payload at ``step``, this process's first: its
        own from memory (its replica file when the cache misses the
        step), the others' from their committed replicas. ``world`` is
        the OLD world that wrote them (survivors and lost)."""
        lost_set = set(lost)
        out = []
        for owner in sorted(set(world),
                            key=lambda p: (p != self.process_id, p)):
            if owner == self.process_id and step in self._mem:
                payload = self._mem[step]
                if on_event is not None:
                    on_event("shard_io", op="restore",
                             shard=f"host_{owner}/step_{step:08d}/memory",
                             bytes=_payload_nbytes(payload), secs=0.0,
                             verify=None, source="peer")
            else:
                t0 = time.perf_counter()
                payload = self.read_replica(owner, step, on_event=on_event)
                if owner in lost_set:
                    self._emit("reconstruct", step=step, owner=owner,
                               nbytes=_payload_nbytes(payload),
                               secs=round(time.perf_counter() - t0, 6),
                               ok=True)
            out.append((owner, payload))
        return out

    def restore(self, target, step: int, world: Sequence[int],
                lost: Sequence[int] = (), on_event=None):
        """The whole state at ``step`` from peer replicas, copied into
        ``target`` (a port ``TrainState``) in place, with ZERO checkpoint
        reads. Any missing or corrupt payload, or incomplete coverage, is
        a :class:`ReplicaMiss`; the caller falls back to the disk walk."""
        from dml_cnn_cifar10_tpu_torch.ckpt.checkpoint import load_tree_into

        payloads = self.gather(step, world, lost, on_event)
        # The lost owners' entries are placed first: where payloads cover
        # the same ranges (every lockstep payload covers everything), the
        # state comes from the replicas, and a survivor's own payload fills
        # only what they lack.
        lost_set = set(lost)
        payloads.sort(key=lambda item: item[0] not in lost_set)
        arrays = assemble(payloads, sharded.leaves_meta(target), step)
        return load_tree_into(target, sharded.tree_of(arrays))

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        self._worker.join(timeout=5.0)


def assemble(payloads: List[Tuple[int, Dict[str, list]]],
             meta: Dict[str, dict], step: int) -> Dict[str, np.ndarray]:
    """``{path: whole leaf}`` of every leaf of ``meta`` (``{path:
    {"shape", "dtype"}}``, JAX layouts: ``sharded.leaves_meta``) from the
    payloads' entries, under a coverage mask. An entry whose range is
    already covered whole is skipped (redundant replicas; the payloads'
    order decides); a partial overlap or a hole is a :class:`ReplicaMiss`.
    Entries of leaves ``meta`` lacks are ignored."""
    shards: Dict[str, list] = {}
    for _owner, payload in payloads:
        for path, entries in payload.items():
            shards.setdefault(path, []).extend(_entries(entries))
    out = {}
    for path, info in meta.items():
        full = np.empty(tuple(info["shape"]), dtype=np.dtype(info["dtype"]))
        seen = np.zeros(full.shape, dtype=bool)
        for e in shards.get(path, ()):
            idx = tuple(slice(int(a), int(b)) for a, b in
                        np.asarray(e["index"], dtype=np.int64).reshape(-1, 2))
            sub = seen[idx]
            if sub.size and sub.all():
                continue   # redundant coverage from a second replica
            if sub.any():
                raise ReplicaMiss(
                    f"leaf {path!r} has partially-overlapping replica "
                    f"entries at {e['index']} for step {step}")
            full[idx] = e["data"]
            seen[idx] = True
        if not seen.all():
            raise ReplicaMiss(
                f"leaf {path!r} only {int(seen.sum())}/{full.size} elements "
                f"covered by peer replicas at step {step}")
        out[path] = full
    return out
