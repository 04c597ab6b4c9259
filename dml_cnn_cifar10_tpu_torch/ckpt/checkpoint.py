"""Checkpointing: save/restore the full training state.

Port of the msgpack path of ``dml_cnn_cifar10_tpu/ckpt/checkpoint.py``,
with the MonitoredTrainingSession contract of the reference
(``cifar10cnn.py:222``): periodic saves, restore-if-present at startup,
resume at the saved global step.

Files are the JAX package's: ``ckpt_<step>.msgpack`` holding the state in
``flax.serialization``'s byte layout — written here with ``msgpack``
alone — a ``ckpt_<step>.msgpack.sha256`` integrity sidecar, and a
``checkpoint`` index naming the newest. The state is stored as the JAX
package's ``TrainState`` pytree (``{"params", "opt", "model_state"}``,
params in the JAX layouts via ``convert.py``, dict keys sorted as JAX's
tree flattening leaves them), so a checkpoint of either package restores
into the other, and the bytes are identical for equal values. The
``sharded`` format (``ckpt_<step>.sharded/``, ``ckpt/sharded.py``) is
ported too: every rank writes its own shards, the chief commits the
manifest; the orbax format is not (it needs ``orbax.checkpoint``, which
imports JAX). Restore detects the format, newest first, and loads either
into any layout (``parallel/zero.py``: none, zero1, fsdp).

In a multi-rank run the msgpack file holds the whole state: only the
chief writes it, and every rank waits at a barrier until it is committed
(until it is handed to the writer, under ``async_save``). Under a
sharded layout the copy to host memory is a gather over the data ranks,
and under tensor parallelism over the model ranks too (each sliced leaf
all-gathered whole, so the bytes are a replicated run's at the same
values), which every rank enters (:func:`state_to_tree`); a restore cuts
each whole leaf back to the rank's slice and shard. Every rank restores
from the same files, and a checkpoint written under sequence or data
parallelism restores into a one-process run.

:class:`CheckpointManager` (JAX ``ckpt/checkpoint.py:483-620``) saves on
a step cadence and, with ``every_secs``, on a wall-clock one that the
caller polls (:meth:`CheckpointManager.time_due`; several ranks must
agree before acting on it). With ``async_save`` the copy of the state to
host memory still happens at the call, before the next dispatch updates
the parameters in place, while the msgpack encoding, the file, its sha256
sidecar and the data-state sidecar are written on one writer thread that
touches no device tensor; saves stay in order, and a writer error is
raised at the next ``maybe_save``, ``flush`` or ``close``.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import re
import shutil
import sys
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import msgpack
import numpy as np
import torch

from dml_cnn_cifar10_tpu_torch import convert
from dml_cnn_cifar10_tpu_torch.ckpt import sharded as sharded_lib
from dml_cnn_cifar10_tpu_torch.parallel import tp, zero
from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh
from dml_cnn_cifar10_tpu_torch.parallel.step import TrainState

_CKPT_RE = re.compile(r"ckpt_(\d+)\.(msgpack|sharded)$")
FORMATS = ("msgpack", "sharded")

# flax.serialization's msgpack extension codes.
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_MAX_ARRAY_BYTES = 2 ** 30  # flax splits larger arrays into chunks


def _ckpt_path(ckpt_dir: str, step: int, fmt: str = "msgpack") -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step}.{fmt}")


# --------------------------------------------------------------------------
# msgpack codec (flax.serialization's layout)
# --------------------------------------------------------------------------

def _ext_pack(x):
    if isinstance(x, np.ndarray):
        if x.nbytes > _MAX_ARRAY_BYTES:
            raise ValueError(
                f"array of {x.nbytes} bytes exceeds the unchunked msgpack "
                "limit this codec writes")
        payload = msgpack.packb((x.shape, x.dtype.name, x.tobytes("C")),
                                use_bin_type=True)
        return msgpack.ExtType(_EXT_NDARRAY, payload)
    raise TypeError(f"cannot serialize {type(x).__name__}")


def _ext_unpack(code: int, data: bytes):
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
        return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())
                             ).reshape(shape).copy()
    return msgpack.ExtType(code, data)


def to_bytes(tree: Mapping[str, Any]) -> bytes:
    """Nested dicts of numpy arrays → msgpack bytes (flax's layout)."""
    return msgpack.packb(tree, default=_ext_pack, strict_types=True)


def from_bytes(data: bytes) -> Dict[str, Any]:
    tree = msgpack.unpackb(data, ext_hook=_ext_unpack, raw=False)
    if not isinstance(tree, dict):
        raise ValueError("checkpoint payload is not a state dict")
    return tree


def state_to_tree(state: TrainState) -> Dict[str, Any]:
    """The JAX package's ``TrainState`` pytree of ``state`` (numpy, JAX
    layouts), field order params/opt/model_state, dict keys sorted. Under
    a sharded layout, tensor parallelism or pipeline stages every rank
    must call it (it gathers)."""
    def full(key, values):
        return tp.whole(state, key, zero.whole(state, key, values))

    def mstate(values):
        # The ResNet's tree: None at every leaf that is not a BN layer's.
        return convert.state_to_jax(values, state.params) \
            if state.stateful else {}

    opt = {}
    for key in sorted(state.opt):
        value = state.opt[key]
        # np.array copies: on the CPU .numpy() would share the live
        # tensor's memory, which the next step updates in place.
        if key == "ema_mstate":
            opt[key] = mstate(value)
        elif isinstance(value, Mapping):
            opt[key] = convert.params_to_jax(
                full(key, value), convert.OPT_LAYOUTS.get(key, "port"))
        else:
            opt[key] = np.array(value.detach().to("cpu").numpy())
    return {"params": convert.params_to_jax(full("params", state.params)),
            "opt": opt, "model_state": mstate(state.model_state)}


def _same_keys(want: Mapping, have: Mapping, where: str) -> None:
    if set(want) != set(have):
        raise ValueError(f"state keys differ at {where}: checkpoint has "
                         f"{sorted(have)}, the run expects {sorted(want)}")


def _checked(state: TrainState, target: Mapping[str, torch.Tensor],
             tree: Mapping, where: str) -> Dict[str, torch.Tensor]:
    """Checkpoint tree (JAX layout) → ``{name: tensor}`` (whole leaves)
    checked against the target's names, whole shapes and dtypes."""
    flat = convert.params_from_jax(tree,
                                   layout=convert.OPT_LAYOUTS.get(where,
                                                                  "port"))
    _same_keys(target, flat, where)
    layout = state.layout if state.layout is not None \
        and where in state.layout.keys else None
    for name, t in target.items():
        v = flat[name]
        shape = tuple(t.shape) if layout is None \
            else layout.leaves[name].shape
        shape = tp.whole_shape(state, where, name, shape)
        if tuple(v.shape) != shape or v.dtype != t.dtype:
            raise ValueError(
                f"{where}.{name}: checkpoint has {tuple(v.shape)} {v.dtype}, "
                f"the run expects {shape} {t.dtype}")
    return flat


@torch.no_grad()
def load_tree_into(state: TrainState, tree: Mapping[str, Any]) -> TrainState:
    """Copy a checkpoint tree (whole leaves) into ``state``'s tensors, in
    place: into this rank's model slices and shards where the state keeps
    them. Every key, shape and dtype is checked before any tensor is
    written. A ``model_state`` tree's ``None`` leaves (the ResNet's, as
    msgpack keeps them) carry nothing; a ``.sharded`` tree has none."""
    _same_keys({"params": 0, "opt": 0, "model_state": 0}, tree, "state")
    _same_keys(state.opt, tree["opt"], "opt")
    copies = [("params", state.params,
               _checked(state, state.params, tree["params"], "params")),
              ("model_state", state.model_state,
               _checked(state, state.model_state, tree["model_state"],
                        "model_state"))]
    for key, value in state.opt.items():
        if isinstance(value, Mapping):
            copies.append((key, value,
                           _checked(state, value, tree["opt"][key], key)))
    step = np.asarray(tree["opt"]["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"opt.step: expected an int32 scalar, got "
                         f"{step.shape} {step.dtype}")
    layout = state.layout
    for key, dst, src in copies:
        src = tp.local(state, key, src)
        for name, t in dst.items():
            v = src[name]
            if layout is not None and key in layout.keys \
                    and layout.is_split(name):
                v = layout.shard_of(v, name)
            t.copy_(v)
    state.opt["step"].fill_(int(step))
    return state


# --------------------------------------------------------------------------
# integrity sidecars (``ckpt/checkpoint.py:56-130`` of the JAX package)
# --------------------------------------------------------------------------

def checksum_path(path: str) -> str:
    return path + ".sha256"


def _checkpoint_files(path: str) -> List[str]:
    """Relative paths of the files a checkpoint comprises, sorted (one for
    a msgpack file, every file under a ``.sharded`` directory)."""
    if not os.path.isdir(path):
        return [os.path.basename(path)]
    out = []
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for name in files:
            out.append(os.path.relpath(os.path.join(root, name), path))
    return sorted(out)


def _digest_files(path: str, rel_files) -> Tuple[str, int]:
    """(hex sha256, bytes) over ``rel_files`` of ``path``, each file's
    relative name mixed in (the JAX package's digest)."""
    base = path if os.path.isdir(path) else os.path.dirname(path)
    h = hashlib.sha256()
    total = 0
    for rel in rel_files:
        h.update(rel.encode())
        with open(os.path.join(base, rel), "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                h.update(chunk)
                total += len(chunk)
    return h.hexdigest(), total


def write_checksum(path: str) -> str:
    files = _checkpoint_files(path)
    digest, nbytes = _digest_files(path, files)
    sc = checksum_path(path)
    tmp = sc + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"algo": "sha256", "digest": digest, "bytes": nbytes,
                   "files": files}, f)
    os.replace(tmp, sc)
    return sc


def verify_checkpoint(path: str) -> Tuple[bool, str]:
    """(ok, reason). A missing sidecar passes (the decode still guards
    the bytes); a present one must match: every file it lists present,
    with the committed digest."""
    sc = checksum_path(path)
    if not os.path.isfile(sc):
        return True, "no checksum sidecar (pre-integrity checkpoint)"
    try:
        with open(sc) as f:
            want = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"unreadable checksum sidecar: {e!r}"
    base = path if os.path.isdir(path) else os.path.dirname(path)
    rel_files = want.get("files") or [os.path.basename(path)]
    missing = [r for r in rel_files
               if not os.path.isfile(os.path.join(base, r))]
    if missing:
        return False, f"missing checkpoint files {missing}"
    try:
        digest, nbytes = _digest_files(path, rel_files)
    except OSError as e:
        return False, f"unreadable checkpoint file: {e!r}"
    if digest != want.get("digest"):
        return False, (f"checksum mismatch (have {nbytes} bytes, sidecar "
                       f"recorded {want.get('bytes')})")
    return True, "verified"


# --------------------------------------------------------------------------
# save / restore
# --------------------------------------------------------------------------

def _checkpoints(ckpt_dir: str) -> List[Tuple[int, str]]:
    """``[(step, format)]`` of every committed checkpoint, oldest first; a
    ``.sharded`` directory counts once its manifest (the commit point)
    exists."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if not m:
            continue
        if m.group(2) == "sharded" and not os.path.isfile(
                os.path.join(ckpt_dir, name, sharded_lib.MANIFEST)):
            continue  # an uncommitted partial save
        out.append((int(m.group(1)), m.group(2)))
    return sorted(out)


def all_checkpoint_steps(ckpt_dir: str) -> List[int]:
    """Steps of every committed checkpoint, oldest first."""
    return [step for step, _ in _checkpoints(ckpt_dir)]


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    cks = _checkpoints(ckpt_dir)
    return _ckpt_path(ckpt_dir, *cks[-1]) if cks else None


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int,
                    keep: int = 3, fmt: str = "msgpack", mesh=None,
                    shard_io_threads: Optional[int] = None,
                    on_event=None) -> str:
    """Write the checkpoint of ``step`` in ``fmt``. ``msgpack``: atomically
    ``ckpt_<step>.msgpack`` (tmp + rename), then its sidecar and the
    ``checkpoint`` index; prune to the ``keep`` newest. ``sharded``: every
    rank of ``mesh`` calls it and writes its own shards
    (``ckpt/sharded.py``)."""
    if fmt == "sharded":
        path = _ckpt_path(ckpt_dir, step, "sharded")
        sharded_lib.save_sharded(path, state, mesh, shard_io_threads,
                                 on_event)
        if mesh is None or mesh.chief:
            _finalize(ckpt_dir, path, keep)
        if mesh is not None:
            mesh.barrier()     # committed before any rank reads it
        return path
    if fmt != "msgpack":
        raise ValueError(f"unknown checkpoint format {fmt!r}; have "
                         f"{FORMATS}")
    return write_tree(ckpt_dir, state_to_tree(state), step, keep)


def write_tree(ckpt_dir: str, tree: Mapping[str, Any], step: int,
               keep: int = 3) -> str:
    """:func:`save_checkpoint` of a state already copied to host memory
    (:func:`state_to_tree`): numpy only, safe off the main thread."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _ckpt_path(ckpt_dir, step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(to_bytes(tree))
    os.replace(tmp, path)
    _finalize(ckpt_dir, path, keep)
    return path


def _finalize(ckpt_dir: str, path: str, keep: int) -> None:
    """Commit ``path``'s sidecar, point the ``checkpoint`` index at it,
    prune to the ``keep`` newest (their sidecars ride along)."""
    write_checksum(path)
    with open(os.path.join(ckpt_dir, "checkpoint"), "w") as f:
        f.write(os.path.basename(path) + "\n")
    for old_step, old_fmt in _checkpoints(ckpt_dir)[:-keep]:
        old = _ckpt_path(ckpt_dir, old_step, old_fmt)
        try:
            if os.path.isdir(old):
                shutil.rmtree(old)
            else:
                os.remove(old)
            for sidecar in (checksum_path(old),
                            _data_state_path(ckpt_dir, old_step)):
                if os.path.isfile(sidecar):
                    os.remove(sidecar)
        except OSError as e:
            print(f"[ckpt] retention prune of {old} failed: {e!r} — old "
                  "checkpoints are accumulating", file=sys.stderr)


def _data_state_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"data_state_{step}.json")


def save_data_state(ckpt_dir: str, step: int, counts: dict) -> None:
    """Sidecar for exact-resume data order: the cumulative number of
    batches each host stream has CONSUMED by ``step``, written atomically
    next to the checkpoint of that step (the JAX package's file and
    fields, ``ckpt/checkpoint.py:261-285``)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _data_state_path(ckpt_dir, step)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(counts, f)
    os.replace(tmp, path)


def load_data_state(ckpt_dir: str, step: int) -> Optional[dict]:
    """Counts written by :func:`save_data_state`, or None."""
    path = _data_state_path(ckpt_dir, step)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def _restore_one(path: str, target: TrainState,
                 shard_io_threads: Optional[int], on_event) -> TrainState:
    if path.endswith(".sharded"):
        tree = sharded_lib.restore_sharded(
            path, [p for p, *_ in sharded_lib.state_leaves(target)],
            shard_io_threads, on_event)
    else:
        with open(path, "rb") as f:
            tree = from_bytes(f.read())
    return load_tree_into(target, tree)


def restore_checkpoint(ckpt_dir: str, target: TrainState,
                       shard_io_threads: Optional[int] = None,
                       on_event=None, on_fallback=None,
                       deadline_s: float = 0.0) -> TrainState:
    """Restore the newest VERIFIABLE checkpoint, of either format, into
    ``target`` (in place, onto its layout), or return ``target`` unchanged
    when there is none. A candidate that fails its sidecar or its decode
    is skipped with a warning, and ``on_fallback(step, path, reason,
    walk_ms)`` when given (the trainer's ``ckpt_fallback`` record, with
    the milliseconds spent in the walk so far), and the next older one is
    tried; when nothing restores, the newest candidate's error is raised.
    ``deadline_s`` (``--restore_deadline_s``; 0: no limit) budgets the
    walk: past it, no older candidate is tried and a ``ValueError`` (the
    supervisor's ``ckpt_restore`` class) names what was skipped.
    ``shard_io_threads`` and ``on_event`` (its ``shard_io`` records) are
    the sharded codec's."""
    candidates = _checkpoints(ckpt_dir)[::-1]
    first_error: Optional[ValueError] = None
    skipped = []
    walk_t0 = time.perf_counter()
    for step, fmt in candidates:
        if deadline_s and time.perf_counter() - walk_t0 > deadline_s:
            walk_ms = (time.perf_counter() - walk_t0) * 1000.0
            raise ValueError(
                f"checkpoint restore walk in {ckpt_dir} exceeded its "
                f"{deadline_s:.1f}s deadline after {walk_ms:.0f}ms "
                f"({len(skipped)} candidates skipped: "
                f"{'; '.join(skipped)}); nothing restorable in budget")
        path = _ckpt_path(ckpt_dir, step, fmt)
        ok, reason = verify_checkpoint(path)
        if ok:
            try:
                return _restore_one(path, target, shard_io_threads, on_event)
            except (ValueError, OSError, msgpack.UnpackException) as e:
                reason = (f"either it was written with a different config "
                          f"or the file is corrupted: {e}")
                first_error = first_error or ValueError(
                    f"failed to restore checkpoint {path}: {reason}")
        print(f"[ckpt] skipping checkpoint {path}: {reason}; falling back "
              "to an older checkpoint", file=sys.stderr)
        skipped.append(f"{os.path.basename(path)}: {reason}")
        if on_fallback is not None:
            on_fallback(step, path, reason,
                        (time.perf_counter() - walk_t0) * 1000.0)
    if first_error is not None:
        raise first_error
    if candidates:
        raise ValueError(f"no restorable checkpoint in {ckpt_dir}: every "
                         "candidate failed integrity verification")
    return target


class CheckpointManager:
    """Periodic saver (the CheckpointSaverHook role): saves every
    ``every_steps`` global steps, plus forced saves, never twice at the
    same step. Over a mesh only the chief writes a msgpack file; every
    rank returns from a save after the chief has written it (handed it to
    the writer under ``async_save``). Under a sharded layout every rank
    first enters the gather that copies the whole state to the host.
    ``fmt="sharded"`` has every rank write its own shards
    (``ckpt/sharded.py``), ``shard_io_threads`` files at once, each
    reported to ``on_event``; over several ranks such a save stays on the
    main thread (its pre-manifest barrier is a collective), in one process
    it goes to the writer under ``async_save`` like a msgpack one.

    ``every_secs`` adds a wall-clock cadence that the manager does not act
    on by itself: :meth:`time_due` says when it has elapsed since the last
    save on this process's clock, and the caller forces the save (over
    several ranks after they agree). ``async_save`` moves the encoding and
    the file writes to one writer thread (see the module docstring)."""

    def __init__(self, ckpt_dir: str, every_steps: int, keep: int = 3,
                 mesh: Optional[Mesh] = None, async_save: bool = False,
                 every_secs: Optional[float] = None, fmt: str = "msgpack",
                 shard_io_threads: Optional[int] = None, on_event=None):
        if fmt not in FORMATS:
            raise ValueError(f"unknown checkpoint format {fmt!r}; have "
                             f"{FORMATS}")
        self.ckpt_dir = ckpt_dir
        self.every_steps = max(1, every_steps)
        self.keep = keep
        self.mesh = mesh
        self.fmt = fmt
        self.shard_io_threads = shard_io_threads
        self.on_event = on_event
        self._last_saved_step: Optional[int] = None
        self.every_secs = every_secs
        self._last_time = time.monotonic()
        self.async_save = async_save
        self._pool = None
        self._pending = None
        if async_save:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-writer")

    @property
    def chief(self) -> bool:
        return self.mesh is None or self.mesh.chief

    def time_due(self) -> bool:
        """True when the wall-clock cadence has elapsed since the last
        save (this process's clock)."""
        return bool(self.every_secs
                    and time.monotonic() - self._last_time
                    >= self.every_secs)

    def flush(self) -> None:
        """Wait for the write in flight; raise its error if it failed."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        """Drain the writer and stop its thread (idempotent)."""
        try:
            self.flush()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

    def due(self, step: int, force: bool = False) -> bool:
        if not force and step % self.every_steps != 0:
            return False
        return step != self._last_saved_step

    def maybe_save(self, state: TrainState, step: int,
                   force: bool = False,
                   data_state: Optional[dict] = None) -> bool:
        """Save when due; ``data_state`` (the streams' consumed batch
        counts) goes into its sidecar after the checkpoint is committed,
        by the same writer."""
        if not self.due(step, force):
            return False
        self._last_saved_step = step
        several = self.mesh is not None and self.mesh.world > 1
        if self.fmt == "sharded":
            # Every rank's own shards, copied to the host here and now.
            rank = 0 if self.mesh is None else self.mesh.rank
            payload = sharded_lib.collect_local_shards(state, rank)
            meta = sharded_lib.leaves_meta(state)
            if self.async_save and not several:
                self.flush()
                self._pending = self._pool.submit(
                    self._write_sharded, payload, meta, step, data_state)
            else:
                self._write_sharded(payload, meta, step, data_state)
                if several:
                    self.mesh.barrier()   # the chief has committed it
        else:
            # The host copy, here and now: the next dispatch updates the
            # state's tensors in place. A sharded layout or a model split
            # gathers: every rank takes part, the chief writes.
            gather = state.layout is not None or state.split is not None
            tree = state_to_tree(state) if self.chief or gather else None
            if self.chief:
                if self.async_save:
                    self.flush()   # in order, and a failed write surfaces
                    self._pending = self._pool.submit(
                        self._write, tree, step, data_state)
                else:
                    self._write(tree, step, data_state)
            if self.mesh is not None:
                self.mesh.barrier()
        # After the slow part: a save longer than every_secs must not
        # make the next one due at once.
        self._last_time = time.monotonic()
        return True

    def _write(self, tree, step: int, data_state: Optional[dict]) -> str:
        path = write_tree(self.ckpt_dir, tree, step, keep=self.keep)
        if data_state is not None:
            save_data_state(self.ckpt_dir, step, data_state)
        return path

    def _write_sharded(self, payload, meta, step: int,
                       data_state: Optional[dict]) -> str:
        path = _ckpt_path(self.ckpt_dir, step, "sharded")
        sharded_lib.finish_sharded_save(
            path, payload, meta,
            self.mesh if self.mesh is not None and self.mesh.world > 1
            else None, self.shard_io_threads, self.on_event)
        if self.chief:
            _finalize(self.ckpt_dir, path, self.keep)
            if data_state is not None:
                save_data_state(self.ckpt_dir, step, data_state)
        return path
