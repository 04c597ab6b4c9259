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
orbax and sharded formats are not ported.

In a multi-rank run the parameters are replicated, so one file holds the
whole state: only the chief writes it, and every rank waits at a barrier
until it is committed; every rank restores from the same file, and a
checkpoint written under sequence or data parallelism restores into a
one-process run.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import sys
from typing import Any, Dict, Mapping, Optional, Tuple

import msgpack
import numpy as np
import torch

from dml_cnn_cifar10_tpu_torch import convert
from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh
from dml_cnn_cifar10_tpu_torch.parallel.step import TrainState

_CKPT_RE = re.compile(r"ckpt_(\d+)\.msgpack$")

# flax.serialization's msgpack extension codes.
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_MAX_ARRAY_BYTES = 2 ** 30  # flax splits larger arrays into chunks


def _ckpt_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step}.msgpack")


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
    layouts), field order params/opt/model_state, dict keys sorted."""
    opt = {}
    for key in sorted(state.opt):
        value = state.opt[key]
        opt[key] = convert.params_to_jax(
            value, convert.OPT_LAYOUTS.get(key, "port")) \
            if isinstance(value, Mapping) else value.detach().to("cpu").numpy()
    return {"params": convert.params_to_jax(state.params), "opt": opt,
            "model_state": {}}


def _same_keys(want: Mapping, have: Mapping, where: str) -> None:
    if set(want) != set(have):
        raise ValueError(f"state keys differ at {where}: checkpoint has "
                         f"{sorted(have)}, the run expects {sorted(want)}")


def _checked(target: Mapping[str, torch.Tensor], tree: Mapping, where: str
             ) -> Dict[str, torch.Tensor]:
    """Checkpoint tree (JAX layout) → ``{name: tensor}`` checked against
    the target's names, shapes and dtypes."""
    flat = convert.params_from_jax(tree,
                                   layout=convert.OPT_LAYOUTS.get(where,
                                                                  "port"))
    _same_keys(target, flat, where)
    for name, t in target.items():
        v = flat[name]
        if v.shape != t.shape or v.dtype != t.dtype:
            raise ValueError(
                f"{where}.{name}: checkpoint has {tuple(v.shape)} {v.dtype}, "
                f"the run expects {tuple(t.shape)} {t.dtype}")
    return flat


@torch.no_grad()
def load_tree_into(state: TrainState, tree: Mapping[str, Any]) -> TrainState:
    """Copy a checkpoint tree into ``state``'s tensors, in place. Every
    key, shape and dtype is checked before any tensor is written."""
    _same_keys({"params": 0, "opt": 0, "model_state": 0}, tree, "state")
    _same_keys(state.opt, tree["opt"], "opt")
    copies = [(state.params, _checked(state.params, tree["params"],
                                      "params"))]
    for key, value in state.opt.items():
        if isinstance(value, Mapping):
            copies.append((value, _checked(value, tree["opt"][key], key)))
    step = np.asarray(tree["opt"]["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"opt.step: expected an int32 scalar, got "
                         f"{step.shape} {step.dtype}")
    for dst, src in copies:
        for name, t in dst.items():
            t.copy_(src[name])
    state.opt["step"].fill_(int(step))
    return state


# --------------------------------------------------------------------------
# integrity sidecars (``ckpt/checkpoint.py:56-130`` of the JAX package)
# --------------------------------------------------------------------------

def checksum_path(path: str) -> str:
    return path + ".sha256"


def _digest(path: str) -> Tuple[str, int]:
    """(hex sha256, bytes) over the file's name and bytes — the JAX
    package's digest of a one-file checkpoint."""
    h = hashlib.sha256()
    h.update(os.path.basename(path).encode())
    total = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
            total += len(chunk)
    return h.hexdigest(), total


def write_checksum(path: str) -> str:
    digest, nbytes = _digest(path)
    sc = checksum_path(path)
    tmp = sc + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"algo": "sha256", "digest": digest, "bytes": nbytes,
                   "files": [os.path.basename(path)]}, f)
    os.replace(tmp, sc)
    return sc


def verify_checkpoint(path: str) -> Tuple[bool, str]:
    """(ok, reason). A missing sidecar passes (the decode still guards
    the bytes); a present one must match."""
    sc = checksum_path(path)
    if not os.path.isfile(sc):
        return True, "no checksum sidecar (pre-integrity checkpoint)"
    try:
        with open(sc) as f:
            want = json.load(f)
        digest, nbytes = _digest(path)
    except (OSError, ValueError) as e:
        return False, f"unreadable checkpoint or sidecar: {e!r}"
    if digest != want.get("digest"):
        return False, (f"checksum mismatch (have {nbytes} bytes, sidecar "
                       f"recorded {want.get('bytes')})")
    return True, "verified"


# --------------------------------------------------------------------------
# save / restore
# --------------------------------------------------------------------------

def _checkpoints(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT_RE.match,
                                               os.listdir(ckpt_dir)) if m)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    steps = _checkpoints(ckpt_dir)
    return _ckpt_path(ckpt_dir, steps[-1]) if steps else None


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int,
                    keep: int = 3) -> str:
    """Atomically write ``ckpt_<step>.msgpack`` (tmp + rename), then its
    sidecar and the ``checkpoint`` index; prune to the ``keep`` newest."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _ckpt_path(ckpt_dir, step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(to_bytes(state_to_tree(state)))
    os.replace(tmp, path)
    write_checksum(path)
    with open(os.path.join(ckpt_dir, "checkpoint"), "w") as f:
        f.write(os.path.basename(path) + "\n")
    for old_step in _checkpoints(ckpt_dir)[:-keep]:
        old = _ckpt_path(ckpt_dir, old_step)
        try:
            os.remove(old)
            for sidecar in (checksum_path(old),
                            _data_state_path(ckpt_dir, old_step)):
                if os.path.isfile(sidecar):
                    os.remove(sidecar)
        except OSError as e:
            print(f"[ckpt] retention prune of {old} failed: {e!r} — old "
                  "checkpoints are accumulating", file=sys.stderr)
    return path


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


def restore_checkpoint(ckpt_dir: str, target: TrainState) -> TrainState:
    """Restore the newest VERIFIABLE checkpoint into ``target`` (in
    place), or return ``target`` unchanged when there is none. A
    candidate that fails its sidecar or its decode is skipped with a
    warning and the next older one is tried; when nothing restores, the
    newest candidate's error is raised."""
    candidates = _checkpoints(ckpt_dir)[::-1]
    first_error: Optional[ValueError] = None
    for step in candidates:
        path = _ckpt_path(ckpt_dir, step)
        ok, reason = verify_checkpoint(path)
        if ok:
            try:
                with open(path, "rb") as f:
                    tree = from_bytes(f.read())
                return load_tree_into(target, tree)
            except (ValueError, msgpack.UnpackException) as e:
                reason = (f"either it was written with a different config "
                          f"or the file is corrupted: {e}")
                first_error = first_error or ValueError(
                    f"failed to restore checkpoint {path}: {reason}")
        print(f"[ckpt] skipping checkpoint {path}: {reason}; falling back "
              "to an older checkpoint", file=sys.stderr)
    if first_error is not None:
        raise first_error
    if candidates:
        raise ValueError(f"no restorable checkpoint in {ckpt_dir}: every "
                         "candidate failed integrity verification")
    return target


class CheckpointManager:
    """Periodic saver (the CheckpointSaverHook role): saves every
    ``every_steps`` global steps, plus forced saves, never twice at the
    same step. Over a mesh only the chief writes; every rank returns from
    a save after the file is committed."""

    def __init__(self, ckpt_dir: str, every_steps: int, keep: int = 3,
                 mesh: Optional[Mesh] = None):
        self.ckpt_dir = ckpt_dir
        self.every_steps = max(1, every_steps)
        self.keep = keep
        self.mesh = mesh
        self._last_saved_step: Optional[int] = None

    def due(self, step: int, force: bool = False) -> bool:
        if not force and step % self.every_steps != 0:
            return False
        return step != self._last_saved_step

    def maybe_save(self, state: TrainState, step: int,
                   force: bool = False,
                   data_state: Optional[dict] = None) -> bool:
        """Save when due; ``data_state`` (the streams' consumed batch
        counts) goes into its sidecar after the checkpoint is committed."""
        if not self.due(step, force):
            return False
        if self.mesh is None or self.mesh.chief:
            save_checkpoint(self.ckpt_dir, state, step, keep=self.keep)
            if data_state is not None:
                save_data_state(self.ckpt_dir, step, data_state)
        if self.mesh is not None:
            self.mesh.barrier()
        self._last_saved_step = step
        return True
