"""Sharded (per-rank) checkpoints: the save path with no full-state gather.

Port of ``dml_cnn_cifar10_tpu/ckpt/sharded.py``; its files, in
``ckpt_<step>.sharded/``, interchange with the JAX package's both ways:

- **Save**: every rank collects the leaves it owns
  (:func:`collect_local_shards`): its shards of what the state's layout
  (``parallel/zero.py``) splits and its model slices of what tensor
  parallelism splits, or its stage's rows of the blocks a pipeline splits
  (``parallel/tp.py``), each with its index range in
  the whole leaf (both dims under tensor parallelism with fsdp). A piece
  that several ranks hold is written by one of them, the one whose rank
  is 0 on every axis the leaf is not split over (the JAX package's
  ``replica_id == 0``): rank 0 alone writes a leaf kept whole on every
  rank. The payload is split
  over up to ``shard_io_threads`` part files written concurrently
  (``shard_<rank>.msgpack``, or ``shard_<rank>_<j>.msgpack``), each an
  atomic write followed by its ``.sha256`` sidecar, then the rank's
  ``shard_<rank>.files.json``. A barrier, then the chief writes
  ``MANIFEST.json`` (the commit point: global shapes and dtypes, and every
  rank's data files); ``process_count`` is the world size.
- **Restore** (:func:`restore_sharded`) reads the manifest's files
  concurrently, verifies each against its sidecar (a mismatch raises
  ``ValueError``, so the newest→oldest walk of ``ckpt/checkpoint.py``
  falls back), assembles every leaf whole on the host (a coverage mask
  catches holes and overlaps), and returns the state tree that
  ``checkpoint.load_tree_into`` re-shards onto the target's layout, which
  may differ from the writer's (any world size, zero1, fsdp or none, any
  model_axis).

Payloads are msgpack in flax's layout through the port's codec
(``checkpoint.to_bytes``): ``{leaf path: [{"data": array, "index":
[[start, stop], ...]}, ...]}``, paths as JAX flattens its ``TrainState``
(``.params/full1/kernel``, ``.opt/step``), keys sorted as flax writes
them, arrays and index ranges in the JAX layouts (``convert.py``). Every
shard read and write emits a ``shard_io`` event through ``on_event``.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from dml_cnn_cifar10_tpu_torch import convert
from dml_cnn_cifar10_tpu_torch.parallel import tp

MANIFEST = "MANIFEST.json"

#: Default bound of the per-shard save/restore thread pool
#: (``--shard_io_threads``); 1 is fully serial, the same bytes.
DEFAULT_SHARD_IO_THREADS = 4

#: ``on_event("shard_io", **fields)``, called for every shard read/write.
OnEvent = Callable[..., None]

# The TrainState fields, in the order JAX flattens its NamedTuple.
_FIELDS = ("params", "opt", "model_state")


def _emit(on_event: Optional[OnEvent], **fields) -> None:
    if on_event is not None:
        on_event("shard_io", **fields)


def _nest(names) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name in names:
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = name
    return tree


def _sorted_leaves(tree: Mapping[str, Any], prefix: str
                   ) -> List[Tuple[str, Any]]:
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            out.extend(_sorted_leaves(value, f"{prefix}{key}/"))
        else:
            out.append((f"{prefix}{key}", value))
    return out


def state_leaves(state) -> List[Tuple[str, str, Optional[str], Any]]:
    """``(path, entry, name, tensor)`` of every leaf of a port
    ``TrainState`` in JAX's flattening order: ``entry`` is ``"params"``
    or the optimizer-state key or ``"model_state"``, ``name`` the port's
    leaf name (None for the step counter). A list index is a path
    component (``.model_state/stage1/0/bn1/mean``, JAX's key path); the
    ``None`` leaves of a ResNet's ``model_state`` are no leaves."""
    out = [(path, "params", name, state.params[name])
           for path, name in _sorted_leaves(_nest(state.params), ".params/")]
    for key in sorted(state.opt):
        value = state.opt[key]
        if isinstance(value, Mapping):
            out += [(path, key, name, value[name]) for path, name in
                    _sorted_leaves(_nest(value), f".opt/{key}/")]
        else:
            out.append((f".opt/{key}", key, None, value))
    out += [(path, "model_state", name, state.model_state[name])
            for path, name in _sorted_leaves(_nest(state.model_state),
                                             ".model_state/")]
    return out


def _split_leaf(state, entry: str, name: Optional[str]):
    """The layout's leaf record when ``entry``'s leaf ``name`` is kept as
    this rank's shard, else None."""
    layout = state.layout
    if (layout is None or name is None or entry not in layout.keys
            or not layout.is_split(name)):
        return None
    return layout.leaves[name]


def _model_slice(state, entry: str, name: Optional[str]):
    """``(slice, leading axes)`` when ``entry``'s leaf ``name`` holds this
    model rank's slice (or this pipeline stage's rows), else None."""
    split = getattr(state, "split", None)
    if split is None or name is None or not split.is_split(name):
        return None
    return split.slices[name], tp.lead_axes(entry)


def _jax_meta(state, entry: str, name: Optional[str], t) -> Tuple[list, str]:
    """The JAX-layout global shape and dtype name of one leaf."""
    if name is None:
        return list(t.shape), str(t.dtype).replace("torch.", "")
    leaf = _split_leaf(state, entry, name)
    shape = leaf.shape if leaf is not None else tuple(t.shape)
    shape = tp.whole_shape(state, entry, name, shape)
    kind = convert.OPT_LAYOUTS.get(entry, "port")
    if kind == "port":
        shape = convert.jax_shape(name, shape)
    elif kind == "stacked":
        shape = shape[:1] + convert.jax_shape(name, shape[1:])
    return list(shape), str(t.dtype).replace("torch.", "")


def collect_local_shards(state, rank: int) -> Dict[str, list]:
    """Device→host copy of what this rank writes: its data shards and
    model slices of the split leaves, each piece by one of the ranks that
    hold it (rank 0 on every axis it is not split over; rank 0 alone for
    a leaf kept whole). Runs at the save point (the next step updates the
    tensors in place); the writes may run on another thread."""
    owner = state.split if getattr(state, "split", None) is not None \
        else state.layout
    mesh = None if owner is None else owner.mesh
    payload: Dict[str, list] = {}
    for path, entry, name, t in state_leaves(state):
        leaf = _split_leaf(state, entry, name)
        part = _model_slice(state, entry, name)
        if mesh is None:
            writes = leaf is not None or rank == 0
        else:
            writes = ((leaf is not None or mesh.data_rank == 0)
                      and (part is not None or (mesh.model_rank == 0
                                                and mesh.pipe_rank == 0))
                      and mesh.seq_rank == 0)
        if not writes:
            continue
        shape, _ = _jax_meta(state, entry, name, t)
        index = [[0, d] for d in shape]
        if leaf is not None:
            index[leaf.jax_dim] = [state.layout.rank * leaf.s,
                                   (state.layout.rank + 1) * leaf.s]
        if part is not None:
            sl, lead = part
            index[sl.jax_dim + lead] = [sl.start, sl.start + sl.length]
        data = convert.to_jax_array(
            name, t, convert.OPT_LAYOUTS.get(entry, "port")) \
            if name is not None else np.array(t.detach().cpu().numpy())
        payload[path] = [{"data": data, "index": index}]
    return payload


def leaves_meta(state) -> Dict[str, dict]:
    """``{path: {"shape", "dtype"}}`` of every leaf, global (JAX layout)."""
    out = {}
    for path, entry, name, t in state_leaves(state):
        shape, dtype = _jax_meta(state, entry, name, t)
        out[path] = {"shape": shape, "dtype": dtype}
    return out


def _split_payload(payload: Dict[str, list],
                   parts: int) -> List[Dict[str, list]]:
    """Partition the payload's leaf paths into up to ``parts`` groups,
    greedily balanced by bytes (largest first into the lightest bin;
    deterministic)."""
    if parts <= 1 or len(payload) <= 1:
        return [payload]
    parts = min(parts, len(payload))
    sized = sorted(((sum(e["data"].nbytes for e in entries), path)
                    for path, entries in payload.items()), reverse=True)
    bins: List[Dict[str, list]] = [{} for _ in range(parts)]
    loads = [0] * parts
    for nbytes, path in sized:
        i = loads.index(min(loads))
        bins[i][path] = payload[path]
        loads[i] += nbytes
    return [b for b in bins if b]


def shard_checksum_path(fname: str) -> str:
    return fname + ".sha256"


def _write_one_shard(ckpt_path: str, fname: str, part: Dict[str, list],
                     on_event: Optional[OnEvent]) -> None:
    """Serialize and atomically write one data file, then its sha256
    sidecar (committed after the data)."""
    from dml_cnn_cifar10_tpu_torch.ckpt.checkpoint import to_bytes

    t0 = time.perf_counter()
    # flax writes a dict's keys sorted (its tree_map rebuilds the dict).
    data = to_bytes({path: part[path] for path in sorted(part)})
    full = os.path.join(ckpt_path, fname)
    tmp = full + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, full)
    sc = shard_checksum_path(full)
    tmp = sc + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"algo": "sha256",
                   "digest": hashlib.sha256(data).hexdigest(),
                   "bytes": len(data)}, f)
    os.replace(tmp, sc)
    _emit(on_event, op="save", shard=fname, bytes=len(data),
          secs=round(time.perf_counter() - t0, 6), verify=None,
          source="disk")


def write_shard_files(ckpt_path: str, payload: Dict[str, list], rank: int,
                      threads: Optional[int] = None,
                      on_event: Optional[OnEvent] = None) -> List[str]:
    """Write this rank's shard files (up to ``threads`` parts, written
    concurrently), each with its sidecar, then ``shard_<rank>.files.json``
    naming them; a one-part payload is ``shard_<rank>.msgpack``."""
    threads = DEFAULT_SHARD_IO_THREADS if threads is None else max(1, threads)
    os.makedirs(ckpt_path, exist_ok=True)
    parts = _split_payload(payload, threads)
    names = ([f"shard_{rank}.msgpack"] if len(parts) == 1 else
             [f"shard_{rank}_{j}.msgpack" for j in range(len(parts))])
    if len(parts) == 1:
        _write_one_shard(ckpt_path, names[0], parts[0], on_event)
    else:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=threads, thread_name_prefix="shard-io") as pool:
            list(pool.map(lambda np_: _write_one_shard(
                ckpt_path, np_[0], np_[1], on_event), zip(names, parts)))
    index = os.path.join(ckpt_path, f"shard_{rank}.files.json")
    tmp = index + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"files": names}, f)
    os.replace(tmp, index)
    return names


def write_manifest(ckpt_path: str, meta: Dict[str, dict],
                   process_count: int) -> None:
    """The chief's commit marker: global shapes and dtypes, and the exact
    shard-file set, gathered from every rank's ``shard_<p>.files.json``
    (stale files of a crashed save stay inert)."""
    shard_files: List[str] = []
    for p in range(process_count):
        index = os.path.join(ckpt_path, f"shard_{p}.files.json")
        try:
            with open(index) as f:
                shard_files.extend(json.load(f)["files"])
        except (OSError, ValueError, KeyError) as e:
            raise ValueError(
                f"sharded save of {ckpt_path} incomplete: process {p}'s "
                f"shard index {index} is missing/unreadable ({e!r}) — "
                f"unreachable filesystem? (every process must see "
                f"--log_dir)")
    tmp = os.path.join(ckpt_path, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"process_count": process_count,
                   "shard_files": shard_files, "leaves": meta}, f)
    os.replace(tmp, os.path.join(ckpt_path, MANIFEST))


def finish_sharded_save(ckpt_path: str, payload: Dict[str, list],
                        meta: Dict[str, dict], mesh=None,
                        threads: Optional[int] = None,
                        on_event: Optional[OnEvent] = None) -> None:
    """The write phase: this rank's files, a barrier over the ranks (all
    shard files durable), then the chief's manifest. Over several ranks
    it runs on the main thread (the barrier is a collective)."""
    rank = 0 if mesh is None else mesh.rank
    write_shard_files(ckpt_path, payload, rank, threads, on_event)
    if mesh is not None:
        mesh.barrier()
    if rank == 0:
        write_manifest(ckpt_path, meta, 1 if mesh is None else mesh.world)


def save_sharded(ckpt_path: str, state, mesh=None,
                 threads: Optional[int] = None,
                 on_event: Optional[OnEvent] = None) -> None:
    """Collect, write, barrier, manifest: every rank calls it."""
    payload = collect_local_shards(state, 0 if mesh is None else mesh.rank)
    finish_sharded_save(ckpt_path, payload, leaves_meta(state), mesh,
                        threads, on_event)


def _read_one_shard(ckpt_path: str, fname: str,
                    on_event: Optional[OnEvent]) -> Dict[str, Any]:
    """Read, verify against its sidecar (a present one must match digest
    and length; a missing one passes) and unpack one shard file; a
    failure raises ``ValueError``."""
    from dml_cnn_cifar10_tpu_torch.ckpt.checkpoint import from_bytes

    t0 = time.perf_counter()
    with open(os.path.join(ckpt_path, fname), "rb") as f:
        data = f.read()
    verify = None
    sc = shard_checksum_path(os.path.join(ckpt_path, fname))
    if os.path.isfile(sc):
        try:
            with open(sc) as f:
                want = json.load(f)
            verify = (hashlib.sha256(data).hexdigest() == want["digest"]
                      and len(data) == want["bytes"])
        except (OSError, ValueError, KeyError):
            verify = False
        if not verify:
            _emit(on_event, op="restore", shard=fname, bytes=len(data),
                  secs=round(time.perf_counter() - t0, 6), verify=False,
                  source="disk")
            raise ValueError(
                f"shard file {fname} in {ckpt_path} failed sha256 "
                f"integrity verification (corrupt/truncated shard or "
                f"sidecar)")
    part = from_bytes(data)
    _emit(on_event, op="restore", shard=fname, bytes=len(data),
          secs=round(time.perf_counter() - t0, 6), verify=verify,
          source="disk")
    return part


def restore_sharded(ckpt_path: str, paths: List[str],
                    threads: Optional[int] = None,
                    on_event: Optional[OnEvent] = None) -> Dict[str, Any]:
    """The state tree ``{"params", "opt", "model_state"}`` (numpy, JAX
    layouts) of the leaves ``paths`` (:func:`state_leaves`' paths of the
    target), assembled from every shard file the manifest lists, read and
    verified on a pool of ``threads``; bit-identical to a serial read.
    A checkpoint with leaves the target lacks, or missing one it needs,
    raises ``ValueError``."""
    threads = DEFAULT_SHARD_IO_THREADS if threads is None else max(1, threads)
    with open(os.path.join(ckpt_path, MANIFEST)) as f:
        meta = json.load(f)
    files = meta.get("shard_files")
    if files is None:
        files = sorted(f for f in os.listdir(ckpt_path)
                       if f.startswith("shard_") and f.endswith(".msgpack"))
        if len(files) != meta["process_count"]:
            raise ValueError(
                f"sharded checkpoint {ckpt_path} has {len(files)} shard "
                f"files but was written by {meta['process_count']} "
                f"processes — incomplete save or unreachable filesystem")
        print(f"[ckpt] WARNING: sharded checkpoint {ckpt_path} has a "
              f"legacy manifest without `shard_files`; restoring via "
              f"filename glob", file=sys.stderr)
        _emit(on_event, op="legacy_glob", shard=ckpt_path, bytes=None,
              secs=None, verify=None, source="disk")
    missing = [f for f in files
               if not os.path.exists(os.path.join(ckpt_path, f))]
    if missing:
        raise ValueError(
            f"sharded checkpoint {ckpt_path} is missing manifest-listed "
            f"shard files {missing} — incomplete save or unreachable "
            f"filesystem (every process must see --log_dir)")
    if threads > 1 and len(files) > 1:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=threads, thread_name_prefix="shard-io") as pool:
            # map() keeps the manifest's order whatever finishes first.
            parts = list(pool.map(
                lambda fn: _read_one_shard(ckpt_path, fn, on_event), files))
    else:
        parts = [_read_one_shard(ckpt_path, fn, on_event) for fn in files]
    shards: Dict[str, list] = {}
    for part in parts:
        for path, entries in part.items():
            shards.setdefault(path, []).extend(
                entries.values() if isinstance(entries, dict) else entries)
    extra = sorted(set(meta["leaves"]) - set(paths))
    if extra:
        raise ValueError(
            f"sharded checkpoint {ckpt_path} carries leaves the current "
            f"config does not: {extra[:5]}{'...' if len(extra) > 5 else ''}"
            f" — it was written with a different --model/--optimizer/"
            f"--ema_decay/--async_staleness configuration")
    tree: Dict[str, Any] = {field: {} for field in _FIELDS}
    for path in paths:
        info = meta["leaves"].get(path)
        if info is None or path not in shards:
            raise ValueError(
                f"leaf {path!r} missing from sharded checkpoint "
                f"{ckpt_path} (config mismatch with the run that wrote "
                f"it?)")
        full = np.empty(tuple(info["shape"]), dtype=np.dtype(info["dtype"]))
        seen = np.zeros(full.shape, dtype=bool)
        for e in shards[path]:
            idx = tuple(slice(int(a), int(b)) for a, b in
                        np.asarray(e["index"], dtype=np.int64).reshape(-1, 2))
            if seen[idx].any():
                raise ValueError(
                    f"leaf {path!r} has overlapping shard entries at "
                    f"{e['index']} in {ckpt_path}")
            full[idx] = e["data"]
            seen[idx] = True
        if not seen.all():
            raise ValueError(
                f"leaf {path!r} only {int(seen.sum())}/{full.size} "
                f"elements covered by shard files in {ckpt_path}")
        field, *keys = path[1:].split("/")
        node = tree[field]
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = full
    return tree
