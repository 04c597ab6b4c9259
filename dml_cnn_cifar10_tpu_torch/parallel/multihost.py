"""Multi-process bootstrap over ``torch.distributed``.

Port of ``dml_cnn_cifar10_tpu/parallel/multihost.py``. The reference's
``tf.train.ClusterSpec`` + ``tf.train.Server`` (``cifar10cnn.py:184-192``)
become one process per GPU joined by ``torch.distributed``: the reference
CLI's comma list of ``host:port`` workers plus a task index maps onto
``init_process_group(init_method="tcp://<first worker>", world_size=<number
of workers>, rank=<task index>)``; the first worker hosts the rendezvous,
as task 0 is the TF chief. Training traffic is collectives (NCCL between
cards, gloo on the CPU), not parameter RPCs.

Hardened as the JAX package's bootstrap is: the host list is validated up
front (a bad ``--task_index`` or a duplicated ``host:port`` would otherwise
surface as a late hang), and a rendezvous that is refused or times out is
retried with bounded exponential backoff under ``coordinator_timeout_s``
per attempt. That timeout also bounds every later collective's wait, so a
rank whose peer died fails instead of hanging.
"""

from __future__ import annotations

import datetime
import time
from typing import List

import torch
import torch.distributed as dist

from dml_cnn_cifar10_tpu_torch.config import ParallelConfig


def validate_hosts(worker_hosts: List[str], task_index: int) -> None:
    """Fail fast with a clear ``ValueError`` on inputs that would
    otherwise hang the rendezvous late: empty/duplicate ``host:port``
    entries, entries without a port, or a ``task_index`` outside
    ``[0, len(worker_hosts))``."""
    if not worker_hosts:
        raise ValueError("worker_hosts is empty: need at least one "
                         "host:port entry")
    seen = set()
    for i, entry in enumerate(worker_hosts):
        entry = entry.strip()
        if not entry:
            raise ValueError(
                f"worker_hosts[{i}] is empty — a trailing/doubled comma "
                f"in --worker_hosts?")
        host, sep, port = entry.rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ValueError(
                f"worker_hosts[{i}] = {entry!r} is not host:port")
        if entry in seen:
            raise ValueError(
                f"worker_hosts[{i}] = {entry!r} is duplicated — two "
                f"processes on one address never form a cluster, they "
                f"hang it")
        seen.add(entry)
    if not 0 <= task_index < len(worker_hosts):
        raise ValueError(
            f"task_index={task_index} out of range for "
            f"{len(worker_hosts)} worker host(s)")


def parallel_from_hosts(worker_hosts: List[str], task_index: int,
                        cfg: ParallelConfig) -> ParallelConfig:
    """README-recipe compat: ``--worker_hosts=a:2222,b:2222
    --task_index=i`` fills ``cfg``'s bootstrap fields (validated)."""
    validate_hosts(worker_hosts, task_index)
    cfg.worker_hosts = tuple(entry.strip() for entry in worker_hosts)
    cfg.coordinator_address = cfg.worker_hosts[0]
    cfg.num_processes = len(worker_hosts)
    cfg.process_id = task_index
    return cfg


def _delay_s(base_s: float, cap_s: float, attempt: int) -> float:
    """Backoff before retry ``attempt`` (1-based): ``base * 2^(a-1)``
    capped at ``cap_s`` — the JAX package's ``utils/backoff.delay_s``."""
    if attempt < 1:
        raise ValueError(f"attempt must be >= 1, got {attempt}")
    return min(base_s * (2 ** (attempt - 1)), cap_s)


def initialize(cfg: ParallelConfig, backend: str,
               device: torch.device) -> None:
    """Idempotent ``init_process_group`` from ``cfg`` on ``backend``, with
    bounded retry + backoff around a slow-to-start rank 0. A no-op for a
    one-process world."""
    if cfg.num_processes <= 1 or dist.is_initialized():
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"dist_backend must be nccl or gloo, got "
                         f"{backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs --device cuda; use gloo "
                         "on the CPU")
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = device
    attempt = 0
    while True:
        try:
            dist.init_process_group(
                backend=backend,
                init_method=f"tcp://{cfg.coordinator_address}",
                world_size=cfg.num_processes, rank=cfg.process_id,
                timeout=datetime.timedelta(
                    seconds=cfg.coordinator_timeout_s), **kw)
            return
        except (RuntimeError, ConnectionError, OSError, TimeoutError) as e:
            attempt += 1
            if attempt > cfg.coordinator_retries:
                raise RuntimeError(
                    f"coordinator {cfg.coordinator_address} unreachable "
                    f"after {attempt} attempt(s) x "
                    f"{cfg.coordinator_timeout_s:.0f}s: {e}") from e
            delay = _delay_s(1.0, 30.0, attempt)
            print(f"[multihost] coordinator {cfg.coordinator_address} "
                  f"not ready (attempt {attempt}/"
                  f"{cfg.coordinator_retries}): {e}; retrying in "
                  f"{delay:.1f}s")
            time.sleep(delay)


def is_chief(cfg: ParallelConfig) -> bool:
    """Process 0 plays the chief role (data generation, checkpoint
    writes)."""
    return cfg.process_id == 0
