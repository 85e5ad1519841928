"""Multi-process bootstrap and the process-aware mesh.

Counterpart of ``desamba_tpu/parallel/distributed.py``, over
``torch.distributed`` (NCCL between cards, gloo between CPU processes) in
place of ``jax.distributed``. The reference is strictly single-host
(pthreads over reads with the index in shared RAM,
src/lib/kthread.c:32-57); the port spans processes as the JAX package
does:

  - ``dp`` (reads) is laid out across processes: the read stream is
    embarrassingly parallel, so the only traffic between them is the
    input split and the ordered gather of the results;
  - ``idx`` (index memory) stays inside one process's devices, so the
    merges of the sharded existence probes (``mesh.bloom_rows``) never
    leave a host.

This module only arranges processes and devices; ``mesh`` and
``classifier`` take any mesh. Nothing on a machine tells a process of its
peers: the coordinator's address, the process count and each process's
rank are given (arguments, or the environment variables the JAX package
reads).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh


@dataclasses.dataclass(frozen=True)
class DeviceRecord:
    """One device of the run: the process that drives it, its index in
    the run, and the device as that process names it."""
    process_index: int
    id: int
    device: str


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> bool:
    """Join the process group at ``coordinator`` ("host:port", as the JAX
    package takes it, or a ``tcp://`` URL), from the arguments or
    ``DESAMBA_COORDINATOR``, ``DESAMBA_NUM_PROCESSES`` and
    ``DESAMBA_PROCESS_ID``. ``backend`` defaults to NCCL where a CUDA
    device is available, else gloo.

    Returns True once a multi-process group is up (also when it already
    was: safe to call twice), False with no coordinator configured."""
    coordinator = coordinator or os.environ.get("DESAMBA_COORDINATOR")
    if coordinator is None:
        return False
    if dist.is_initialized():
        return True
    if num_processes is None:
        num_processes = int(os.environ.get("DESAMBA_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("DESAMBA_PROCESS_ID", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = (coordinator if "://" in coordinator
           else f"tcp://{coordinator}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return True


def local_devices() -> list:
    """This process's devices: every CUDA device, else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def global_devices(devices=None) -> list:
    """Every process's devices as ``DeviceRecord``s, in process order:
    this process's ``devices`` (default ``local_devices()``) all-gathered
    over the process group (only this process's without one)."""
    mine = [str(torch.device(d)) for d in
            (local_devices() if devices is None else devices)]
    if dist.is_initialized():
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
    else:
        every = [mine]
    records, k = [], 0
    for p, names in enumerate(every):
        for name in names:
            records.append(DeviceRecord(p, k, name))
            k += 1
    return records


def host_mesh(n_idx: int | None = None, devices=None) -> Mesh:
    """A (dp, idx) mesh whose ``idx`` axis never crosses a process.

    ``devices`` (default ``global_devices()``) are records with a
    ``process_index``; they are grouped by process, ``idx`` splits the
    devices of one process and ``dp`` runs over the process groups and any
    factor left within a process. With ``n_idx`` omitted, the index axis
    takes all devices of one process: the layout for an index too large
    for one card but not for one host's cards."""
    devices = list(global_devices() if devices is None else devices)
    by_proc: dict[int, list] = {}
    for d in devices:
        by_proc.setdefault(getattr(d, "process_index", 0), []).append(d)
    groups = [by_proc[k] for k in sorted(by_proc)]
    per_host = len(groups[0])
    if any(len(g) != per_host for g in groups):
        raise ValueError("uneven devices per process")
    if n_idx is None:
        n_idx = per_host
    if per_host % n_idx:
        raise ValueError(f"n_idx={n_idx} does not divide {per_host} "
                         "devices per process")
    rows = []
    for g in groups:
        # idx is the fastest-varying factor of a process's devices, so
        # each idx group stays inside one process
        arr = np.empty(per_host, dtype=object)
        arr[:] = g
        rows.append(arr.reshape(per_host // n_idx, n_idx))
    return Mesh(np.concatenate(rows, axis=0))
