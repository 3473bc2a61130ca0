"""Process-group setup for multi-process training.

Counterpart of ``initialize_from_cluster`` in
``distributed_tensorflow_tpu/parallel/distributed.py``: one process per
card, NCCL between cards and gloo on the CPU. Rank and world size come, in
order, from

  * ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, ``LOCAL_RANK``);
  * the reference-style ``--worker_hosts`` (comma-separated ``host:port``;
    the first is the rendezvous, as the JAX package's coordinator) and
    ``--task_index`` (this process's rank);
  * neither — one host and no launcher — a world of one, formed in-process
    through a ``FileStore`` in a temporary directory: no socket is opened.

Rank 0 is the chief (the reference's ``task_index == 0``).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class Cluster:
    rank: int
    world_size: int
    device: torch.device  # this process's card, or the CPU

    @property
    def is_chief(self) -> bool:
        return self.rank == 0


@contextlib.contextmanager
def process_group(device: str | torch.device = "cuda", worker_hosts: str = "localhost:12355",
                  task_index: int = 0):
    """Join (or form) the process group for a run and yield its
    :class:`Cluster`. A group that is already initialised is used as it is;
    one formed here is destroyed on exit, with its store's directory. A
    CUDA run binds this process to card ``LOCAL_RANK`` (else rank modulo
    the visible cards)."""
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    created, store_dir = False, None
    if not dist.is_initialized():
        hosts = [h for h in worker_hosts.split(",") if h]
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        elif len(hosts) > 1:
            if not 0 <= task_index < len(hosts):
                raise ValueError(f"task_index {task_index} outside worker_hosts {hosts}")
            dist.init_process_group(backend, init_method=f"tcp://{hosts[0]}",
                                    world_size=len(hosts), rank=task_index)
        else:
            store_dir = tempfile.mkdtemp(prefix="dtt_pg_")
            store = dist.FileStore(os.path.join(store_dir, "store"), 1)
            dist.init_process_group(backend, store=store, rank=0, world_size=1)
        created = True
    try:
        rank = dist.get_rank()
        if device.type == "cuda" and device.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
            device = torch.device("cuda", local)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        yield Cluster(rank, dist.get_world_size(), device)
    finally:
        if created:
            dist.destroy_process_group()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)
