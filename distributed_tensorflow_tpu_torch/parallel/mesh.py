"""The (data, model) split of the process group.

Counterpart of ``make_mesh(model_parallel=...)`` in
``distributed_tensorflow_tpu/parallel/mesh.py``: the world's ranks laid out
as a (world / model_parallel, model_parallel) grid in rank order, as the
JAX mesh reshapes its devices. Rank r sits at data index r // model_parallel
and model index r % model_parallel; its model group is its row (the ranks
that shard one replica of the model) and its data group its column (the
ranks that hold the same shard and average its gradients).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the grid. A group is None when it holds only
    this rank: collectives over it are skipped."""

    data_size: int = 1
    model_size: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: dist.ProcessGroup | None = None
    model_group: dist.ProcessGroup | None = None


def make_mesh(model_parallel: int = 1) -> Mesh:
    """Split the initialised process group into data and model groups.
    Every rank must call this, in the same order as any other group
    creation: ``new_group`` is collective."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} ranks not divisible by model_parallel={model_parallel}")
    data_size = world // model_parallel
    data_rank, model_rank = divmod(rank, model_parallel)
    data_group = model_group = None
    for d in range(data_size):
        ranks = list(range(d * model_parallel, (d + 1) * model_parallel))
        group = dist.new_group(ranks) if model_parallel > 1 else None
        if d == data_rank:
            model_group = group
    for m in range(model_parallel):
        ranks = list(range(m, world, model_parallel))
        group = dist.new_group(ranks) if data_size > 1 else None
        if m == model_rank:
            data_group = group
    return Mesh(data_size, model_parallel, data_rank, model_rank, data_group, model_group)
