"""The (data, pipe, model) split of the process group.

Counterpart of ``make_mesh(model_parallel=...)`` and ``make_mesh3`` in
``distributed_tensorflow_tpu/parallel/mesh.py``: the world's ranks laid out
as a (world / (P·M), P, M) grid in rank order, as the JAX mesh reshapes its
devices. Rank r sits at data index r // (P·M), pipe index (r // M) % P and
model index r % M. Its model group is the ranks that share its (data, pipe)
indices (they shard one stage of one replica), its pipe group the ranks
that share (data, model) (the stages of one replica, in stage order), and
its data group the ranks that share (pipe, model) (they hold the same shard
and average its gradients). ``make_mesh`` is the two-axis case P = 1.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the grid. A group is None when it holds only
    this rank: collectives over it are skipped. ``pipe_ranks`` are the
    global ranks of the pipe group in stage order (point-to-point peers)."""

    data_size: int = 1
    model_size: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: dist.ProcessGroup | None = None
    model_group: dist.ProcessGroup | None = None
    pipe_size: int = 1
    pipe_rank: int = 0
    pipe_group: dist.ProcessGroup | None = None
    pipe_ranks: tuple[int, ...] = (0,)


def make_mesh3(pipeline_parallel: int = 1, model_parallel: int = 1) -> Mesh:
    """Split the initialised process group into data, pipe and model
    groups. Every rank must call this, in the same order as any other group
    creation: ``new_group`` is collective, so every rank creates every group
    (of more than one rank), in the same order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    P, M = pipeline_parallel, model_parallel
    if P < 1 or M < 1 or world % (P * M):
        raise ValueError(f"{world} ranks not divisible by pipeline_parallel*model_parallel="
                         f"{P}*{M}")
    D = world // (P * M)
    coords = lambda r: (r // (P * M), (r // M) % P, r % M)  # noqa: E731
    mine = coords(rank)

    def groups(axis: int):
        """Every group along ``axis`` (0 data, 1 pipe, 2 model), and this
        rank's, as (group or None, its ranks in axis order)."""
        size = (D, P, M)[axis]
        own = None
        for fixed in itertools.product(*(range(n) for i, n in enumerate((D, P, M)) if i != axis)):
            ranks = [r for r in range(world)
                     if tuple(c for i, c in enumerate(coords(r)) if i != axis) == fixed]
            group = dist.new_group(ranks) if size > 1 else None
            if tuple(c for i, c in enumerate(mine) if i != axis) == fixed:
                own = (group, tuple(ranks))
        return own

    model_group, _ = groups(2)
    pipe_group, pipe_ranks = groups(1)
    data_group, _ = groups(0)
    return Mesh(D, M, mine[0], mine[2], data_group, model_group, P, mine[1], pipe_group,
                pipe_ranks)


def make_mesh(model_parallel: int = 1) -> Mesh:
    """The (data, model) split: :func:`make_mesh3` with one stage."""
    return make_mesh3(1, model_parallel)
