"""Sequence-parallel (long-context) LM training.

Counterpart of ``distributed_tensorflow_tpu/parallel/sequence_parallel.py``:
the batch is split over the mesh's data groups and the **sequence** over
its seq axis (the model axis under ``sp``, the pipe axis under ``sp_tp``,
``parallel/three_d.py``), and attention runs as a ring over the seq group
(``parallel/ring_attention.py``). Memory per rank scales as S/P. The
cross-shard rules are the JAX step's:

  * each shard embeds its **global** positions (learned embeddings and
    rope alike);
  * the next-token target of a shard's last column is the first token of
    the shard to its right, received by a point-to-point exchange; the
    final global position has none and is masked out of the loss;
  * the loss is the global masked mean over data x seq;
  * gradients: each rank backpropagates its shard's share of that mean
    (the ring's backward carries the other shards' cotangents to its keys
    and values), scaled by the data x seq size, and the gradients are
    averaged over data x seq in one flat all-reduce
    (``data_parallel.mean_over_group``) — the JAX step's ``pmean`` of its
    per-shard gradients — which gives every rank the whole batch's
    gradient; the optimizer's global-norm clip then sees it whole, as the
    JAX ``tx.update`` does.

A world of one runs the ring as one hop, and the step is dp's step.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F

from distributed_tensorflow_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from distributed_tensorflow_tpu_torch.parallel.data_parallel import mean_over_group
from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_tpu_torch.parallel.ring_attention import (
    exchange,
    group_layout,
    ring_attention,
)


def seq_axis_of(mesh: Mesh, seq_axis: str = "model"):
    """(group, size, rank) of the mesh's seq axis, ``"model"`` or ``"pipe"``."""
    if seq_axis == "model":
        return mesh.model_group, mesh.model_size, mesh.model_rank
    if seq_axis == "pipe":
        return mesh.pipe_group, mesh.pipe_size, mesh.pipe_rank
    raise ValueError(f"seq_axis must be 'model' or 'pipe', got {seq_axis!r}")


def data_seq_group(mesh: Mesh, seq_axis: str = "model"):
    """The group of ranks that share this rank's index on the mesh's third
    axis (neither data nor seq): the data x seq group the loss and the
    gradients are averaged over, and its size. Collective: every rank
    calls it in the same order. None for a group of one."""
    seq_size = seq_axis_of(mesh, seq_axis)[1]
    n = mesh.data_size * seq_size
    if n == 1:
        return None, 1
    other = mesh.pipe_size if seq_axis == "model" else mesh.model_size
    if other == 1:
        return dist.group.WORLD, n
    P, M = mesh.pipe_size, mesh.model_size
    coord = (lambda r: (r // M) % P) if seq_axis == "model" else (lambda r: r % M)
    mine = mesh.pipe_rank if seq_axis == "model" else mesh.model_rank
    own = None
    for value in range(other):
        group = dist.new_group([r for r in range(dist.get_world_size()) if coord(r) == value])
        if value == mine:
            own = group
    return own, n


def ring_config(cfg: TransformerConfig, group) -> TransformerConfig:
    """``cfg`` with its attention replaced by a causal ring over ``group``
    (whatever ``cfg.attention`` named, as in the JAX trainer); the window
    carries over and truncates the ring."""
    ring = functools.partial(ring_attention, group=group, causal=True,
                             window=cfg.attention_window)
    return dataclasses.replace(cfg, attention=ring)


def make_sp_model(cfg: TransformerConfig, mesh: Mesh, seed: int = 0,
                  device: torch.device | str = "cuda") -> TransformerLM:
    """The sequence-parallel ``TransformerLM``: the weights of
    ``TransformerLM(cfg, seed)``, attention a ring over the mesh's model
    group (the seq axis under ``sp``)."""
    return TransformerLM(ring_config(cfg, mesh.model_group), seed=seed, device=device)


def shard_lm_batch(tokens, mesh: Mesh, seq_axis: str = "model"):
    """This rank's block of the global (B, S) batch: its data group's rows
    and its seq group's columns."""
    _, size, rank = seq_axis_of(mesh, seq_axis)
    b, s = tokens.shape
    if b % mesh.data_size or s % size:
        raise ValueError(f"batch {tuple(tokens.shape)} does not split over {mesh.data_size} "
                         f"data x {size} seq ranks")
    rows, cols = b // mesh.data_size, s // size
    return tokens[mesh.data_rank * rows:(mesh.data_rank + 1) * rows,
                  rank * cols:(rank + 1) * cols]


def build_lm_train_step(model: torch.nn.Module, opt, mesh: Mesh | None = None,
                        seq_axis: str = "model"):
    """``step(tokens) -> {"loss"}``: one optimizer step of next-token
    cross-entropy on this rank's block ``tokens`` (B_local, S_local) of the
    global batch (:func:`shard_lm_batch`), by the module docstring's rules.
    ``model`` attends by a ring over the seq group (:func:`make_sp_model`,
    or ``three_d.make_sp_tp_model``); ``opt`` is a
    ``train.optimizers.Optimizer``. The loss comes back as a device scalar,
    the global mean, equal on every rank."""
    mesh = Mesh() if mesh is None else mesh
    group, size, rank = seq_axis_of(mesh, seq_axis)
    _, _, ranks = group_layout(group)
    left, right = ranks[(rank - 1) % size], ranks[(rank + 1) % size]
    grad_group, n = data_seq_group(mesh, seq_axis)
    params = list(model.parameters())

    def step(tokens: torch.Tensor) -> dict[str, torch.Tensor]:
        b, s_loc = tokens.shape
        opt.zero_grad()
        positions = rank * s_loc + torch.arange(s_loc, device=tokens.device)
        logits = model(tokens, positions=positions)
        # The right neighbour's first token is the target of our last column.
        first = tokens[:, :1].contiguous()
        incoming = first if size == 1 else exchange(first, left, right, group)
        targets = torch.cat([tokens[:, 1:], incoming], dim=1)
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              targets.reshape(-1).long(), reduction="none").view(b, s_loc)
        if rank == size - 1:
            nll = nll[:, :-1]  # the final global position has no target
        count = b * mesh.data_size * (size * s_loc - 1)
        loss = nll.sum() * (n / count)  # this shard's share of the global mean, times n
        loss.backward()
        loss = loss.detach()
        if n > 1:
            loss = mean_over_group(loss, [p.grad for p in params], grad_group, n)
        opt.step()
        return {"loss": loss}

    return step
