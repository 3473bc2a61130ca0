"""3D parallelism: data x pipe x model over the mesh's three groups.

Counterpart of ``build_3d_lm_train_step`` in
``distributed_tensorflow_tpu/parallel/three_d.py``: the GPipe schedule of
``parallel/pipeline_parallel.py`` over the pipe groups, each stage's layers
the Megatron ``TpBlock``s of ``parallel/tensor_parallel.py`` over the model
groups, and the batch split over the data groups (``parallel/mesh.py::
make_mesh3``). The schedule is block-agnostic, and ``TpBlock`` owns its
model-group collectives (the f/g pairs), so the composition needs no
collective of its own. Gradient sync, as in JAX: stage layers are averaged
over the data group; embeddings, live only through stage 0, are summed
over the pipe group, then averaged over data; ln_f and the head come out
equal over pipe and model and are averaged over data. The stages attend
through the BHSD ``flash_attention`` (K3/K4 on the card).

The second composite, ``sp_tp`` (the JAX ``build_sp_tp_lm_train_step``):
data x seq x tensor parallelism, the sequence split over the pipe axis
with ring attention streaming k/v shards round the pipe group, heads and
the MLP over the model axis (``TpTransformerLM``), the batch over data.
The ring runs on each rank's local heads and the two axes' collectives
never touch the same dimension, so the step is sequence parallelism's
(``parallel/sequence_parallel.py``: targets, loss and gradient mean over
data x pipe) around a tensor-parallel model, whose f/g pairs need no
gradient collective of their own.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.models.transformer import TransformerConfig
from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_tpu_torch.parallel.pipeline_parallel import (
    PipelineLM,
    build_pp_lm_train_step,
    stage_state_dict,
)
from distributed_tensorflow_tpu_torch.parallel.sequence_parallel import (
    build_lm_train_step,
    ring_config,
)
from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
    TpBlock,
    TpTransformerLM,
    init_tp_params,
    shard_params,
    tp_param_specs,
)


def init_3d_params(cfg: TransformerConfig, stage: int, num_stages: int,
                   seed: int = 0) -> dict[str, torch.Tensor]:
    """Stage ``stage``'s whole-width state dict: ``init_tp_params(cfg,
    seed)`` regrouped into stages (the JAX ``init_3d_params`` tree's leaves
    at index ``stage``), so a 3d run starts from the tp run's weights."""
    return stage_state_dict(init_tp_params(cfg, seed), stage, num_stages)


def three_d_param_specs(state: dict[str, torch.Tensor]) -> dict[str, int | None]:
    """``{name: dim a model rank slices, or None}`` for a stage's state
    dict: the tensor-parallel rules on each layer (the pipe axis is the
    stage a rank holds)."""
    return tp_param_specs(state)


class ThreeDLM(PipelineLM):
    """This rank's stage of the model, its layers split over the model
    group: :func:`init_3d_params` for ``mesh.pipe_rank`` sliced by
    :func:`three_d_param_specs` for ``mesh.model_rank``, or ``state`` (this
    rank's slices, e.g. ``models/convert.py::three_d_params_from_jax``)."""

    def __init__(self, cfg: TransformerConfig, mesh: Mesh | None = None, seed: int = 0,
                 device: torch.device | str = "cuda", state: dict | None = None):
        mesh = Mesh() if mesh is None else mesh
        if state is None:
            state = shard_params(init_3d_params(cfg, mesh.pipe_rank, mesh.pipe_size, seed),
                                 mesh)
        super().__init__(cfg, mesh, device=device, state=state,
                         block=lambda: TpBlock(cfg, mesh, None))


def build_3d_lm_train_step(model: ThreeDLM, opt, num_microbatches: int = 2):
    """``step(tokens) -> {"loss"}`` on this data rank's rows: the pipeline
    step (``build_pp_lm_train_step``) over a stage of ``TpBlock``s."""
    if not all(isinstance(b, TpBlock) for b in model.blocks):
        raise TypeError("build_3d_lm_train_step needs a stage of TpBlocks (ThreeDLM)")
    return build_pp_lm_train_step(model, opt, num_microbatches)


def make_sp_tp_model(cfg: TransformerConfig, mesh: Mesh, seed: int = 0,
                     device: torch.device | str = "cuda") -> TpTransformerLM:
    """The ``sp_tp`` model: ``TpTransformerLM(cfg, mesh, seed)`` (tp's
    weights and splits) attending by a causal ring over the pipe group."""
    return TpTransformerLM(ring_config(cfg, mesh.pipe_group), mesh, seed=seed, device=device)


def build_sp_tp_lm_train_step(model: TpTransformerLM, opt, mesh: Mesh):
    """``step(tokens) -> {"loss"}`` on this rank's block of the global
    batch (``sequence_parallel.shard_lm_batch(tokens, mesh, "pipe")``):
    sequence parallelism's step over the pipe axis."""
    return build_lm_train_step(model, opt, mesh, seq_axis="pipe")
