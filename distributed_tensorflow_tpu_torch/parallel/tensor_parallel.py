"""Tensor parallelism (Megatron-style) over the mesh's model groups.

Counterpart of ``distributed_tensorflow_tpu/parallel/tensor_parallel.py``.
Attention heads and the MLP hidden dimension are split across the ranks of
a model group (``parallel/rules.py``: column-parallel q/k/v/mlp_in,
row-parallel proj/mlp_out, everything else whole), with the two all-reduces
of each block after the attention output projection and after the MLP
down-projection. GQA shards kv heads with their query groups, so attention
itself needs no communication (num_kv_heads must be a multiple of the model
group's size).

Gradients: the model group needs no gradient collective. Megatron's ``f``
(:class:`_CopyToTp`: identity forward, all-reduce backward) at the input of
every column-parallel branch sums the partial activation gradients there, so
sharded parameters' gradients are their rank's own and whole parameters'
gradients come out equal on every rank of the group. Only the data-parallel
mean crosses the data group, once per step.

:class:`TpTransformerLM` keeps separate q/k/v projections (a fused qkv
weight cannot be split by contiguous rows without interleaving q, k and v),
so its attention is the BHSD ``flash_attention`` (kernels K3/K4), not the
packed-qkv path. Dropout is not ported (the JAX default rate is 0).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch.models.transformer import (
    Dense,
    Embed,
    LayerNorm,
    TransformerConfig,
    next_token_loss,
)
from distributed_tensorflow_tpu_torch.ops import attention as A
from distributed_tensorflow_tpu_torch.ops.rope import apply_rope, rope_tables
from distributed_tensorflow_tpu_torch.parallel.data_parallel import mean_over_group
from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_tpu_torch.parallel.rules import TP_TRAIN_RULES, match_partition_rules
from distributed_tensorflow_tpu_torch.utils.device import resolve_device


class _CopyToTp(torch.autograd.Function):
    """Megatron's ``f``: identity forward, sum over the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTp(torch.autograd.Function):
    """Megatron's ``g``, the conjugate of :class:`_CopyToTp`: sum over the
    model group forward, IDENTITY backward. An autograd-aware all-reduce
    (``torch.distributed.nn.functional.all_reduce``) must not stand in for
    it: its backward is another all-reduce, which multiplies every branch
    gradient by the group's size."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToTp.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromTp.apply(x, group)


class TpBlock(nn.Module):
    """One pre-norm block holding this rank's heads and MLP columns.
    ``gen`` draws the weights (whole-model shapes only); with None they are
    left to be loaded."""

    def __init__(self, cfg: TransformerConfig, mesh: Mesh, gen: torch.Generator | None):
        super().__init__()
        tp = mesh.model_size
        if cfg.num_heads % tp:
            raise ValueError(f"num_heads {cfg.num_heads} not divisible by tp={tp}")
        if cfg.kv_heads % tp:
            raise ValueError(
                f"num_kv_heads {cfg.kv_heads} not divisible by tp={tp}: tensor parallelism "
                "keeps whole query groups per rank, so the kv heads must tile over the "
                "model group"
            )
        self.cfg, self.group = cfg, mesh.model_group
        self.local_heads, self.local_kv = cfg.num_heads // tp, cfg.kv_heads // tp
        d, dt, bias, dh = cfg.d_model, cfg.compute_dtype, cfg.use_bias, cfg.head_dim
        self.ln1 = LayerNorm(d, dt)
        self.q = Dense(d, self.local_heads * dh, bias, dt, gen)
        self.k = Dense(d, self.local_kv * dh, bias, dt, gen)
        self.v = Dense(d, self.local_kv * dh, bias, dt, gen)
        self.proj = Dense(self.local_heads * dh, d, False, dt, gen)
        self.ln2 = LayerNorm(d, dt)
        self.mlp_in = Dense(d, cfg.d_ff // tp, bias, dt, gen)
        self.mlp_out = Dense(cfg.d_ff // tp, d, False, dt, gen)
        # Row-parallel biases are added after the all-reduce, so they are
        # not summed tp times: block-level parameters, held whole.
        if bias:
            self.proj_bias = nn.Parameter(torch.zeros(d))
            self.mlp_out_bias = nn.Parameter(torch.zeros(d))

    def attend(self, q, k, v):
        cfg = self.cfg
        if cfg.attention == "flash":
            return A.flash_attention(q, k, v, causal=True, window=cfg.attention_window)
        return A.dense_attention(q, k, v, causal=True, window=cfg.attention_window)

    def forward(self, x, rope=None):
        cfg = self.cfg
        b, s, _ = x.shape
        dh, dt = cfg.head_dim, cfg.compute_dtype
        h = copy_to_tp(self.ln1(x), self.group)
        q = self.q(h).reshape(b, s, self.local_heads, dh)
        k = self.k(h).reshape(b, s, self.local_kv, dh)
        v = self.v(h).reshape(b, s, self.local_kv, dh)
        if rope is not None:
            q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        group = self.local_heads // self.local_kv
        if group > 1:  # each rank's query groups read their own kv heads
            k = k.repeat_interleave(group, dim=2)
            v = v.repeat_interleave(group, dim=2)
        # Head-transposed views: the flash kernels read them in place and
        # write the output in the same (B, S, H, D) memory order, so the
        # reshape back is a view too.
        attn = self.attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        attn = attn.transpose(1, 2).reshape(b, s, self.local_heads * dh)
        attn = reduce_from_tp(self.proj(attn), self.group)
        if cfg.use_bias:
            attn = attn + self.proj_bias.to(dt)
        x = x + attn
        h = copy_to_tp(self.ln2(x), self.group)
        h = F.gelu(self.mlp_in(h), approximate="tanh")
        h = reduce_from_tp(self.mlp_out(h), self.group)
        if cfg.use_bias:
            h = h + self.mlp_out_bias.to(dt)
        return x + h


class TpTransformerLM(nn.Module):
    """Tensor-parallel decoder LM: ``model(tokens) -> logits`` (B, S,
    vocab) f32. ``mesh`` None is a model group of one (the plain model with
    separate q/k/v projections). Every rank draws the whole model from
    ``seed`` (:func:`init_tp_params`) and keeps its slices, so the same seed
    gives the same model at any split. The model lives on the card unless
    ``device="cpu"`` is asked for."""

    def __init__(self, cfg: TransformerConfig, mesh: Mesh | None = None, seed: int = 0,
                 device: torch.device | str = "cuda"):
        super().__init__()
        device = resolve_device(device)
        mesh = Mesh() if mesh is None else mesh
        self.cfg = cfg
        whole = mesh.model_size == 1
        gen = torch.Generator().manual_seed(seed) if whole else None
        dt = cfg.compute_dtype
        self.tok_embed = Embed(cfg.vocab_size, cfg.d_model, dt, gen)
        if cfg.position == "learned":
            self.pos_embed = Embed(cfg.max_seq_len, cfg.d_model, dt, gen)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", TpBlock(cfg, mesh, gen))
        self.ln_f = LayerNorm(cfg.d_model, dt)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.use_bias, dt, gen)
        if not whole:
            self.load_state_dict(shard_params(init_tp_params(cfg, seed), mesh))
        self.to(device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        s = tokens.shape[1]
        x = self.tok_embed(tokens)
        rope = None
        if cfg.position == "rope":
            rope = rope_tables(cfg.head_dim, s, cfg.rope_theta, device=tokens.device)
        else:
            x = x + self.pos_embed(torch.arange(s, device=tokens.device))[None]
        for i in range(cfg.num_layers):
            x = getattr(self, f"block_{i}")(x, rope)
        return self.lm_head(self.ln_f(x)).float()


# ---------------------------------------------------------------------------
# Parameter splits.
# ---------------------------------------------------------------------------


def tp_param_specs(state: dict[str, torch.Tensor]) -> dict[str, int | None]:
    """``{name: dim a model rank slices, or None}`` for a ``TpTransformerLM``
    state dict, from ``parallel/rules.py::TP_TRAIN_RULES``."""
    return match_partition_rules(TP_TRAIN_RULES, {n: t.shape for n, t in state.items()})


def init_tp_params(cfg: TransformerConfig, seed: int = 0) -> dict[str, torch.Tensor]:
    """The whole (unsplit) ``TpTransformerLM`` state dict drawn from
    ``seed`` on the CPU — the same on every rank."""
    return TpTransformerLM(cfg, None, seed=seed, device="cpu").state_dict()


def shard_params(state: dict[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """This rank's slices of a whole state dict (``load_state_dict`` them
    into a ``TpTransformerLM`` built on ``mesh``)."""
    specs, tp, r = tp_param_specs(state), mesh.model_size, mesh.model_rank
    out = {}
    for name, t in state.items():
        dim = specs[name]
        if dim is None or tp == 1:
            out[name] = t
            continue
        if t.shape[dim] % tp:
            raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does not split {tp} ways")
        n = t.shape[dim] // tp
        out[name] = t.narrow(dim, r * n, n).contiguous()
    return out


def gather_params(state: dict[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params`: every rank of the model group
    gets the whole state dict back (a collective over the group)."""
    if mesh.model_group is None:
        return dict(state)
    specs = tp_param_specs(state)
    out = {}
    for name, t in state.items():
        dim = specs[name]
        if dim is None:
            out[name] = t
            continue
        parts = [torch.empty_like(t) for _ in range(mesh.model_size)]
        dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
        out[name] = torch.cat(parts, dim=dim)
    return out


# ---------------------------------------------------------------------------
# Train step: the data-parallel mean over the data group.
# ---------------------------------------------------------------------------


def build_tp_lm_train_step(model: TpTransformerLM, opt, mesh: Mesh | None = None):
    """``step(tokens) -> {"loss"}``: one optimizer step of next-token
    cross-entropy on this data rank's slice ``tokens`` of the global batch.
    Gradients (and the reported loss) are averaged over the data group in
    one all-reduce; the model group needs none. ``opt`` is a
    ``train.optimizers.Optimizer``; its global-norm clip, as in the JAX
    step (``tx.update`` inside ``shard_map``), sees this rank's shards
    only."""
    mesh = Mesh() if mesh is None else mesh
    params = list(model.parameters())

    def step(tokens: torch.Tensor) -> dict[str, torch.Tensor]:
        opt.zero_grad()
        loss = next_token_loss(model(tokens), tokens)
        loss.backward()
        loss = loss.detach()
        if mesh.data_group is not None:
            loss = mean_over_group(loss, [p.grad for p in params], mesh.data_group,
                                   mesh.data_size)
        opt.step()
        return {"loss": loss}

    return step
