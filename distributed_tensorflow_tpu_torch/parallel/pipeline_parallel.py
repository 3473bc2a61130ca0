"""Pipeline parallelism (GPipe microbatching) over the mesh's pipe groups.

Counterpart of ``distributed_tensorflow_tpu/parallel/pipeline_parallel.py``:

  * the transformer's blocks are split into S = ``mesh.pipe_size`` stages of
    L/S consecutive layers; stage s (``mesh.pipe_rank``) holds only its own
    (:class:`PipelineLM`). Embeddings, the final norm and the head are
    replicated on every stage;
  * the local batch is split into M microbatches. Stage 0 embeds them; each
    stage runs its layers on each microbatch in turn and sends the
    activation (compute dtype) to the next stage by point-to-point
    operations, naming peers by global rank. Every send goes forward and
    every receive comes from behind, so the schedule cannot deadlock;
  * the last stage's outputs are broadcast to every stage
    (:class:`_CollectFromLast`), where ln_f, the head and the loss run on
    the whole local batch, so their gradients come out equal on every
    stage and the loss reaches the chief (rank 0, stage 0);
  * the backward walks the microbatches back: the last stage takes the
    gradient of the collected outputs, every stage runs its layers'
    backward per microbatch from the gradient the next stage sent, and
    sends its input's gradient to the previous stage. A received
    activation is a fresh leaf that requires grad, so its ``.grad`` is what
    goes back up the pipe;
  * embedding gradients exist on stage 0 only (the other stages contribute
    exact zeros) and are summed over the pipe group (the JAX ``psum``);
    then every gradient and the loss are averaged over the data group in
    one flat all-reduce (``mean_over_group``).

The block is whatever the stage holds: ``models/transformer.py::Block``
here (packed qkv, so on the card the stages run K1/K2), ``TpBlock`` under
``parallel/three_d.py`` (K3/K4). Under ``cfg.remat`` each layer of a stage
is recomputed on backward. Dropout is not ported (the config has no rate).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from distributed_tensorflow_tpu_torch.models.transformer import (
    Block,
    Dense,
    Embed,
    LayerNorm,
    TransformerConfig,
    TransformerLM,
    apply_block,
    next_token_loss,
)
from distributed_tensorflow_tpu_torch.ops.rope import rope_tables
from distributed_tensorflow_tpu_torch.parallel.data_parallel import mean_over_group
from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_tpu_torch.utils.device import resolve_device

# ---------------------------------------------------------------------------
# Stage layout: flax trees (numpy) and state dicts.
# ---------------------------------------------------------------------------


def _block_names(names) -> list[str]:
    return sorted((k for k in names if k.startswith("block_")), key=lambda k: int(k[6:]))


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_stage_params(lm_params: dict, num_stages: int) -> dict:
    """A plain ``TransformerLM`` flax tree (nested numpy dicts) regrouped
    for the pipeline, as the JAX ``stack_stage_params``: the ``block_i``
    subtrees stacked into leaves (S, L/S, ...) under ``stages``; the
    embeddings, final norm and head as they are."""
    names = _block_names(lm_params)
    if len(names) % num_stages:
        raise ValueError(f"{len(names)} layers not divisible into {num_stages} stages")
    per = len(names) // num_stages
    stack = lambda trees: _tree_map(lambda *xs: np.stack(xs), *trees)  # noqa: E731
    stages = stack([stack([lm_params[names[s * per + i]] for i in range(per)])
                    for s in range(num_stages)])
    return {"stages": stages, **{k: v for k, v in lm_params.items() if k not in names}}


def unstack_stage_params(pp_params: dict) -> dict:
    """The inverse of :func:`stack_stage_params`: the plain tree."""
    stages = pp_params["stages"]
    leaf = stages
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    num_stages, per = leaf.shape[:2]
    out = {k: v for k, v in pp_params.items() if k != "stages"}
    for s in range(num_stages):
        for i in range(per):
            out[f"block_{s * per + i}"] = _tree_map(lambda v: np.asarray(v[s, i]), stages)
    return out


def stage_state_dict(lm_state: dict, stage: int, num_stages: int) -> dict:
    """A whole ``TransformerLM`` (or ``TpTransformerLM``) state dict →
    stage ``stage``'s: its layers ``block_{s·L/S + i}`` renamed
    ``blocks.{i}``, every other tensor as it is."""
    names = _block_names({k.split(".")[0] for k in lm_state})
    if len(names) % num_stages:
        raise ValueError(f"{len(names)} layers not divisible into {num_stages} stages")
    per = len(names) // num_stages
    out = {}
    for name, t in lm_state.items():
        head, _, rest = name.partition(".")
        if not head.startswith("block_"):
            out[name] = t
        elif stage * per <= int(head[6:]) < (stage + 1) * per:
            out[f"blocks.{int(head[6:]) - stage * per}.{rest}"] = t
    return out


def unstage_state_dicts(stage_states: list[dict]) -> dict:
    """The inverse of :func:`stage_state_dict` over every stage's state
    dict, in stage order: the whole model's (replicated tensors from stage
    0)."""
    per = 1 + max(int(k.split(".")[1]) for k in stage_states[0] if k.startswith("blocks."))
    out = {}
    for s, state in enumerate(stage_states):
        for name, t in state.items():
            if name.startswith("blocks."):
                _, i, rest = name.split(".", 2)
                out[f"block_{s * per + int(i)}.{rest}"] = t
            elif s == 0:
                out[name] = t
    return out


# ---------------------------------------------------------------------------
# The stage's model.
# ---------------------------------------------------------------------------


class PipelineLM(nn.Module):
    """One pipeline stage's share of the LM: ``tok_embed`` (and
    ``pos_embed``), ``blocks`` (this stage's L/S layers), ``ln_f`` and
    ``lm_head``. Every rank draws the whole plain model from ``seed`` on the
    CPU, as ``TransformerLM(cfg, seed)`` does, and keeps its stage's layers,
    so the same seed gives the same model at any stage count. With
    ``state`` (a :func:`stage_state_dict`) those tensors are loaded instead
    and nothing is drawn; ``block`` builds a layer with undrawn weights
    (``parallel/three_d.py`` passes tensor-parallel blocks). The model lives
    on the card unless ``device="cpu"`` is asked for."""

    def __init__(self, cfg: TransformerConfig, mesh: Mesh | None = None, seed: int = 0,
                 device: torch.device | str = "cuda", state: dict | None = None,
                 block=None):
        super().__init__()
        device = resolve_device(device)
        mesh = Mesh() if mesh is None else mesh
        if cfg.num_layers % mesh.pipe_size:
            raise ValueError(f"{cfg.num_layers} layers not divisible into {mesh.pipe_size} "
                             "stages")
        self.cfg, self.mesh = cfg, mesh
        if state is None:
            whole = TransformerLM(cfg, seed=seed, device="cpu").state_dict()
            state = stage_state_dict(whole, mesh.pipe_rank, mesh.pipe_size)
        block = block or (lambda: Block(cfg, None))
        dt = cfg.compute_dtype
        # Built on the meta device: the weights come from ``state``.
        with torch.device("meta"):
            self.tok_embed = Embed(cfg.vocab_size, cfg.d_model, dt, None)
            if cfg.position == "learned":
                self.pos_embed = Embed(cfg.max_seq_len, cfg.d_model, dt, None)
            self.blocks = nn.ModuleList(block() for _ in range(cfg.num_layers // mesh.pipe_size))
            self.ln_f = LayerNorm(cfg.d_model, dt)
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.use_bias, dt, None)
        self.load_state_dict(state, assign=True)
        self.to(device)

    def embed_parameters(self) -> list[nn.Parameter]:
        """The parameters that only stage 0 uses (and takes gradients for)."""
        return [m.weight for m in (self.tok_embed, getattr(self, "pos_embed", None))
                if m is not None]

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.tok_embed(tokens)
        if self.cfg.position == "learned":
            x = x + self.pos_embed(torch.arange(tokens.shape[1], device=tokens.device))[None]
        return x

    def rope(self, seq_len: int, device):
        """The rope tables every microbatch uses (each spans the whole
        sequence), or None under learned positions."""
        cfg = self.cfg
        if cfg.position != "rope":
            return None
        return rope_tables(cfg.head_dim, seq_len, cfg.rope_theta, device=device)

    def run_stage(self, x: torch.Tensor, rope) -> torch.Tensor:
        for blk in self.blocks:
            x = apply_block(blk, x, rope, self.cfg.remat)
        return x

    def head(self, h: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.ln_f(h)).float()


# ---------------------------------------------------------------------------
# The schedule.
# ---------------------------------------------------------------------------


class _CollectFromLast(torch.autograd.Function):
    """The last stage's collected outputs on every stage of the pipe group:
    forward a broadcast from the last stage (``src``, a global rank); the
    other stages pass a buffer it fills. Backward hands the cotangent to
    the last stage only, unscaled: the other stages' buffers need no
    gradient. ``torch.distributed.nn.functional.broadcast`` must not stand in
    for it: its backward sums the S stages' identical cotangents onto the
    last stage, multiplying the pipeline's whole backward by S (the pitfall
    of ``tensor_parallel._ReduceFromTp``)."""

    @staticmethod
    def forward(ctx, x, src, group):
        dist.broadcast(x, src, group=group)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def build_pp_lm_train_step(model: PipelineLM, opt, num_microbatches: int = 2):
    """``step(tokens) -> {"loss"}``: one optimizer step of next-token
    cross-entropy on this data rank's rows ``tokens`` (B, S), the GPipe
    schedule of the module docstring over the pipe group of the model's
    mesh. ``opt`` is a ``train.optimizers.Optimizer`` over ``model``'s
    parameters; its global-norm clip, as in the JAX step (``tx.update``
    inside ``shard_map``), sees this rank's stage only. The loss comes back
    as a device scalar, equal on every rank."""
    mesh = model.mesh
    M, S, s = num_microbatches, mesh.pipe_size, mesh.pipe_rank
    prev = mesh.pipe_ranks[s - 1] if s > 0 else None
    nxt = mesh.pipe_ranks[s + 1] if s < S - 1 else None
    last = mesh.pipe_ranks[-1]
    params = list(model.parameters())
    embeds = model.embed_parameters()
    cfg = model.cfg

    def step(tokens: torch.Tensor) -> dict[str, torch.Tensor]:
        b, t = tokens.shape
        if b % M:
            raise ValueError(f"local batch {b} not divisible into {M} microbatches")
        bm, dev = b // M, tokens.device
        act = lambda n: torch.empty((n, t, cfg.d_model), dtype=cfg.compute_dtype,  # noqa: E731
                                    device=dev)
        opt.zero_grad()
        rope = model.rope(t, dev)
        x = model.embed(tokens) if s == 0 else None
        ins, outs = [], []
        for m in range(M):
            if x is not None:
                inp = x[m * bm:(m + 1) * bm].detach()
            else:
                inp = act(bm)
                dist.recv(inp, prev)
            inp.requires_grad_()
            out = model.run_stage(inp, rope)
            if nxt is not None:
                dist.send(out.detach(), nxt)
            ins.append(inp)
            outs.append(out)
        if nxt is None:
            y = torch.cat([o.detach() for o in outs]).requires_grad_()
        else:
            y = act(b)
        h = y if S == 1 else _CollectFromLast.apply(y, last, mesh.pipe_group)
        loss = next_token_loss(model.head(h), tokens)
        loss.backward()
        for m in reversed(range(M)):
            if nxt is None:
                g = y.grad[m * bm:(m + 1) * bm]
            else:
                g = act(bm)
                dist.recv(g, nxt)
            torch.autograd.backward(outs[m], g)
            if prev is not None:
                dist.send(ins[m].grad, prev)
        if x is not None:
            x.backward(torch.cat([inp.grad for inp in ins]))
        loss = loss.detach()
        if mesh.pipe_group is not None:
            for p in embeds:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            flat = torch.cat([p.grad.reshape(-1) for p in embeds])
            dist.all_reduce(flat, group=mesh.pipe_group)
            at = 0
            for p in embeds:
                p.grad.copy_(flat[at:at + p.numel()].view_as(p))
                at += p.numel()
        if mesh.data_group is not None:
            loss = mean_over_group(loss, [p.grad for p in params], mesh.data_group,
                                   mesh.data_size)
        opt.step()
        return {"loss": loss}

    return step
