"""Decoder-only transformer LM.

Counterpart of ``distributed_tensorflow_tpu/models/transformer.py``:
pre-norm blocks, tanh-GELU MLP, learned or rotary positions, GQA,
sliding-window causal attention, and the attention implementation chosen by
name — ``dense`` (the O(S²) reference), ``blockwise`` (the online softmax
over key blocks) or ``flash`` (the packed-qkv kernels of
``ops/attention.py``) — or given as a callable ``attend(q, k, v)`` on
(B, H, S, dh) operands, rotated and with the kv heads expanded (the ring of
``parallel/ring_attention.py``), on the uncached (training) path. The
training forward takes ``positions=`` (the global positions of a sequence
shard: learned embeddings and rope rotate at them). Under
``remat`` that path recomputes each block on backward
(``torch.utils.checkpoint``) instead of keeping its activations.

With a KV cache (``model(tokens, cache=...)``) the model runs the JAX
model's cached branch instead, which reaches no flash kernel: the new keys
and values are written at absolute positions ``len + arange(s)`` first, then
the queries attend the whole cache by two f32 matmuls under an explicit
causal (and window) mask. The cache holds the unexpanded kv heads, rope
rotates q and k at their absolute positions, and positions at or above a
row's ``len + s`` (a freed slot's stale keys, a padded tail) stay masked.
Under ``kv_cache_dtype="int8"`` keys and values are quantized on write
(``quantize_kv_rows``: int8 rows, one f32 scale a row) and the row scales
go onto the score and weight matrices; the cache is never dequantized.
``positions=`` gives the embeddings and rotations other positions than the
write offsets (the drafter reads absolute positions out of a fresh cache;
tree verify reads tree depth), and ``self_mask`` (S, S) turns the fed block
into a draft tree: each query reads the committed prefix and exactly the
in-block keys its row marks.

``weight_dtype="int8"|"int4"`` swaps the four per-block matmul projections
for ``models/quant.py::QuantDense`` (``matmul_dense``), as the JAX model
does; such a model is loaded from a quantized tree, not trained.

Numerics follow the flax modules the JAX model is built from: parameters are
f32 and every matmul casts its input and weight to ``compute_dtype``;
LayerNorm epsilon is flax's 1e-6; GELU is the tanh approximation; logits are
returned in f32. Parameter names match the flax tree (``tok_embed``,
``pos_embed``, ``block_i/{ln1, qkv, proj, ln2, mlp_in, mlp_out}``, ``ln_f``,
``lm_head``) so ``models/convert.py`` maps one onto the other by name.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_tensorflow_tpu_torch.models.quant import QuantDense, validate_weight_quant
from distributed_tensorflow_tpu_torch.ops import attention as A
from distributed_tensorflow_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from distributed_tensorflow_tpu_torch.utils.device import resolve_device

LN_EPS = 1e-6  # flax.linen.LayerNorm's default (torch's is 1e-5)
ATTENTION = ("dense", "blockwise", "flash")
_NOT_PORTED = "is not ported yet"


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 128
    num_heads: int = 4
    num_layers: int = 2
    d_ff: int = 512
    max_seq_len: int = 2048
    attention: str | Callable = "dense"  # 'dense' | 'blockwise' | 'flash' | attend(q, k, v)
    compute_dtype: torch.dtype = torch.float32
    use_bias: bool = True
    num_kv_heads: int | None = None  # None = multi-head
    attention_window: int | None = None  # None = full causal
    position: str = "learned"  # 'learned' | 'rope'
    rope_theta: float = 10000.0
    kv_cache_dtype: str | None = None  # None = compute dtype | 'int8'
    remat: bool = False  # recompute each block on backward (uncached path)
    weight_dtype: str | None = None  # None | 'int8' | 'int4' (serving; models/quant.py)
    quant_group_size: int = 0  # int4 only; 0 elsewhere

    def __post_init__(self):
        if self.position not in ("learned", "rope"):
            raise ValueError(f"position must be 'learned' or 'rope', got {self.position!r}")
        if self.kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype must be None or 'int8', got {self.kv_cache_dtype!r}")
        if self.weight_dtype is not None or self.quant_group_size:
            validate_weight_quant(self.weight_dtype, self.quant_group_size, self.d_model, self.d_ff)
        if not callable(self.attention) and self.attention not in ATTENTION:
            raise ValueError(f"attention must be one of {ATTENTION}, got {self.attention!r}")
        kv = self.kv_heads
        if not 1 <= kv <= self.num_heads or self.num_heads % kv:
            raise ValueError(
                f"num_kv_heads must be in [1, num_heads] and divide it: "
                f"num_heads {self.num_heads}, num_kv_heads {kv}"
            )
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by num_heads {self.num_heads}")

    @property
    def kv_heads(self) -> int:
        return self.num_heads if self.num_kv_heads is None else self.num_kv_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default Dense kernel init: a normal truncated at ±2σ, scaled
    so that the truncated distribution has variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class Dense(nn.Linear):
    """``flax.linen.Dense(dtype=compute_dtype)``: input, weight and bias cast
    to the compute dtype; lecun-normal weight, zero bias, drawn from ``gen``
    (None: left to be loaded)."""

    def __init__(self, in_features, out_features, bias, compute_dtype, gen):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype
        if gen is not None:
            _lecun_normal_(self.weight, in_features, gen)
            if self.bias is not None:
                nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.LayerNorm):
    """``flax.linen.LayerNorm(dtype=compute_dtype)``: epsilon 1e-6,
    statistics in f32, output in the compute dtype."""

    def __init__(self, d, compute_dtype):
        super().__init__(d, eps=LN_EPS)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        # .float(): a quantized tree may hold the affine parameters in bf16.
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(),
                         self.eps)
        return y.to(self.compute_dtype)


class Embed(nn.Embedding):
    """``flax.linen.Embed(dtype=compute_dtype)``: table in the compute dtype,
    flax's default init (normal, variance 1/num_embeddings) drawn from
    ``gen`` (None: left to be loaded)."""

    def __init__(self, num, d, compute_dtype, gen):
        super().__init__(num, d)
        self.compute_dtype = compute_dtype
        if gen is not None:
            with torch.no_grad():
                self.weight.normal_(0.0, 1.0 / math.sqrt(num), generator=gen)

    def forward(self, ids):
        return F.embedding(ids, self.weight.to(self.compute_dtype))


def quantize_kv_rows(x: torch.Tensor):
    """Symmetric absmax int8 over the last (head_dim) axis: ``x`` (..., dh)
    → (int8 (..., dh), f32 scales (...)). One scale a cached row, so it
    factors out of any dot product over dh."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def matmul_dense(cfg: TransformerConfig, in_features: int, out_features: int, gen):
    """The four per-block matmul projections (``qkv``/``proj``/``mlp_in``/
    ``mlp_out``): ``QuantDense`` under ``cfg.weight_dtype``, else ``Dense``.
    Embeddings, norms and ``lm_head`` never quantize."""
    if cfg.weight_dtype:
        return QuantDense(in_features, out_features, cfg.weight_dtype, cfg.quant_group_size,
                          cfg.use_bias, cfg.compute_dtype)
    return Dense(in_features, out_features, cfg.use_bias, cfg.compute_dtype, gen)


class Block(nn.Module):
    """Pre-norm attention sublayer + pre-norm GELU MLP, both residual."""

    def __init__(self, cfg: TransformerConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.compute_dtype
        self.ln1 = LayerNorm(d, dt)
        self.qkv = matmul_dense(cfg, d, d + 2 * cfg.kv_heads * cfg.head_dim, gen)
        self.proj = matmul_dense(cfg, d, d, gen)
        self.ln2 = LayerNorm(d, dt)
        self.mlp_in = matmul_dense(cfg, d, cfg.d_ff, gen)
        self.mlp_out = matmul_dense(cfg, cfg.d_ff, d, gen)

    def attention(self, x, rope):
        """``attention_sublayer`` of the JAX model, uncached: ``rope`` is the
        (cos, sin) f32 table pair (1, S, dh/2) or None."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, kv, dh = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        qkv = self.qkv(self.ln1(x))
        if cfg.attention == "flash":
            # The packed kernels take the projection as it is; rope tables
            # round to bf16 under bf16 compute, as the JAX model hands them
            # to its kernels, and rotate inside the kernels.
            cos = sin = None
            if rope is not None:
                tdt = cfg.compute_dtype if cfg.compute_dtype == torch.bfloat16 else torch.float32
                cos, sin = rope[0].to(tdt), rope[1].to(tdt)
            attn = A.flash_attention_qkv(
                qkv, h, kv, causal=True, window=cfg.attention_window,
                rope_cos=cos, rope_sin=sin,
            )
        else:
            q, k, v = qkv.split([h * dh, kv * dh, kv * dh], dim=-1)
            q, k, v = q.reshape(b, s, h, dh), k.reshape(b, s, kv, dh), v.reshape(b, s, kv, dh)
            if rope is not None:
                q, k = apply_rope(q, *rope), apply_rope(k, *rope)
            heads = lambda t: t.transpose(1, 2).repeat_interleave(h // t.shape[2], dim=1)
            attn = attend(cfg, heads(q), heads(k), heads(v))
            attn = attn.transpose(1, 2).reshape(b, s, cfg.d_model)
        return x + self.proj(attn)

    def cached_attention(self, x, rope, cache, layer, allowed):
        """The cached branch of ``attention_sublayer``: ``cache`` is a KV
        view (``ContiguousKV``, or the serving engine's paged view),
        ``allowed`` the (B, S, L) mask of the keys each query reads."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, kv, dh = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        q, k, v = self.qkv(self.ln1(x)).split([h * dh, kv * dh, kv * dh], dim=-1)
        q, k, v = q.reshape(b, s, h, dh), k.reshape(b, s, kv, dh), v.reshape(b, s, kv, dh)
        if rope is not None:
            # Absolute positions: the cache stores rotated keys.
            q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        # Write before attend: every key a query reads below len + s was
        # written by this sequence (the serving engine's slot-reuse rule).
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        if cfg.kv_cache_dtype == "int8":
            (k, k_sc), (v, v_sc) = quantize_kv_rows(k), quantize_kv_rows(v)
            cache.write(layer, k, v, k_sc, v_sc)
        else:
            cache.write(layer, k, v)
        # (B, KV, L, dh) f32; int8: the codes, with (B, KV, L) row scales.
        keys, values, k_scale, v_scale = cache.read(layer)
        qh = q.transpose(1, 2).reshape(b, kv, (h // kv) * s, dh).float()
        scores = (torch.matmul(qh, keys.transpose(-1, -2)) / math.sqrt(dh)).view(b, kv, h // kv, s, -1)
        if k_scale is not None:
            scores = scores * k_scale[:, :, None, None, :]
        scores = scores.masked_fill(~allowed[:, None, None], A.NEG_INF)
        weights = torch.softmax(scores, dim=-1)
        if v_scale is not None:
            weights = weights * v_scale[:, :, None, None, :]
        attn = torch.matmul(weights.view(b, kv, (h // kv) * s, -1), values).to(cfg.compute_dtype)
        attn = attn.view(b, h, s, dh).transpose(1, 2).reshape(b, s, cfg.d_model)
        return x + self.proj(attn)

    def forward(self, x, rope=None, cache=None, layer=0, allowed=None):
        if cache is None:
            x = self.attention(x, rope)
        else:
            x = self.cached_attention(x, rope, cache, layer, allowed)
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(h)


def attend(cfg: TransformerConfig, q, k, v):
    """Causal attention over (B, H, S, dh) operands by ``cfg.attention``
    other than the packed flash path: ``dense``, ``blockwise``, a
    callable, or ``flash`` on these operands (the BHSD kernels)."""
    if callable(cfg.attention):
        return cfg.attention(q, k, v)
    fn = {"dense": A.dense_attention, "blockwise": A.blockwise_attention,
          "flash": A.flash_attention}[cfg.attention]
    return fn(q, k, v, causal=True, window=cfg.attention_window)


def apply_block(block: nn.Module, x: torch.Tensor, rope, remat: bool) -> torch.Tensor:
    """``block(x, rope)``; under ``remat`` its activations are not kept but
    recomputed on backward, as ``nn.remat(Block)`` does in the JAX model."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, x, rope, use_reentrant=False)
    return block(x, rope)


class ContiguousKV:
    """KV view of a cache dict ``{"layers": [{"k", "v"[, "k_scale",
    "v_scale"]}], "len"}`` (the JAX layout: k/v (B, KV, S_max, dh), int8
    caches with (B, KV, S_max) f32 row scales; ``len`` the filled prefix,
    one int for the batch or one per row). Writes land in the layer tensors
    in place; ``read`` gives ``(k, v, k_scale, v_scale)``, k/v in f32 and the
    scales None for a compute-dtype cache."""

    def __init__(self, layers, lengths: torch.Tensor):
        self.layers = layers
        self.lengths = lengths
        self.extent = layers[0]["k"].shape[2]

    def write(self, layer, k, v, k_scale=None, v_scale=None):
        b, _, s, _ = k.shape
        pos = self.lengths[:, None] + torch.arange(s, device=k.device)
        rows = torch.arange(b, device=k.device)[:, None]
        buf = self.layers[layer]
        for name, t in (("k", k), ("v", v), ("k_scale", k_scale), ("v_scale", v_scale)):
            if t is not None:
                buf[name][rows, :, pos] = t.transpose(1, 2).to(buf[name].dtype)

    def read(self, layer):
        buf = self.layers[layer]
        return (buf["k"].float(), buf["v"].float(), buf.get("k_scale"), buf.get("v_scale"))


class TransformerLM(nn.Module):
    """``model(tokens) -> logits`` (B, S, vocab) f32, ``tokens`` (B, S) int.

    Weights are drawn from ``seed`` on a CPU generator, then moved to
    ``device``: the same seed gives the same model on every device. The
    model lives on the card unless ``device="cpu"`` is asked for; with no
    card present, ``cuda`` raises."""

    def __init__(self, cfg: TransformerConfig, seed: int = 0,
                 device: torch.device | str = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        dt = cfg.compute_dtype
        self.tok_embed = Embed(cfg.vocab_size, cfg.d_model, dt, gen)
        if cfg.position == "learned":
            self.pos_embed = Embed(cfg.max_seq_len, cfg.d_model, dt, gen)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", Block(cfg, gen))
        self.ln_f = LayerNorm(cfg.d_model, dt)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.use_bias, dt, gen)
        self.to(device)

    def with_config(self, cfg: TransformerConfig) -> "TransformerLM":
        """This model under ``cfg``, which may differ from its own only in
        ``kv_cache_dtype`` (a serving-time mode, no weight changes): a new
        module sharing every parameter, or ``self`` when nothing differs."""
        if cfg == self.cfg:
            return self
        if dataclasses.replace(self.cfg, kv_cache_dtype=cfg.kv_cache_dtype) != cfg:
            raise ValueError(f"config {cfg} differs from the model's {self.cfg} beyond "
                             "kv_cache_dtype")
        out = copy.deepcopy(self, {id(p): p for p in self.parameters()})
        for mod in out.modules():
            if isinstance(mod, (TransformerLM, Block)):
                mod.cfg = cfg
        return out

    def forward(self, tokens: torch.Tensor, cache=None, self_mask=None, positions=None):
        """Uncached: logits. With ``cache`` (a dict from
        ``models/decoding.py::init_cache``, or a KV view with ``lengths``,
        ``extent``, ``write`` and ``read``): ``(logits, cache)``, a dict's
        ``len`` advanced by S and its buffers written in place. On the cached
        path ``positions`` (B, S) replaces the write offsets for the
        embeddings and rotations, and ``self_mask`` (S, S) bool marks each
        fed token's in-block ancestors (tree verify). Uncached,
        ``positions`` (S,) or (B, S) are the tokens' global positions (a
        sequence shard's), default ``arange(S)``."""
        if cache is not None:
            return self._cached_forward(tokens, cache, positions, self_mask)
        if self_mask is not None:
            raise NotImplementedError(f"self_mask without a cache {_NOT_PORTED}")
        cfg = self.cfg
        x = self.tok_embed(tokens)
        x, rope = position_inputs(self, x, positions)
        for i in range(cfg.num_layers):
            x = apply_block(getattr(self, f"block_{i}"), x, rope, cfg.remat)
        return self.lm_head(self.ln_f(x)).float()

    def _cached_forward(self, tokens, cache, positions=None, self_mask=None):
        cfg = self.cfg
        b, s = tokens.shape
        dev = tokens.device
        view = cache
        if isinstance(cache, dict):
            lengths = torch.as_tensor(cache["len"], dtype=torch.int64, device=dev)
            view = ContiguousKV(cache["layers"], lengths.expand(b) if lengths.dim() == 0 else lengths)
        wpos = view.lengths[:, None] + torch.arange(s, device=dev)  # (B, S) write offsets
        pos = wpos if positions is None else torch.as_tensor(
            positions, dtype=torch.int64, device=dev).expand(b, s)
        x = self.tok_embed(tokens)
        rope = None
        if cfg.position == "rope":
            rope = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
        else:
            x = x + self.pos_embed(pos)
        key_pos = torch.arange(view.extent, device=dev)
        if self_mask is not None:
            # Tree verify: write order is not causal order inside the
            # block, so in-block keys follow the ancestor mask; the committed
            # prefix is visible, keys past the block stay hidden.
            if cfg.attention_window is not None:
                raise ValueError("self_mask (tree attention) is incompatible with attention_window")
            ln = view.lengths[:, None]  # (B, 1)
            in_block = (key_pos >= ln) & (key_pos < ln + s)  # (B, L)
            rel = (key_pos - ln).clamp(0, s - 1)
            anc = torch.as_tensor(self_mask, dtype=torch.bool, device=dev)[:, rel]  # (S, B, L)
            allowed = (key_pos < ln)[:, None, :] | (in_block[:, None, :] & anc.transpose(0, 1))
        else:
            allowed = key_pos[None, None, :] <= wpos[:, :, None]
            if cfg.attention_window is not None:
                allowed &= key_pos[None, None, :] > wpos[:, :, None] - cfg.attention_window
        for i in range(cfg.num_layers):
            x = getattr(self, f"block_{i}")(x, rope, cache=view, layer=i, allowed=allowed)
        logits = self.lm_head(self.ln_f(x)).float()
        if isinstance(cache, dict):
            cache = {"layers": cache["layers"], "len": cache["len"] + s}
        return logits, cache


def position_inputs(model: nn.Module, x: torch.Tensor, positions=None):
    """The training forward's positions: ``x`` with the learned position
    embeddings of ``positions`` added, or the rope tables at them.
    ``positions`` (S,) are every row's (an unbatched lookup, broadcast over
    the batch; tables (1, S, dh/2)), (B, S) each row's own; None is
    ``arange(S)``."""
    cfg = model.cfg
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    positions = torch.as_tensor(positions, device=x.device)
    one = positions.dim() == 1
    if cfg.position == "rope":
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        return x, ((cos[None], sin[None]) if one else (cos, sin))
    emb = model.pos_embed(positions)
    return x + (emb[None] if one else emb), None


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of logits[:, :-1] predicting tokens[:, 1:]."""
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v), tokens[:, 1:].reshape(-1).long())
