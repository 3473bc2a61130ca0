"""Decoder-only transformer LM.

Counterpart of ``distributed_tensorflow_tpu/models/transformer.py``:
pre-norm blocks, tanh-GELU MLP, learned or rotary positions, GQA,
sliding-window causal attention, and the attention implementation chosen by
name — ``dense`` (the O(S²) reference) or ``flash`` (the packed-qkv kernels
of ``ops/attention.py``) — on the uncached (training) path.

With a KV cache (``model(tokens, cache=...)``) the model runs the JAX
model's cached branch instead, which reaches no flash kernel: the new keys
and values are written at absolute positions ``len + arange(s)`` first, then
the queries attend the whole cache by two f32 matmuls under an explicit
causal (and window) mask. The cache holds the unexpanded kv heads, rope
rotates q and k at their absolute positions, and positions at or above a
row's ``len + s`` (a freed slot's stale keys, a padded tail) stay masked.

Numerics follow the flax modules the JAX model is built from: parameters are
f32 and every matmul casts its input and weight to ``compute_dtype``;
LayerNorm epsilon is flax's 1e-6; GELU is the tanh approximation; logits are
returned in f32. Parameter names match the flax tree (``tok_embed``,
``pos_embed``, ``block_i/{ln1, qkv, proj, ln2, mlp_in, mlp_out}``, ``ln_f``,
``lm_head``) so ``models/convert.py`` maps one onto the other by name.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch.ops import attention as A
from distributed_tensorflow_tpu_torch.ops.rope import apply_rope, rope_cos_sin, rope_tables
from distributed_tensorflow_tpu_torch.utils.device import resolve_device

LN_EPS = 1e-6  # flax.linen.LayerNorm's default (torch's is 1e-5)
ATTENTION = ("dense", "flash")
_NOT_PORTED = "is not ported yet"


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 128
    num_heads: int = 4
    num_layers: int = 2
    d_ff: int = 512
    max_seq_len: int = 2048
    attention: str = "dense"  # 'dense' | 'flash'
    compute_dtype: torch.dtype = torch.float32
    use_bias: bool = True
    num_kv_heads: int | None = None  # None = multi-head
    attention_window: int | None = None  # None = full causal
    position: str = "learned"  # 'learned' | 'rope'
    rope_theta: float = 10000.0
    kv_cache_dtype: str | None = None  # None = compute dtype; 'int8' not ported yet

    def __post_init__(self):
        if self.position not in ("learned", "rope"):
            raise ValueError(f"position must be 'learned' or 'rope', got {self.position!r}")
        if self.attention not in ATTENTION:
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
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
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


class Block(nn.Module):
    """Pre-norm attention sublayer + pre-norm GELU MLP, both residual."""

    def __init__(self, cfg: TransformerConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, dt, bias = cfg.d_model, cfg.compute_dtype, cfg.use_bias
        self.ln1 = LayerNorm(d, dt)
        self.qkv = Dense(d, d + 2 * cfg.kv_heads * cfg.head_dim, bias, dt, gen)
        self.proj = Dense(d, d, bias, dt, gen)
        self.ln2 = LayerNorm(d, dt)
        self.mlp_in = Dense(d, cfg.d_ff, bias, dt, gen)
        self.mlp_out = Dense(cfg.d_ff, d, bias, dt, gen)

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
            attn = A.dense_attention(heads(q), heads(k), heads(v), causal=True,
                                     window=cfg.attention_window)
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
        cache.write(layer, k.transpose(1, 2), v.transpose(1, 2))
        keys, values = cache.read(layer)  # (B, KV, L, dh) f32
        qh = q.transpose(1, 2).reshape(b, kv, (h // kv) * s, dh).float()
        scores = torch.matmul(qh, keys.transpose(-1, -2)) / math.sqrt(dh)
        scores = scores.view(b, kv, h // kv, s, -1).masked_fill(~allowed[:, None, None], A.NEG_INF)
        weights = torch.softmax(scores, dim=-1).view(b, kv, (h // kv) * s, -1)
        attn = torch.matmul(weights, values).to(cfg.compute_dtype)
        attn = attn.view(b, h, s, dh).transpose(1, 2).reshape(b, s, cfg.d_model)
        return x + self.proj(attn)

    def forward(self, x, rope=None, cache=None, layer=0, allowed=None):
        if cache is None:
            x = self.attention(x, rope)
        else:
            x = self.cached_attention(x, rope, cache, layer, allowed)
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(h)


class ContiguousKV:
    """KV view of a cache dict ``{"layers": [{"k", "v"}], "len"}`` (the JAX
    layout: k/v (B, KV, S_max, dh), ``len`` the filled prefix, one int for
    the batch or one per row). Writes land in the layer tensors in place."""

    def __init__(self, layers, lengths: torch.Tensor):
        self.layers = layers
        self.lengths = lengths
        self.extent = layers[0]["k"].shape[2]

    def write(self, layer, k, v):
        b, _, s, _ = k.shape
        pos = self.lengths[:, None] + torch.arange(s, device=k.device)
        rows = torch.arange(b, device=k.device)[:, None]
        buf = self.layers[layer]
        buf["k"][rows, :, pos] = k.transpose(1, 2).to(buf["k"].dtype)
        buf["v"][rows, :, pos] = v.transpose(1, 2).to(buf["v"].dtype)

    def read(self, layer):
        buf = self.layers[layer]
        return buf["k"].float(), buf["v"].float()


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

    def forward(self, tokens: torch.Tensor, cache=None, self_mask=None):
        """Uncached: logits. With ``cache`` (a dict from
        ``models/decoding.py::init_cache``, or a KV view with ``lengths``,
        ``extent``, ``write`` and ``read``): ``(logits, cache)``, a dict's
        ``len`` advanced by S and its buffers written in place.
        ``self_mask`` (tree speculation) is not ported yet."""
        if self_mask is not None:
            raise NotImplementedError(f"self_mask (tree attention) {_NOT_PORTED}")
        if cache is not None:
            return self._cached_forward(tokens, cache)
        cfg = self.cfg
        s = tokens.shape[1]
        x = self.tok_embed(tokens)
        rope = None
        if cfg.position == "rope":
            rope = rope_tables(cfg.head_dim, s, cfg.rope_theta, device=tokens.device)
        else:
            # Unbatched lookup of positions 0..S-1, broadcast over the batch.
            x = x + self.pos_embed(torch.arange(s, device=tokens.device))[None]
        for i in range(cfg.num_layers):
            x = getattr(self, f"block_{i}")(x, rope)
        return self.lm_head(self.ln_f(x)).float()

    def _cached_forward(self, tokens, cache):
        cfg = self.cfg
        if cfg.kv_cache_dtype is not None:
            raise NotImplementedError(f"kv_cache_dtype={cfg.kv_cache_dtype!r} {_NOT_PORTED}")
        b, s = tokens.shape
        dev = tokens.device
        view = cache
        if isinstance(cache, dict):
            lengths = torch.as_tensor(cache["len"], dtype=torch.int64, device=dev)
            view = ContiguousKV(cache["layers"], lengths.expand(b) if lengths.dim() == 0 else lengths)
        pos = view.lengths[:, None] + torch.arange(s, device=dev)  # (B, S) absolute
        x = self.tok_embed(tokens)
        rope = None
        if cfg.position == "rope":
            rope = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
        else:
            x = x + self.pos_embed(pos)
        key_pos = torch.arange(view.extent, device=dev)
        allowed = key_pos[None, None, :] <= pos[:, :, None]
        if cfg.attention_window is not None:
            allowed &= key_pos[None, None, :] > pos[:, :, None] - cfg.attention_window
        for i in range(cfg.num_layers):
            x = getattr(self, f"block_{i}")(x, rope, cache=view, layer=i, allowed=allowed)
        logits = self.lm_head(self.ln_f(x)).float()
        if isinstance(cache, dict):
            cache = {"layers": cache["layers"], "len": cache["len"] + s}
        return logits, cache


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of logits[:, :-1] predicting tokens[:, 1:]."""
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v), tokens[:, 1:].reshape(-1).long())
