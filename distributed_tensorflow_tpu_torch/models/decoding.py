"""Autoregressive decoding with a KV cache for :class:`TransformerLM`.

Counterpart of ``distributed_tensorflow_tpu/models/decoding.py`` without
the speculative half (the rejection and tree verifiers and the drafters):
the samplers, the cache, one cached decode step and whole-sequence
generation. The prompt is prefilled by ONE batched causal forward that
writes its keys and values into the cache, then each new token is one
cached step (``TransformerLM``'s cached branch: no flash kernel).

Sampling draws its randomness from explicit ``torch.Generator`` s, so a
sampled stream is a function of its seed, not of what shares its batch,
but it is not JAX's ``jax.random`` stream: the two packages agree on greedy
tokens and on the filtered distribution (:func:`filter_logits_batched`),
not on sampled draws. A categorical draw is the Gumbel-max of the filtered
logits over one uniform per vocabulary entry.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from distributed_tensorflow_tpu_torch.models.transformer import (
    Dense,
    Embed,
    TransformerConfig,
    TransformerLM,
)

__all__ = [
    "build_generate_fn",
    "compute_copy",
    "decode_step",
    "filter_logits_batched",
    "init_cache",
    "sample_logits",
    "sample_logits_batched",
    "stream_uniforms",
]

_NEG_INF = -1e30  # ops/attention.py's NEG_INF: masked, not NaN-prone


def stream_uniforms(seed: int, made: int, vocab: int) -> torch.Tensor:
    """The (vocab,) uniforms of draw ``made`` of the stream seeded by
    ``seed``: a CPU generator seeded from the pair, so the draw depends on
    the request and its position in it, never on the batch around it."""
    gen = torch.Generator().manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(made) & 0xFFFFFFFF))
    return torch.rand(vocab, generator=gen)


def _gumbel_argmax(logits: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Categorical draw from ``logits`` (..., V) by the Gumbel-max trick."""
    u = uniforms.to(device=logits.device, dtype=torch.float32).clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).to(torch.int32)


def sample_logits(logits, generator: torch.Generator | None = None, temperature: float = 0.0,
                  top_k: int | None = None, top_p: float | None = None):
    """One sampling step: ``(B, V) logits → (B,) int32 tokens``.

    ``temperature <= 0`` is greedy argmax. Otherwise the logits are
    tempered, ``top_k`` keeps the k highest, then ``top_p`` keeps the
    smallest descending-probability prefix whose mass reaches top_p (the
    argmax always survives), and a categorical draw takes uniforms from
    ``generator`` (a CPU generator; None: torch's default one)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = (logits / temperature).float()
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, _NEG_INF, logits)
    if top_p is not None:
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Keep tokens whose EXCLUSIVE prefix mass is < top_p.
        n_keep = ((cum - probs) < top_p).sum(dim=-1, keepdim=True)
        thresh = torch.gather(desc, -1, n_keep - 1)
        logits = torch.where(logits < thresh, _NEG_INF, logits)
    return _gumbel_argmax(logits, torch.rand(logits.shape, generator=generator))


def filter_logits_batched(logits, temperature, top_k, top_p):
    """Tempered + top-k + nucleus FILTERED logits: ``(B, V) → (B, V) f32``
    with per-row params (the sampling distribution's definition).

    ``temperature`` (B,) — rows ``<= 0`` temper at 1.0 (their callers go
    greedy). ``top_k`` (B,) — rows ``< 1`` (or ``>= V``) disable the
    filter. ``top_p`` (B,) — rows outside ``(0, 1]`` disable it. Filters
    apply in :func:`sample_logits`' order: temper, top-k, nucleus on the
    post-top-k distribution."""
    v = logits.shape[-1]
    dev = logits.device
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)
    safe_t = torch.where(temperature > 0.0, temperature, 1.0)
    l = logits.float() / safe_t[:, None]
    # top-k as a rank cutoff on the descending sort (disabled rows: k = V).
    desc = torch.sort(l, dim=-1, descending=True).values
    k_eff = torch.where(top_k >= 1, top_k, v).clamp(1, v)
    kth = torch.gather(desc, -1, (k_eff - 1)[:, None])
    l = torch.where(l < kth, _NEG_INF, l)
    # Nucleus on the post-top-k logits (disabled rows: p = 1.0).
    p_eff = torch.where((top_p > 0.0) & (top_p <= 1.0), top_p, 1.0)
    desc = torch.sort(l, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    n_keep = ((cum - probs) < p_eff[:, None]).sum(dim=-1, keepdim=True)
    thresh = torch.gather(desc, -1, n_keep - 1)
    return torch.where(l < thresh, _NEG_INF, l)


def sample_logits_batched(logits, uniforms, temperature, top_k, top_p):
    """Per-row sampling: ``(B, V) logits → (B,) int32 tokens``. Rows with
    ``temperature <= 0`` are greedy argmax; the rest draw from
    :func:`filter_logits_batched` with their row of ``uniforms`` (B, V)
    (:func:`stream_uniforms` of each row's seed and draw index)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled = _gumbel_argmax(filter_logits_batched(logits, temperature, top_k, top_p), uniforms)
    t = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    return torch.where(t > 0.0, sampled, greedy)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device: torch.device | str = "cpu") -> dict:
    """Per-layer KV buffers (B, KV heads, max_len, dh) in the compute dtype
    (the unexpanded kv heads under GQA) and one filled-prefix ``len``."""
    if cfg.kv_cache_dtype is not None:
        raise NotImplementedError(f"kv_cache_dtype={cfg.kv_cache_dtype!r} is not ported yet")
    shape = (batch, cfg.kv_heads, max_len, cfg.head_dim)
    return {
        "layers": [
            {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}
            for _ in range(cfg.num_layers)
        ],
        "len": torch.zeros((), dtype=torch.int64, device=device),
    }


def decode_step(model: TransformerLM, cache, tok):
    """One cached step: ``tok (B, s) → (cache', last-position logits (B, V))``."""
    logits, cache = model(tok, cache=cache)
    return cache, logits[:, -1]


def compute_copy(model: TransformerLM) -> TransformerLM:
    """A copy of ``model`` whose Dense and Embed weights are already in the
    compute dtype, so no call casts them again; LayerNorm stays f32. The
    values equal the per-call casts', so the logits do too. An f32 model
    is returned as it is."""
    dt = model.cfg.compute_dtype
    if dt == torch.float32:
        return model
    memo = {}
    for mod in model.modules():
        if isinstance(mod, (Dense, Embed)):
            for p in mod.parameters(recurse=False):
                memo[id(p)] = nn.Parameter(p.detach().to(dt), requires_grad=False)
    return copy.deepcopy(model, memo)


def build_generate_fn(cfg: TransformerConfig, max_new_tokens: int, temperature: float = 0.0,
                      cache_len: int | None = None, cast_params: bool = True,
                      top_k: int | None = None, top_p: float | None = None):
    """``generate(model, prompt (B, P) int, generator=None) -> tokens (B, P +
    max_new_tokens)`` on the model's device. ``temperature == 0`` is greedy;
    otherwise :func:`sample_logits` filters by ``top_k`` then ``top_p``.
    ``cache_len`` overrides the cache length (default P + max_new_tokens);
    ``cast_params`` runs a compute-dtype copy of the weights
    (:func:`compute_copy`), made once per call."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")

    @torch.no_grad()
    def generate(model, prompt, generator=None):
        dev = next(model.parameters()).device
        prompt = torch.as_tensor(prompt, dtype=torch.int64, device=dev)
        b, p = prompt.shape
        if p < 1:
            raise ValueError("prompt must contain at least one token")
        max_len = p + max_new_tokens
        if max_len > cfg.max_seq_len:
            raise ValueError(f"prompt {p} + {max_new_tokens} new > max_seq_len {cfg.max_seq_len}")
        if cache_len is not None:
            if cache_len < max_len:
                raise ValueError(f"cache_len {cache_len} < needed {max_len}")
            max_len = cache_len
        if cast_params:
            model = compute_copy(model)
        cache = init_cache(cfg, b, max_len, device=dev)
        logits, cache = model(prompt, cache=cache)
        last = logits[:, -1]
        new = []
        for i in range(max_new_tokens):
            tok = sample_logits(last, generator, temperature, top_k, top_p)
            new.append(tok.to(torch.int64))
            if i + 1 < max_new_tokens:  # the last token needs no forward
                cache, last = decode_step(model, cache, new[-1][:, None])
        return torch.cat([prompt, torch.stack(new, dim=1)], dim=1)

    return generate
