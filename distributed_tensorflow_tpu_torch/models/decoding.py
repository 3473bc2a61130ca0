"""Autoregressive decoding with a KV cache for :class:`TransformerLM`.

Counterpart of ``distributed_tensorflow_tpu/models/decoding.py``: the
samplers, the cache (compute-dtype or int8 rows with f32 scales), one cached
decode step, whole-sequence generation, and the speculative half — the
n-gram drafters, the learned drafter (``build_draft_fn``) and the lossless
rejection-sampling verifiers, linear and tree. The prompt is prefilled by
ONE batched causal forward that writes its keys and values into the cache,
then each new token is one cached step (``TransformerLM``'s cached branch:
no flash kernel).

Sampling draws its randomness from explicit ``torch.Generator`` s, so a
sampled stream is a function of its seed, not of what shares its batch,
but it is not JAX's ``jax.random`` stream: the two packages agree on greedy
tokens and on the filtered distribution (:func:`filter_logits_batched`),
not on sampled draws. A categorical draw is the Gumbel-max of the filtered
logits over one uniform per vocabulary entry. The verifiers key their draws
as the JAX ones do, by (seed, emitted-token index): the categorical at
index ``made + j`` takes ``stream_uniforms(seed, made + j, V)`` (the plain
sampler's draw at that index), the accept test stream 1 and the tree's root
tests streams ``2 + b`` of the same index.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_tpu_torch.models.quant import QuantDense
from distributed_tensorflow_tpu_torch.models.transformer import (
    Dense,
    Embed,
    TransformerConfig,
    TransformerLM,
)

__all__ = [
    "build_draft_fn",
    "build_generate_fn",
    "compute_copy",
    "decode_step",
    "filter_logits_batched",
    "init_cache",
    "init_draft_params",
    "make_draft_config",
    "propose_ngram_drafts",
    "propose_ngram_tree",
    "rejection_verify_row",
    "sample_logits",
    "sample_logits_batched",
    "stream_uniforms",
    "tree_rejection_verify_row",
]

_NEG_INF = -1e30  # ops/attention.py's NEG_INF: masked, not NaN-prone


_M64 = 0xFFFFFFFFFFFFFFFF


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a 64-bit key → well-mixed 64 bits."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def stream_uniforms(seed: int, made: int, vocab: int, stream: int = 0) -> torch.Tensor:
    """The (vocab,) uniforms of draw ``made`` of the stream seeded by
    ``seed``: a CPU generator seeded from the pair, so the draw depends on
    the request and its position in it, never on the batch around it.
    ``stream`` > 0 picks an independent sub-stream of the same index (the
    verifiers' accept tests). The CPU generator keeps only the low 32 bits
    of its seed, so (seed, made, stream) is hashed down to them."""
    key = _mix64(((int(seed) & 0xFFFFFFFF) << 32) | (int(made) & 0xFFFFFFFF))
    if stream:
        key = _mix64(key ^ int(stream))
    gen = torch.Generator().manual_seed((key ^ (key >> 32)) & 0xFFFFFFFF)
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


def _draw(logits: torch.Tensor, seed: int, index: int) -> int:
    """The categorical draw at emitted-token ``index`` of a stream."""
    return int(_gumbel_argmax(logits, stream_uniforms(seed, index, logits.shape[-1])))


def _residual(p: torch.Tensor, drafted: int) -> torch.Tensor:
    """Logits of ``p`` with the drafted token's mass removed."""
    resid = torch.log(p.clamp_min(1e-38))
    resid[drafted] = _NEG_INF
    return resid


def rejection_verify_row(filtered_logits, drafts, seed, made):
    """Lossless rejection-sampling verify of ONE slot's linear draft block.

    ``filtered_logits`` (k+1, V): the target's logits over the block after
    :func:`filter_logits_batched` with the slot's sampling params (row ``j``
    conditions on drafts ``0..j-1``, row ``k`` is the bonus position).
    ``drafts`` (k,). The drafters propose greedily (a point mass), so draft
    ``j`` is accepted with probability ``p(draft)`` and the first rejection
    resamples from ``p`` with the drafted token removed; all k accepted, the
    bonus draws from row k. Each emitted token is marginally a draw from
    ``softmax(filtered_logits)``. Returns ``(emitted (k+1,) int64, accepts
    int)``: ``emitted[:accepts]`` the accepted drafts, ``emitted[accepts]``
    the resample or bonus; later entries are junk the engine discards (the
    tests after the first rejection and the draws past it are not made)."""
    f = torch.as_tensor(filtered_logits).float().cpu()
    d = torch.as_tensor(drafts, dtype=torch.int64).cpu()
    k = f.shape[0] - 1
    p = torch.softmax(f, dim=-1)
    accepts = 0
    while accepts < k and bool(stream_uniforms(seed, made + accepts, 1, stream=1)[0]
                               < p[accepts, d[accepts]]):
        accepts += 1
    last = _residual(p[accepts], int(d[accepts])) if accepts < k else f[k]
    emitted = torch.cat([d, d.new_zeros(1)])
    emitted[accepts] = _draw(last, seed, made + accepts)
    return emitted, accepts


def tree_rejection_verify_row(filtered_logits, tree, seed, made):
    """Lossless rejection-sampling verify of ONE slot's draft TREE.

    ``filtered_logits`` (1 + B·D, V): row 0 the distribution after the
    slot's current token, row ``1 + b·D + j`` after branch ``b``'s drafts
    ``0..j``. ``tree`` (B, D), row 0 the linear drafter's block. Level 1
    tests the B roots in turn (accept root ``b`` with ``p_res[c_b] / z``,
    each rejection removing its token's mass from ``p_res`` and ``z``;
    duplicate roots reject for free); if all reject, the level-1 token draws
    from the residual. Levels 2..D run the linear test along the accepted
    branch, the bonus at offset D. Returns ``(emitted (D+1,), accepts,
    bsel)``: ``bsel`` the branch whose keys the engine keeps (0 when every
    root rejected); entries past ``accepts`` are junk."""
    f = torch.as_tensor(filtered_logits).float().cpu()
    t = torch.as_tensor(tree, dtype=torch.int64).cpu()
    b_br, d = t.shape
    p_res = torch.softmax(f[0], dim=-1)
    z = torch.tensor(1.0)
    chosen = -1
    for b in range(b_br):
        c = int(t[b, 0])
        if bool(stream_uniforms(seed, made, 1, stream=2 + b)[0] * z < p_res[c]):
            chosen = b
            break
        z = z - p_res[c]
        p_res[c] = 0.0
    bsel = max(chosen, 0)
    path = t[bsel]
    emitted = torch.cat([path, path.new_zeros(1)])
    if chosen < 0:
        emitted[0] = _draw(torch.log(p_res.clamp_min(1e-38)), seed, made)
        return emitted, 0, bsel
    rows = 1 + bsel * d + torch.arange(d)  # the rows after each of the path's drafts
    p_path = torch.softmax(f[rows], dim=-1)
    accepts = 1
    while accepts < d and bool(stream_uniforms(seed, made + accepts, 1, stream=1)[0]
                               < p_path[accepts - 1, path[accepts]]):
        accepts += 1
    last = (_residual(p_path[accepts - 1], int(path[accepts])) if accepts < d
            else f[rows[-1]])
    emitted[accepts] = _draw(last, seed, made + accepts)
    return emitted, accepts, bsel


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device: torch.device | str = "cpu") -> dict:
    """Per-layer KV buffers (B, KV heads, max_len, dh) in the compute dtype
    (the unexpanded kv heads under GQA) and one filled-prefix ``len``;
    under ``kv_cache_dtype="int8"`` int8 ``k``/``v`` with f32 ``k_scale``/
    ``v_scale`` (B, KV heads, max_len)."""
    if cfg.kv_cache_dtype not in (None, "int8"):
        raise ValueError(f"kv_cache_dtype must be None or 'int8', got {cfg.kv_cache_dtype!r}")
    int8 = cfg.kv_cache_dtype == "int8"
    shape = (batch, cfg.kv_heads, max_len, cfg.head_dim)
    dt = torch.int8 if int8 else cfg.compute_dtype

    def layer():
        buf = {"k": torch.zeros(shape, dtype=dt, device=device),
               "v": torch.zeros(shape, dtype=dt, device=device)}
        if int8:
            buf["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
            buf["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        return buf

    return {
        "layers": [layer() for _ in range(cfg.num_layers)],
        "len": torch.zeros((), dtype=torch.int64, device=device),
    }


def decode_step(model: TransformerLM, cache, tok):
    """One cached step: ``tok (B, s) → (cache', last-position logits (B, V))``."""
    logits, cache = model(tok, cache=cache)
    return cache, logits[:, -1]


def compute_copy(model: TransformerLM) -> TransformerLM:
    """A copy of ``model`` whose Dense and Embed weights are already in the
    compute dtype, so no call casts them again; LayerNorm stays as stored.
    A ``QuantDense`` layer stays quantized and is shared, not copied (a
    compute-dtype copy of its weight would be a quiet bf16 fallback). The
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
        elif isinstance(mod, QuantDense):
            for p in mod.parameters(recurse=False):
                memo[id(p)] = p
    return copy.deepcopy(model, memo)


def _matches(h: np.ndarray, pat: np.ndarray) -> np.ndarray:
    """Start indices ``j``, descending, where ``h[j:j+g]`` equals ``pat``
    (length g) with at least one token after it."""
    g = pat.size
    if h.size - 1 < g:
        return np.zeros(0, np.int64)
    windows = np.lib.stride_tricks.sliding_window_view(h[:-1], g)
    return np.nonzero((windows == pat).all(axis=1))[0][::-1]


def propose_ngram_drafts(history, k: int, ngram: int = 2) -> np.ndarray:
    """Prompt-lookup drafting (host-side, numpy): ``k`` tokens continuing the
    most recent earlier occurrence of the history's final n-gram, backing
    off to shorter grams, padded with the last token. Draft quality only
    moves the accept rate, never a verified token."""
    h = np.asarray(history, np.int32).ravel()
    n = int(h.size)
    draft = np.zeros(k, np.int32)
    if n == 0:
        return draft
    draft[:] = h[-1]
    for g in range(min(ngram, n - 1), 0, -1):
        hits = _matches(h, h[n - g:])
        if hits.size:
            cont = h[hits[0] + g: hits[0] + g + k]
            draft[: cont.size] = cont
            return draft
    return draft


def propose_ngram_tree(history, k: int, branches: int, extra_histories=(),
                       ngram: int = 2) -> np.ndarray:
    """A ``(branches, k)`` draft tree: row 0 is :func:`propose_ngram_drafts`,
    the other rows distinct continuations of the final n-gram — earlier
    occurrences in the history, most recent first, then the most recent one
    in each of ``extra_histories`` (the other active slots'). Rows left
    unfilled repeat row 0."""
    if branches < 1:
        raise ValueError(f"branches must be >= 1, got {branches}")
    h = np.asarray(history, np.int32).ravel()
    out = np.zeros((branches, k), np.int32)
    out[:] = propose_ngram_drafts(h, k, ngram=ngram)[None]
    n = int(h.size)
    if n == 0 or branches == 1:
        return out
    peers = [np.asarray(eh, np.int32).ravel() for eh in extra_histories]
    cands = []
    for g in range(min(ngram, n - 1), 0, -1):
        pat = h[n - g:]
        cands += [h[j + g: j + g + k] for j in _matches(h, pat)]
        for e in peers:
            hits = _matches(e, pat)
            if hits.size:
                cands.append(e[hits[0] + g: hits[0] + g + k])
    seen = {out[0].tobytes()}
    row = 1
    for cont in cands:
        if row >= branches:
            break
        cand = np.full(k, cont[-1], np.int32)
        cand[: cont.size] = cont
        key = cand.tobytes()
        if key not in seen:
            seen.add(key)
            out[row] = cand
            row += 1
    return out


def make_draft_config(cfg: TransformerConfig, num_layers: int,
                      max_seq_len: int | None = None) -> TransformerConfig:
    """The draft model: the target truncated to its first ``num_layers``
    blocks, same widths, vocab and embeddings."""
    if not 1 <= num_layers <= cfg.num_layers:
        raise ValueError(f"draft num_layers {num_layers} outside [1, {cfg.num_layers}]")
    return dataclasses.replace(cfg, num_layers=num_layers,
                               max_seq_len=max_seq_len or cfg.max_seq_len)


def init_draft_params(cfg: TransformerConfig, target: TransformerLM,
                      num_layers: int) -> TransformerLM:
    """A draft model seeded from ``target`` (config ``cfg``): the embeddings,
    the first ``num_layers`` blocks, ``ln_f`` and ``lm_head``, copied, on the
    target's device and in its dtypes (a quantized target gives a quantized
    drafter). Its config is ``make_draft_config(cfg, num_layers)``."""
    keep = {}
    for name, t in target.state_dict().items():
        head = name.split(".", 1)[0]
        if not head.startswith("block_") or int(head[len("block_"):]) < num_layers:
            keep[name] = t.detach().clone()
    draft = TransformerLM(make_draft_config(cfg, num_layers), device="cpu")
    draft.load_state_dict(keep, assign=True)
    return draft


def build_draft_fn(cfg: TransformerConfig, k: int, window: int):
    """``draft(model, tokens (B, window), lens (B,), pos0 (B,)) -> (B, k)``
    int64 — the learned drafter of the serving engine, greedy.

    Row ``i`` holds a slot's history suffix in ``tokens[i, :lens[i]]`` (the
    last real token is its current token), pad after. One causal forward of
    the window into a fresh ``window + k`` cache, the greedy pick at
    ``lens - 1``; then the cache length rewinds to ``lens`` and ``k - 1``
    cached greedy steps roll on (write-before-attend hides the pad rows
    until they are overwritten). ``pos0`` is the absolute position of
    ``tokens[i, 0]``: the drafter reads the target's position rows (or
    rotations) at the history's real positions, clamped to
    ``max_seq_len - 1``."""
    if k < 1:
        raise ValueError(f"spec k must be >= 1, got {k}")
    if window < 1:
        raise ValueError(f"draft window must be >= 1, got {window}")
    if window + k > cfg.max_seq_len:
        raise ValueError(f"window {window} + k {k} > draft max_seq_len {cfg.max_seq_len}")
    pmax = cfg.max_seq_len - 1

    @torch.no_grad()
    def draft(model, tokens, lens, pos0):
        dev = next(model.parameters()).device
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64).to(dev)
        lens = torch.as_tensor(np.asarray(lens), dtype=torch.int64).to(dev)
        pos0 = torch.as_tensor(np.asarray(pos0), dtype=torch.int64).to(dev)
        b = tokens.shape[0]
        cache = init_cache(cfg, b, window + k, device=dev)
        positions = (pos0[:, None] + torch.arange(window, device=dev)).clamp_max(pmax)
        logits, cache = model(tokens, cache=cache, positions=positions)
        tok = torch.argmax(logits[torch.arange(b, device=dev), lens - 1], dim=-1)
        cache["len"] = lens
        out = [tok]
        for _ in range(k - 1):
            pos = (pos0 + cache["len"]).clamp_max(pmax)[:, None]
            lg, cache = model(tok[:, None], cache=cache, positions=pos)
            tok = torch.argmax(lg[:, -1], dim=-1)
            out.append(tok)
        return torch.stack(out, dim=1)

    return draft


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
