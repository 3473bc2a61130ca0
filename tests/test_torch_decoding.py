"""The port's cached forward and samplers against the JAX package's.

From the same flax weights (through the converter) and the same
numpy-seeded tokens, in f32 on the CPU: the cached branch's logits at an
offset prefill and at single-token decode steps, and the cache it writes,
equal the JAX ``TransformerLM`` with a cache within 1e-5 relative to the
largest value; ``filter_logits_batched`` equals JAX's within 1e-6 and keeps
the same tokens but for ones of mass under 1e-6; greedy
``build_generate_fn`` tokens are identical; ``quantize_kv_rows`` is bit for
bit JAX's, and the int8 cache's logits equal JAX's int8 cache's within 1e-5
and the exact forward's within JAX's 5% bound. Sampled streams draw from torch
generators, so they are held to the port's own contracts instead: seed
determinism, top_k 1 equal to greedy, every draw inside the filtered
support. The shapes are tests/test_serve_engine.py's (vocab 64, d_model 32,
4 heads, 2 layers, 48 positions), plus rope θ 500000 with GQA (4 on 2) and
a window of 6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import decoding as JD
from distributed_tensorflow_tpu.models import transformer as JT
from distributed_tensorflow_tpu_torch.models import decoding as TD
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import (
    transformer_params_from_jax,
    transformer_params_to_jax,
)

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

REL = 1e-5  # relative to the largest logit: f32 sums in another order
BASE = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, d_ff=64, max_seq_len=48)
CASES = {
    "learned": BASE,
    "rope_gqa_window": dict(BASE, position="rope", rope_theta=500000.0, num_kv_heads=2,
                            attention_window=6),
}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    shape = CASES[request.param]
    jcfg = JT.TransformerConfig(compute_dtype=jnp.float32, **shape)
    tcfg = TT.TransformerConfig(compute_dtype=torch.float32, **shape)
    # The port draws the weights (no JAX init to compile); both packages
    # start from them.
    params = transformer_params_to_jax(TT.TransformerLM(tcfg, device="cpu"))
    model = TT.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(transformer_params_from_jax(params))
    return jcfg, params, tcfg, model


def test_cached_prefill_and_decode_match_jax(pair):
    """A 12-token prefill, a 5-token prefill at offset 12, then three
    single-token steps: every call's logits and the final cache."""
    jcfg, params, tcfg, model = pair
    toks = np.random.default_rng(0).integers(0, 64, (2, 20)).astype(np.int32)
    apply = jax.jit(lambda t, c: JT.TransformerLM(jcfg).apply({"params": params}, t, cache=c))
    jc = JD.init_cache(jcfg, 2, 32)
    tc = TD.init_cache(tcfg, 2, 32)
    with torch.no_grad():
        for a, b in ((0, 12), (12, 17), (17, 18), (18, 19), (19, 20)):
            jl, jc = apply(jnp.asarray(toks[:, a:b]), jc)
            tl, tc = model(torch.from_numpy(toks[:, a:b]).long(), cache=tc)
            assert _rel(tl.numpy(), jl) <= REL, (a, b)
    assert int(tc["len"]) == int(jc["len"]) == 20
    for tl_, jl_ in zip(tc["layers"], jc["layers"]):
        for name in ("k", "v"):
            assert tl_[name].shape == jl_[name].shape  # (B, KV heads, S, dh), unexpanded
            assert _rel(tl_[name].numpy(), jl_[name]) <= REL, name


def test_cached_path_equals_the_uncached_forward(pair):
    """Port against port: prefill + decode steps reproduce the uncached
    forward's logits (the causal mask at absolute positions)."""
    _, _, tcfg, model = pair
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (1, 16)))
    cache = TD.init_cache(tcfg, 1, 16)
    with torch.no_grad():
        full = model(toks)
        first, cache = model(toks[:, :10], cache=cache)
        rest = []
        for i in range(10, 16):
            cache, last = TD.decode_step(model, cache, toks[:, i:i + 1])
            rest.append(last[:, None])
    got = torch.cat([first] + rest, dim=1)
    assert _rel(got.numpy(), full.numpy()) <= REL


def test_greedy_generate_matches_jax(pair):
    jcfg, params, tcfg, model = pair
    prompt = np.random.default_rng(2).integers(0, 64, (2, 5)).astype(np.int32)
    want = np.asarray(JD.build_generate_fn(jcfg, 9)(params, jnp.asarray(prompt),
                                                    jax.random.PRNGKey(0)))
    got = TD.build_generate_fn(tcfg, 9)(model, prompt).numpy()
    np.testing.assert_array_equal(got, want)


def test_filter_logits_batched_matches_jax():
    rng = np.random.default_rng(3)
    logits = (3.0 * rng.standard_normal((6, 64))).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.0, 1.5, 1.0, 0.9], np.float32)
    top_k = np.array([0, 5, 1, 0, 64, 20], np.int32)
    top_p = np.array([0.0, 0.9, 0.5, 0.3, 1.0, 0.0], np.float32)
    want = np.asarray(JD.filter_logits_batched(jnp.asarray(logits), jnp.asarray(temp),
                                               jnp.asarray(top_k), jnp.asarray(top_p)))
    got = TD.filter_logits_batched(torch.from_numpy(logits), torch.from_numpy(temp),
                                   torch.from_numpy(top_k), torch.from_numpy(top_p)).numpy()
    # The same support, but for tokens of negligible mass: where the f32
    # cumulative sum reaches p = 1 (a disabled nucleus) depends on the sum's
    # order, so the two may cut a different number of ~1e-9 tails.
    safe_t = np.where(temp > 0, temp, 1.0)[:, None]
    probs = np.exp(logits / safe_t - (logits / safe_t).max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    differ = (got <= -1e29) != (want <= -1e29)
    assert (probs[differ] < 1e-6).all(), probs[differ]
    kept = (want > -1e29) & (got > -1e29)
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6, atol=0)


def test_sampling_contracts():
    """Seeded streams repeat, top_k 1 is greedy, every draw lies in the
    filtered support, and the batched sampler's greedy rows are argmax."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy((2.0 * rng.standard_normal((4, 64))).astype(np.float32))
    greedy = torch.argmax(logits, -1).int()
    draw = lambda seed, **kw: TD.sample_logits(logits, torch.Generator().manual_seed(seed), **kw)
    assert torch.equal(draw(5, temperature=0.8, top_k=7), draw(5, temperature=0.8, top_k=7))
    assert torch.equal(draw(5, temperature=1.3, top_k=1), greedy)
    assert torch.equal(draw(0), greedy)
    for seed in range(20):
        tok = draw(seed, temperature=1.0, top_k=5).long()
        top5 = torch.topk(logits, 5, dim=-1).indices
        assert (top5 == tok[:, None]).any(dim=1).all()
    temp = torch.tensor([0.0, 1.0, 1.0, 0.0])
    top_k = torch.tensor([0, 3, 1, 2])
    top_p = torch.tensor([0.0, 0.0, 0.0, 0.5])
    for made in range(10):
        u = torch.stack([TD.stream_uniforms(9, made, 64) for _ in range(4)])
        got = TD.sample_logits_batched(logits, u, temp, top_k, top_p)
        assert got[0] == greedy[0] and got[2] == greedy[2] and got[3] == greedy[3]
        assert int(got[1]) in torch.topk(logits[1], 3).indices.tolist()
    assert torch.equal(TD.stream_uniforms(9, 3, 64), TD.stream_uniforms(9, 3, 64))
    assert not torch.equal(TD.stream_uniforms(9, 3, 64), TD.stream_uniforms(9, 4, 64))


def test_streams_differ_by_seed_and_sub_stream():
    """The CPU generator keeps 32 bits of its seed: a key of seed << 32 |
    made gave every request the same draws (fixed). Draws differ by seed, by
    index and by sub-stream, and repeat for the same triple."""
    draws = {(s, m, k): TD.stream_uniforms(s, m, 16, stream=k)
             for s in (0, 1, 9, 2**31 + 5) for m in (0, 1, 7) for k in (0, 1, 3)}
    flat = torch.stack(list(draws.values()))
    assert len({tuple(r.tolist()) for r in flat}) == len(draws)
    assert torch.equal(TD.stream_uniforms(9, 7, 16, stream=3), draws[(9, 7, 3)])
    firsts = torch.stack([TD.stream_uniforms(s, 0, 1)[0] for s in range(2000)])
    assert abs(float(firsts.mean()) - 0.5) < 0.03 and float(firsts.std()) > 0.25


def test_compute_copy_gives_the_per_call_casts_logits():
    """bf16 compute: the engine's held bf16 weights give the logits the
    per-call casts give (the same values), and leave LayerNorm in f32."""
    cfg = TT.TransformerConfig(compute_dtype=torch.bfloat16, **BASE)
    model = TT.TransformerLM(cfg, seed=3, device="cpu")
    held = TD.compute_copy(model)
    assert held.block_0.qkv.weight.dtype == torch.bfloat16
    assert held.block_0.ln1.weight.dtype == torch.float32
    assert model.block_0.qkv.weight.dtype == torch.float32  # the original is untouched
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 64, (2, 12)))
    with torch.no_grad():
        assert torch.equal(held(toks), model(toks))
    f32 = TT.TransformerLM(TT.TransformerConfig(**BASE), device="cpu")
    assert TD.compute_copy(f32) is f32


def test_unported_cache_options_raise():
    """What stays unported: a tree mask on the uncached path. Positions
    there are ported (sequence shards embed their global positions), and
    the default ones give the plain forward's logits. A KV format other
    than int8 is refused as JAX refuses it, and so is a tree mask under a
    window."""
    with pytest.raises(ValueError, match="kv_cache_dtype must be None or 'int8'"):
        TT.TransformerConfig(kv_cache_dtype="int4", **BASE)
    model = TT.TransformerLM(TT.TransformerConfig(**BASE), device="cpu")
    toks = torch.zeros(1, 2, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        model(toks, self_mask=torch.ones(2, 2, dtype=torch.bool))
    with torch.no_grad():
        assert torch.equal(model(toks, positions=torch.arange(2)[None]), model(toks))
    windowed = TT.TransformerLM(TT.TransformerConfig(attention_window=4, **BASE), device="cpu")
    with pytest.raises(ValueError, match="incompatible with attention_window"):
        windowed(toks, cache=TD.init_cache(windowed.cfg, 1, 8),
                 self_mask=torch.ones(2, 2, dtype=torch.bool))


def test_quantize_kv_rows_is_bit_equal_to_jax():
    x = (3.0 * np.random.default_rng(6).standard_normal((2, 4, 16, 8))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    want_q, want_s = JT.quantize_kv_rows(jnp.asarray(x))
    got_q, got_s = TT.quantize_kv_rows(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_int8_cache_matches_jax_and_tracks_the_exact_forward(pair):
    """The int8 cache (quantize on write, the row scales on the score and
    weight matrices): every call's logits within REL of JAX's int8 cache,
    and within JAX's bound of the exact forward (5% of the largest logit
    plus 5% of each); the buffers are int8 codes with (B, KV, S) f32 scales
    equal to JAX's (a code may differ by one where an f32 sum of another
    order lands the other side of a rounding tie)."""
    jcfg, params, tcfg, model = pair
    jq = dataclasses.replace(jcfg, kv_cache_dtype="int8")
    tq = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    qmodel = model.with_config(tq)
    toks = np.random.default_rng(0).integers(0, 64, (2, 20)).astype(np.int32)
    apply = jax.jit(lambda t, c: JT.TransformerLM(jq).apply({"params": params}, t, cache=c))
    jc = JD.init_cache(jq, 2, 32)
    tc = TD.init_cache(tq, 2, 32)
    with torch.no_grad():
        full = model(torch.from_numpy(toks).long()).numpy()
        for a, b in ((0, 12), (12, 17), (17, 18), (18, 19), (19, 20)):
            jl, jc = apply(jnp.asarray(toks[:, a:b]), jc)
            tl, tc = qmodel(torch.from_numpy(toks[:, a:b]).long(), cache=tc)
            assert _rel(tl.numpy(), jl) <= REL, (a, b)
            scale = np.abs(full).max()
            np.testing.assert_allclose(tl.numpy(), full[:, a:b], atol=0.05 * scale, rtol=0.05)
    for tl_, jl_ in zip(tc["layers"], jc["layers"]):
        for name in ("k", "v"):
            assert tl_[name].dtype == torch.int8 and jl_[name].dtype == jnp.int8
            assert np.abs(tl_[name].numpy().astype(int) - np.asarray(jl_[name], int)).max() <= 1
        for name in ("k_scale", "v_scale"):
            assert tl_[name].shape == (2, tq.kv_heads, 32)
            assert _rel(tl_[name].numpy(), jl_[name]) <= REL
