"""The port's SlotEngine against the JAX package's, on the CPU in f32.

From the same flax weights (through the converter), the churn workloads of
tests/test_serve_engine.py and tests/test_paged_kv.py — mixed prompt and
output lengths, two shared-prefix families, eos and budget truncation —
run through both engines under the same closed-loop driver. In every
configuration the greedy token streams are identical, ``pages_free`` and
``prefix_hit_rate`` are equal before every step, and the port's
``compile_count`` (distinct program signatures) is flat after warmup. The
configurations cover the monolithic layout and page size 16, prefix
adoption on and off, two bucket sets, chunked prefill at two widths,
``steps_per_sync`` 1 and 4, and a rope + GQA + window model. Each JAX
engine is built once per module and runs without warmup; sampled decoding is held to the port's
own contracts (seed determinism, top_k 1 equal to greedy, draws inside the
top-k support).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import transformer as JT
from distributed_tensorflow_tpu.serve.engine import SlotEngine as JaxEngine
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import transformer_params_from_jax
from distributed_tensorflow_tpu_torch.obs.perf import RecompileSentinel
from distributed_tensorflow_tpu_torch.obs.registry import MetricsRegistry
from distributed_tensorflow_tpu_torch.serve.engine import SlotEngine
from distributed_tensorflow_tpu_torch.serve.kv_pool import InsufficientPages

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

BASE = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, d_ff=64, max_seq_len=48)
MODELS = {
    "learned": BASE,
    "rope_gqa_window": dict(BASE, position="rope", rope_theta=500000.0, num_kv_heads=2,
                            attention_window=6),
}
# (model, engine kwargs): every layout, bucket, chunk and steps_per_sync case.
CONFIGS = {
    "monolithic": ("learned", dict(page_size=0, prefill_len=40)),
    "paged16_prefix_buckets8_chunk16_sync4": (
        "learned", dict(page_size=16, prefill_len=32, prefill_buckets=(8,),
                        prefill_chunk_tokens=16, steps_per_sync=4)),
    "paged16_noprefix_buckets4_12_chunk12_rope": (
        "rope_gqa_window", dict(page_size=16, prefix_cache=False, prefill_len=24,
                                prefill_buckets=(4, 12), prefill_chunk_tokens=12)),
}


def _models():
    out = {}
    for name, shape in MODELS.items():
        jcfg = JT.TransformerConfig(compute_dtype=jnp.float32, **shape)
        params = jax.device_get(JT.TransformerLM(jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
        tcfg = TT.TransformerConfig(compute_dtype=torch.float32, **shape)
        model = TT.TransformerLM(tcfg, device="cpu")
        model.load_state_dict(transformer_params_from_jax(params))
        out[name] = (jcfg, params, tcfg, model)
    return out


def _requests(eos_from=None):
    """tests/test_paged_kv.py's churn: two shared-prefix families and
    disjoint prompts, mixed budgets; with ``eos_from`` (a greedy run's
    streams), every third request stops at a token from mid-stream."""
    rng = np.random.default_rng(7)
    fam_a = rng.integers(1, 64, 20).tolist()
    fam_b = rng.integers(1, 64, 12).tolist()
    prompts = ([fam_a + rng.integers(1, 64, int(t)).tolist() for t in (2, 4, 3)]
               + [fam_b + rng.integers(1, 64, int(t)).tolist() for t in (5, 2)]
               + [rng.integers(1, 64, int(n)).tolist() for n in (3, 9, 17, 23, 6, 30)]
               + [fam_a + rng.integers(1, 64, 17).tolist()])  # chunked, adopts a page
    budgets = [6, 9, 12, 5, 8, 14, 4, 7, 10, 3, 9, 11]
    reqs = []
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        kw = {"max_new_tokens": b}
        if eos_from is not None and i % 3 == 0 and len(eos_from[i]) > 2:
            kw["eos_id"] = eos_from[i][len(eos_from[i]) // 2]
        reqs.append((p, kw))
    return reqs


def _drive(engine, requests, warm=True):
    """Closed-loop driver: keeps every slot busy; returns the streams and a
    per-step trace of (pages_free, prefix_hit_rate); after ``warmup``,
    asserts the compile count never moves (the JAX engines skip warmup:
    only the programs the run needs compile)."""
    if warm:
        engine.warmup()
    base = engine.compile_count()
    outs, trace = {}, []
    pending = list(range(len(requests)))
    slot2req = {}
    while pending or slot2req:
        while pending:
            slot = engine.acquire_slot()
            if slot is None:
                break
            prompt, kwargs = requests[pending[0]]
            try:
                first, finished = engine.start(slot, prompt, **kwargs)
            except InsufficientPages:
                engine.release(slot)
                break
            i = pending.pop(0)
            outs[i] = [] if first is None else [first]
            if finished:
                engine.release(slot)
            else:
                slot2req[slot] = i
        trace.append((engine.pages_free, round(engine.prefix_hit_rate, 12)))
        toks, valid, done = engine.step()
        for k in range(toks.shape[0]):
            for slot, i in slot2req.items():
                if valid[k, slot]:
                    outs[i].append(int(toks[k, slot]))
        for slot in list(slot2req):
            if done[slot]:
                engine.release(slot)
                del slot2req[slot]
    if warm:
        assert engine.compile_count() == base, "a program signature was first run after warmup"
    return outs, trace


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def jax_runs(models):
    """One JAX engine per configuration: its streams and traces without,
    then with, eos (warmup clears the prefix cache between the two)."""
    runs = {}
    for name, (model_name, kw) in CONFIGS.items():
        jcfg, params, _, _ = models[model_name]
        engine = JaxEngine(jcfg, params, slots=4, max_len=48, **kw)
        plain = _drive(engine, _requests(), warm=False)
        if engine.prefix is not None:
            engine.prefix.clear()
            engine.prefix.tokens_matched = engine.prefix.tokens_looked_up = 0
        runs[name] = (plain, _drive(engine, _requests(eos_from=plain[0]), warm=False))
    return runs


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_churn_matches_the_jax_engine(name, models, jax_runs):
    model_name, kw = CONFIGS[name]
    _, _, tcfg, model = models[model_name]
    plain, with_eos = jax_runs[name]
    for want, reqs in ((plain, _requests()), (with_eos, _requests(eos_from=plain[0]))):
        engine = SlotEngine(tcfg, model, slots=4, max_len=48, device="cpu", **kw)
        got = _drive(engine, reqs)
        assert got[0] == want[0]  # token streams, eos and budget truncation included
        assert got[1] == want[1]  # pages_free and prefix_hit_rate before every step
        if engine.paged:
            if engine.prefix is not None:
                engine.prefix.clear()
            assert engine.pool.pages_free == engine.pool.num_pages - 1
    if kw.get("prefill_chunk_tokens"):
        assert engine.stats["prefill_chunks"] > 0  # the chunked path ran
    if kw.get("page_size") and kw.get("prefix_cache", True):
        assert want[1][-1][1] > 0  # adoption happened


def test_slot_reuse_is_isolated(models):
    """A slot that hosted a longer, different request gives the next one the
    tokens a fresh engine gives (stale keys above the length are masked)."""
    _, _, tcfg, model = models["learned"]
    probe = [5, 9, 2]
    kw = dict(slots=1, max_len=32, prefill_len=12, device="cpu")
    for layout in (dict(page_size=0), dict(page_size=16, prefix_cache=False)):
        want = _drive(SlotEngine(tcfg, model, **kw, **layout), [(probe, {"max_new_tokens": 5})])
        reused = SlotEngine(tcfg, model, **kw, **layout)
        noise = np.random.default_rng(2).integers(0, 64, 11).tolist()
        _drive(reused, [(noise, {"max_new_tokens": 12})])
        assert _drive(reused, [(probe, {"max_new_tokens": 5})])[0] == want[0]


def test_sampled_decoding_contracts(models):
    """Seed-deterministic whatever shares the batch, top_k 1 equal to
    greedy, every sampled token inside the top-k support of the logits at
    its position, and the sentinel's post-warmup count at 0."""
    _, _, tcfg, model = models["learned"]
    sampled = {"max_new_tokens": 6, "temperature": 1.0, "top_k": 5, "top_p": 0.9, "seed": 7}
    prompt = [2, 4, 6]

    def engine(sentinel=None):
        return SlotEngine(tcfg, model, slots=3, max_len=32, prefill_len=8, page_size=16,
                          steps_per_sync=2, device="cpu", sentinel=sentinel)

    sentinel = RecompileSentinel(MetricsRegistry())
    alone = _drive(engine(sentinel), [(prompt, dict(sampled))])[0][0]
    crowded = _drive(engine(), [(prompt, dict(sampled)),
                                ([1, 1, 1, 1], {"max_new_tokens": 8, "temperature": 2.0,
                                                "seed": 99}),
                                ([3, 3], {"max_new_tokens": 5})])[0]
    assert crowded[0] == alone
    assert sentinel.events_total > 0 and sentinel.post_warm_total == 0
    traced = engine()
    traced.warmup()
    traced.logit_trace = []
    greedy = _drive(traced, [(prompt, {"max_new_tokens": 6})], warm=False)[0][0]
    # The check hook: every pick with its index, token and logits row.
    assert [(i, tok) for _, i, tok, _ in traced.logit_trace] == list(enumerate(greedy))
    assert all(int(torch.argmax(lg)) == tok for _, _, tok, lg in traced.logit_trace)
    top1 = _drive(engine(), [(prompt, dict(sampled, top_k=1))])[0][0]
    assert top1 == greedy
    seq = prompt + alone
    with torch.no_grad():
        logits = model(torch.tensor([seq[:-1]]))[0]
    for i, tok in enumerate(alone):
        pos = len(prompt) - 1 + i
        assert tok in torch.topk(logits[pos], 5).indices.tolist(), (i, tok)


def test_engine_runs_on_the_card_unless_cpu_is_asked(models):
    _, _, tcfg, model = models["learned"]
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlotEngine(tcfg, model)
    assert SlotEngine(tcfg, model, device="cpu").device.type == "cpu"


def test_unported_engine_options_raise(models):
    _, _, tcfg, model = models["learned"]
    for kw in (dict(spec_k=4), dict(draft_params={}), dict(spec_branches=2)):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            SlotEngine(tcfg, model, device="cpu", **kw)
