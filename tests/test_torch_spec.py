"""The port's speculative decoding against the JAX package's.

On the CPU in f32, from the same weights: the n-gram drafts and draft trees
equal JAX's; the verifiers on a top_k 1 distribution (where they are
deterministic) give JAX's tokens, accept counts and branch; the learned
drafter (``init_draft_params`` + ``build_draft_fn``) gives JAX's token ids;
a tree block under ``self_mask`` at tree-depth positions gives JAX's logits
within 1e-5 relative to the largest. Sampled verification draws from torch
generators, so it is held to JAX's contracts instead (tests/test_quant.py,
tests/test_spec_tree.py): the first emitted token's marginal equals plain
filtered sampling (chi-square), good drafts are accepted and bad ones are
not, and every token a sampled spec lane emits lies in its top-k support.
Greedy engine streams with linear spec, tree spec and the learned drafter
equal the JAX ``SlotEngine``'s and the port's own plain streams, with the
same accepted-draft counts; the engine's validation errors are JAX's.
Shapes: vocab 64, d_model 32, 4 heads, 2 layers, plus rope + GQA + window.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import decoding as JD
from distributed_tensorflow_tpu.models import transformer as JT
from distributed_tensorflow_tpu.serve.engine import SlotEngine as JaxEngine
from distributed_tensorflow_tpu_torch.models import decoding as TD
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import (
    model_from_tree,
    transformer_params_to_jax,
)
from distributed_tensorflow_tpu_torch.serve.engine import SlotEngine

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

REL = 1e-5
BASE = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, d_ff=64, max_seq_len=48)
CASES = {
    "learned": BASE,
    "rope_gqa_window": dict(BASE, position="rope", rope_theta=500000.0, num_kv_heads=2,
                            attention_window=6),
}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def models():
    """name → (jcfg, params, tcfg, model); the port draws the weights."""
    out = {}
    for name, shape in CASES.items():
        tcfg = TT.TransformerConfig(**shape)
        params = transformer_params_to_jax(TT.TransformerLM(tcfg, seed=2, device="cpu"))
        out[name] = (JT.TransformerConfig(compute_dtype=jnp.float32, **shape), params, tcfg,
                     model_from_tree(tcfg, params, "cpu"))
    return out


def test_ngram_drafts_and_trees_equal_jax():
    rng = np.random.default_rng(0)
    hists = [[], [5], [3, 3], rng.integers(0, 6, 40).tolist(), rng.integers(0, 64, 25).tolist(),
             [1, 2, 3, 1, 2, 4, 1, 2, 3, 1, 2]]
    peers = [rng.integers(0, 6, 30).tolist(), [1, 2, 9, 9, 1, 2, 7]]
    for h in hists:
        for k in (1, 3, 4):
            np.testing.assert_array_equal(TD.propose_ngram_drafts(h, k),
                                          JD.propose_ngram_drafts(h, k))
            for b in (1, 3):
                np.testing.assert_array_equal(
                    TD.propose_ngram_tree(h, k, b, extra_histories=peers),
                    JD.propose_ngram_tree(h, k, b, extra_histories=peers))


def _top1(logits):
    n = logits.shape[0]
    args = (np.ones(n, np.float32), np.ones(n, np.int32), np.zeros(n, np.float32))
    return np.asarray(JD.filter_logits_batched(jnp.asarray(logits), *map(jnp.asarray, args)))


def test_verify_rows_on_a_point_mass_equal_jax():
    """With top_k 1 every accept test and draw is decided: the port's
    linear and tree verifiers give JAX's emitted tokens (up to the one after
    the accepted drafts; the rest are junk either engine discards), accepts
    and branch (all accepted, a rejection midway, every root rejected,
    duplicates)."""
    rng = np.random.default_rng(1)
    jlin = jax.jit(JD.rejection_verify_row)
    jtree = jax.jit(JD.tree_rejection_verify_row)
    for trial in range(6):
        filt = _top1(rng.standard_normal((5, 16)).astype(np.float32))
        best = filt.argmax(-1)
        drafts = best[:4].copy()
        drafts[trial % 5:] = (drafts[trial % 5:] + 1) % 16  # the first miss at trial % 5
        want_e, want_a = jlin(jnp.asarray(filt), jnp.asarray(drafts, jnp.int32), 3, trial)
        got_e, got_a = TD.rejection_verify_row(torch.tensor(filt), drafts, 3, trial)
        assert got_a == int(want_a)
        np.testing.assert_array_equal(got_e[: got_a + 1].numpy(), np.asarray(want_e)[: got_a + 1])
        b, d = 3, 3
        tfilt = _top1(rng.standard_normal((1 + b * d, 16)).astype(np.float32))
        tbest = tfilt.argmax(-1)
        tree = rng.integers(0, 16, (b, d)).astype(np.int32)
        if trial % 3:  # a branch that follows the target some way
            win = trial % b
            tree[win, 0] = tbest[0]
            tree[win, 1] = tbest[1 + win * d]
            tree[(win + 1) % b] = tree[win]  # a duplicate root
        want = jtree(jnp.asarray(tfilt), jnp.asarray(tree), 5, trial)
        got = TD.tree_rejection_verify_row(torch.tensor(tfilt), tree, 5, trial)
        assert (got[1], got[2]) == (int(want[1]), int(want[2]))
        np.testing.assert_array_equal(got[0][: got[1] + 1].numpy(),
                                      np.asarray(want[0])[: got[1] + 1])


@pytest.mark.parametrize("name", sorted(CASES))
def test_learned_drafter_equals_jax(models, name):
    """``init_draft_params`` keeps JAX's leaves; ``build_draft_fn`` rolls the
    same greedy tokens from windows at absolute positions (clamped at the
    end of the table)."""
    jcfg, params, tcfg, model = models[name]
    want_tree = JD.init_draft_params(jcfg, params, 1)
    draft = TD.init_draft_params(tcfg, model, 1)
    assert draft.cfg == TD.make_draft_config(tcfg, 1)
    got_tree = transformer_params_to_jax(draft)
    assert sorted(got_tree) == sorted(want_tree)
    for key in want_tree:
        jax.tree_util.tree_map(np.testing.assert_array_equal, got_tree[key], want_tree[key])
    k, w = 3, 8
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 64, (4, w)).astype(np.int32)
    lens = np.array([8, 3, 1, 6], np.int32)
    pos0 = np.array([0, 20, 44, 5], np.int32)  # row 2 runs past the table: clamped
    want = jax.jit(JD.build_draft_fn(JD.make_draft_config(jcfg, 1), k, w))(
        want_tree, toks, lens, pos0)
    got = TD.build_draft_fn(draft.cfg, k, w)(draft, toks, lens, pos0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tree_mask(b, d):
    n = 1 + b * d
    anc = np.zeros((n, n), bool)
    anc[:, 0] = True
    for br in range(b):
        for j in range(d):
            r = 1 + br * d + j
            anc[r, 1 + br * d: r + 1] = True
    depth = np.concatenate([[0], 1 + np.tile(np.arange(d), b)]).astype(np.int32)
    return anc, depth


@pytest.mark.parametrize("position", ["learned", "rope"])
def test_tree_block_logits_match_jax(models, position):
    """A 10-token prefix, then a 3 x 3 draft tree fed in write order under
    the ancestor mask at tree-depth positions: JAX's logits within REL,
    and each branch's logits those of its chain fed alone."""
    jcfg, params, tcfg, _ = models["learned"]
    if position == "rope":
        jcfg, params, tcfg, _ = models["rope_gqa_window"]
        jcfg = dataclasses.replace(jcfg, attention_window=None)
        tcfg = dataclasses.replace(tcfg, attention_window=None)
    model = model_from_tree(tcfg, params, "cpu")
    anc, depth = _tree_mask(3, 3)
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, 64, (1, 10)).astype(np.int32)
    block = rng.integers(0, 64, (1, 10)).astype(np.int32)
    apply = jax.jit(lambda t, c, pos, m: JT.TransformerLM(jcfg).apply(
        {"params": params}, t, cache=c, positions=pos, self_mask=m))
    jc = JD.init_cache(jcfg, 1, 32)
    _, jc = jax.jit(lambda t, c: JT.TransformerLM(jcfg).apply(
        {"params": params}, t, cache=c))(jnp.asarray(prefix), jc)
    want, _ = apply(jnp.asarray(block), jc, jnp.asarray(10 + depth)[None], jnp.asarray(anc))
    with torch.no_grad():
        tc = TD.init_cache(tcfg, 1, 32)
        _, tc = model(torch.from_numpy(prefix).long(), cache=tc)
        got, _ = model(torch.from_numpy(block).long(), cache=tc,
                       positions=torch.from_numpy(10 + depth)[None], self_mask=torch.from_numpy(anc))
        assert _rel(got.numpy(), want) <= REL
        for br in range(3):  # branch br alone, as a chain after the prefix
            chain = np.concatenate([block[:, :1], block[:, 1 + 3 * br: 4 + 3 * br]], 1)
            full = model(torch.from_numpy(np.concatenate([prefix, chain], 1)).long())
            rows = [0] + [1 + 3 * br + j for j in range(3)]
            assert _rel(got[0, rows].numpy(), full[0, 10:].numpy()) <= REL


def _first_token_counts(verify, n):
    return np.bincount([int(verify(seed)[0][0]) for seed in range(n)], minlength=12)


@pytest.mark.parametrize("drafts", ["greedy", "adversarial"])
def test_verify_marginal_equals_plain_sampling(drafts):
    """tests/test_quant.py's chi-square on the first emitted token, linear
    and tree: whatever the drafts, the marginal is the filtered target's."""
    vocab, k, n = 12, 3, 6000
    rng = np.random.default_rng(13)
    logits = torch.from_numpy((1.5 * rng.standard_normal((1 + 2 * k, vocab))).astype(np.float32))
    m = logits.shape[0]
    filt = TD.filter_logits_batched(logits, torch.full((m,), 0.9), torch.full((m,), 8),
                                    torch.full((m,), 0.95))
    pick = torch.argmax if drafts == "greedy" else torch.argmin
    lin = pick(filt[:k], dim=-1)
    tree = torch.stack([pick(filt[[0, 1, 2]], -1), pick(filt[[0, 4, 5]], -1)])
    tree[1, 0] = torch.argsort(filt[0], descending=drafts == "greedy")[1]  # a second root
    p = torch.softmax(filt[0], -1).numpy()
    for counts in (_first_token_counts(lambda s: TD.rejection_verify_row(filt[: k + 1], lin, s, 0), n),
                   _first_token_counts(lambda s: TD.tree_rejection_verify_row(filt, tree, s, 0), n)):
        expected = p * n
        mask = expected > 5
        assert counts[~mask].sum() <= n * 0.01
        chi2 = float(((counts[mask] - expected[mask]) ** 2 / expected[mask]).sum())
        assert chi2 < 35.0, (drafts, chi2)


def test_good_drafts_are_accepted_and_bad_ones_not():
    vocab, k = 12, 3
    peaked = torch.full((k + 1, vocab), -8.0)
    peaked[torch.arange(k + 1), torch.arange(k + 1)] = 8.0
    good, bad = torch.arange(k), torch.arange(k) + 5
    acc = lambda d: np.mean([TD.rejection_verify_row(peaked, d, s, 0)[1] for s in range(200)])
    assert acc(good) > 2.9 and acc(bad) < 0.1
    tree = torch.stack([bad, good])  # the good path on branch 1
    peaked_tree = torch.full((1 + 2 * k, vocab), -8.0)
    for r, t in enumerate([0, 5, 6, 7, 1, 2, 3]):
        peaked_tree[r, t] = 8.0
    runs = [TD.tree_rejection_verify_row(peaked_tree, tree, s, 0) for s in range(200)]
    assert np.mean([a for _, a, _ in runs]) > 2.9 and all(b == 1 for _, _, b in runs)


def _requests():
    rng = np.random.default_rng(7)
    fam = rng.integers(1, 64, 20).tolist()
    rep = [4, 9, 4, 9, 4, 9, 4, 9]  # repeats give the n-gram drafter hits
    prompts = ([fam + rng.integers(1, 64, int(t)).tolist() for t in (2, 4)]
               + [rep + rng.integers(1, 64, 3).tolist(), rng.integers(1, 64, 9).tolist(),
                  rng.integers(1, 64, 17).tolist()])
    return [(p, {"max_new_tokens": b}) for p, b in zip(prompts, (9, 12, 14, 7, 10))]


def _drive(engine, reqs, warm=True):
    """The closed-loop driver; ``engine.run_stats`` gets the stats this run
    added (warmup's excluded)."""
    if warm:
        engine.warmup()
    base = engine.compile_count()
    before = dict(engine.stats)
    outs, pending, live = {}, list(range(len(reqs))), {}
    while pending or live:
        while pending and (slot := engine.acquire_slot()) is not None:
            i = pending.pop(0)
            first, done = engine.start(slot, reqs[i][0], **reqs[i][1])
            outs[i] = [first]
            if done:
                engine.release(slot)
            else:
                live[slot] = i
        toks, valid, done = engine.step()
        for k in range(toks.shape[0]):
            for slot, i in live.items():
                if valid[k, slot]:
                    outs[i].append(int(toks[k, slot]))
        for slot in [s for s in live if done[s]]:
            engine.release(slot)
            del live[slot]
    if warm:
        assert engine.compile_count() == base, "a program signature was first run after warmup"
        assert engine.pool.pages_free + len(engine.prefix or ()) == engine.pool.num_pages - 1
    engine.run_stats = {k: v - before[k] for k, v in engine.stats.items()}
    return outs


KW = dict(slots=3, max_len=48, prefill_len=32, page_size=16)
SPEC = {"linear_k4": dict(spec_k=4), "tree_k3_b3": dict(spec_k=3, spec_branches=3),
        "drafter_k4_w8": dict(spec_k=4, draft_window=8)}


@pytest.fixture(scope="module")
def plain_streams(models):
    _, _, tcfg, model = models["learned"]
    return _drive(SlotEngine(tcfg, model, device="cpu", **KW), _requests())


@pytest.mark.parametrize("name", sorted(SPEC))
def test_greedy_spec_streams_equal_jax_and_plain(models, plain_streams, name):
    jcfg, params, tcfg, model = models["learned"]
    spec = dict(SPEC[name])
    jkw = tkw = {}
    if name.startswith("drafter"):
        jkw = dict(draft_params=JD.init_draft_params(jcfg, params, 1),
                   draft_cfg=JD.make_draft_config(jcfg, 1))
        draft = TD.init_draft_params(tcfg, model, 1)
        tkw = dict(draft_params=draft, draft_cfg=draft.cfg)
    jax_engine = JaxEngine(jcfg, params, **KW, **spec, **jkw)
    want = _drive(jax_engine, _requests(), warm=False)
    engine = SlotEngine(tcfg, model, device="cpu", **KW, **spec, **tkw)
    got = _drive(engine, _requests())
    assert got == want == plain_streams
    for key in ("spec_drafts_accepted", "spec_drafts_proposed", "spec_verifies", "spec_rounds",
                "plain_rounds"):
        assert engine.run_stats[key] == jax_engine.run_stats[key], key
    assert engine.run_stats["spec_drafts_accepted"] > 0
    assert engine.drafter == jax_engine.drafter


@pytest.mark.parametrize("name", ["linear_k4", "tree_k3_b3"])
def test_sampled_spec_lanes_stay_in_their_support(models, name):
    """Sampled lanes take the rejection verify: each emitted token is inside
    the top-k support of the logits at its position, and a lane's stream is
    a function of its seed, whatever shares the batch."""
    _, _, tcfg, model = models["learned"]
    reqs = [(p, dict(kw, temperature=1.0, top_k=4, seed=i)) for i, (p, kw) in
            enumerate(_requests())]
    engine = SlotEngine(tcfg, model, device="cpu", **KW, **SPEC[name])
    outs = _drive(engine, reqs)
    assert engine.stats["spec_rounds_sampled"] > 0
    alone = _drive(SlotEngine(tcfg, model, device="cpu", **KW, **SPEC[name]), reqs[1:2])
    assert alone[0] == outs[1]
    with torch.no_grad():
        for (prompt, _), toks in zip(reqs, (outs[i] for i in range(len(reqs)))):
            logits = model(torch.tensor([prompt + toks[:-1]]))[0, len(prompt) - 1:]
            top = torch.topk(logits, 4, dim=-1).indices
            assert all(t in top[i].tolist() for i, t in enumerate(toks))


def test_engine_validation_errors_are_jax(models):
    jcfg, params, tcfg, model = models["learned"]
    wcfg_j, _, wcfg_t, wmodel = models["rope_gqa_window"]
    draft = TD.init_draft_params(tcfg, model, 1)
    jdraft = JD.init_draft_params(jcfg, params, 1)
    other_vocab = dataclasses.replace(draft.cfg, vocab_size=32)
    short = dataclasses.replace(draft.cfg, max_seq_len=4)
    cases = [
        (dict(spec_k=-1), {}, {}),
        (dict(spec_k=2, page_size=0), {}, {}),
        (dict(spec_k=2, spec_branches=0), {}, {}),
        (dict(spec_branches=2), {}, {}),
        (dict(spec_k=8, spec_branches=6), {}, {}),
        (dict(draft_params=True), dict(draft_params=jdraft), dict(draft_params=draft)),
        (dict(spec_k=2), dict(draft_params=jdraft), dict(draft_params=draft)),
        (dict(spec_k=2), dict(draft_params=jdraft, draft_cfg=dataclasses.replace(
            JD.make_draft_config(jcfg, 1), vocab_size=32)),
         dict(draft_params=draft, draft_cfg=other_vocab)),
        (dict(spec_k=4), dict(draft_params=jdraft, draft_cfg=dataclasses.replace(
            JD.make_draft_config(jcfg, 1), max_seq_len=4)),
         dict(draft_params=draft, draft_cfg=short)),
    ]
    for kw, jkw, tkw in cases:
        kw = {k: v for k, v in kw.items() if k != "draft_params"}
        with pytest.raises(ValueError) as want:
            JaxEngine(jcfg, params, max_len=48, **kw, **jkw)
        with pytest.raises(ValueError) as got:
            SlotEngine(tcfg, model, max_len=48, device="cpu", **kw, **tkw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        JaxEngine(wcfg_j, params, max_len=48, spec_k=2, spec_branches=2)
    with pytest.raises(ValueError) as got:
        SlotEngine(wcfg_t, wmodel, max_len=48, device="cpu", spec_k=2, spec_branches=2)
    assert str(got.value) == str(want.value)
