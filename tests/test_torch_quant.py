"""The port's weight-only quantization against the JAX package's.

On the CPU in f32, from the same numpy-seeded weights: ``pack_int4``/
``unpack_int4`` and both quantizers give JAX's bits (a code may differ only
where an f32 division lands on the other side of a rounding tie: at most 1
in 10⁴); ``quantize_lm_params`` trees have JAX's names, shapes, dtypes and
bits (high-precision leaves kept, or bf16); ``QuantDense`` and the quantized
model's logits are within 1e-5 of JAX's, relative to the largest value, for
int8 and int4 at group 8; JAX's accuracy floors hold in the port (int8:
argmax agreement ≥ 0.95, loss delta ≤ 0.02; int4 group 8: ≥ 0.70, ≤ 0.40);
``cli/quantize_lm.py`` writes the JAX tool's bytes and a quantized bundle of
either package loads in the other bit for bit; the quantized engine's greedy
streams equal the JAX ``SlotEngine``'s, its weights stay quantized and
``weight_bytes_per_device`` equals ``tree_bytes`` of the quantized tree.
Shapes: vocab 64, d_model 32, 4 heads, 2 layers, plus rope + GQA + window.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from distributed_tensorflow_tpu.models import quant as JQ
from distributed_tensorflow_tpu.models import transformer as JT
from distributed_tensorflow_tpu.serve.engine import SlotEngine as JaxEngine
from distributed_tensorflow_tpu.train import checkpoint as JC
from distributed_tensorflow_tpu_torch.cli import quantize_lm as quant_cli
from distributed_tensorflow_tpu_torch.models import quant as TQ
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import (
    model_from_tree,
    transformer_params_to_jax,
)
from distributed_tensorflow_tpu_torch.serve.engine import SlotEngine
from distributed_tensorflow_tpu_torch.train import checkpoint as TC
from distributed_tensorflow_tpu_torch.utils.msgpack_state import Bfloat16Bits

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
MODES = [("int8", 0), ("int4", 8)]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _bits(leaf):
    """(dtype name, raw bytes) of a leaf of either package's tree."""
    if isinstance(leaf, Bfloat16Bits):
        return "bfloat16", np.asarray(leaf).view(np.uint16)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return "bfloat16", arr.view(np.uint16)
    return arr.dtype.name, arr


def _assert_trees_bit_equal(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for path in want:
        (gn, ga), (wn, wa) = _bits(got[path]), _bits(want[path])
        assert gn == wn and ga.shape == wa.shape, path
        np.testing.assert_array_equal(ga, wa, err_msg="/".join(path))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(name, jcfg, tcfg, params): the port draws the weights."""
    shape = CASES[request.param]
    tcfg = TT.TransformerConfig(**shape)
    params = transformer_params_to_jax(TT.TransformerLM(tcfg, seed=1, device="cpu"))
    return request.param, JT.TransformerConfig(compute_dtype=jnp.float32, **shape), tcfg, params


@pytest.fixture(scope="module")
def learned():
    """(jcfg, tcfg, params) of the learned-position model alone (the bundle
    and engine tests: the rope + GQA + window model is held at the layer
    and model level above)."""
    tcfg = TT.TransformerConfig(**BASE)
    params = transformer_params_to_jax(TT.TransformerLM(tcfg, seed=1, device="cpu"))
    return JT.TransformerConfig(compute_dtype=jnp.float32, **BASE), tcfg, params


def test_pack_and_quantizers_are_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    codes = rng.integers(-8, 8, (64, 24)).astype(np.int32)
    packed = TQ.pack_int4(codes)
    np.testing.assert_array_equal(packed, np.asarray(JQ.pack_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(TQ.unpack_int4(packed), codes)
    # The torch unpack (QuantDense's), and the re-cast of a float-cast array.
    np.testing.assert_array_equal(TQ.unpack_int4(torch.from_numpy(packed)).numpy(), codes)
    np.testing.assert_array_equal(TQ.unpack_int4(packed.astype(np.float32)), codes)
    w = (0.1 * rng.standard_normal((128, 96))).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column takes the 1e-8 floor
    for got, want in ((TQ.quantize_int8_channelwise(w), JQ.quantize_int8_channelwise(w)),
                      (TQ.quantize_int4_groupwise(w, 8), JQ.quantize_int4_groupwise(w, 8)),
                      (TQ.quantize_int4_groupwise(w, 64), JQ.quantize_int4_groupwise(w, 64))):
        (gq, gs), (wq, ws) = got, (np.asarray(want[0]), np.asarray(want[1]))
        assert gq.dtype == wq.dtype and gs.dtype == ws.dtype == np.float32
        np.testing.assert_array_equal(gs, ws)
        codes_g = TQ.unpack_int4(gq) if gq.dtype == np.uint8 else gq.astype(int)
        codes_w = TQ.unpack_int4(wq) if wq.dtype == np.uint8 else wq.astype(int)
        differ = int((codes_g != codes_w).sum())
        assert differ <= codes_w.size // 10_000, differ
        assert np.abs(codes_g - codes_w).max() <= 1
    q8, s8 = TQ.quantize_int8_channelwise(w)
    np.testing.assert_array_equal(TQ.dequantize_int8(q8, s8),
                                  np.asarray(JQ.dequantize_int8(q8, s8)))
    q4, s4 = TQ.quantize_int4_groupwise(w, 8)
    np.testing.assert_array_equal(TQ.dequantize_int4(q4, s4, 8),
                                  np.asarray(JQ.dequantize_int4(q4, s4, 8)))


@pytest.mark.parametrize("mode,gs", MODES)
def test_trees_layers_and_logits_match_jax(case, mode, gs):
    """The quantized trees (high-precision leaves kept, and in bf16) equal
    JAX's bit for bit; one ``QuantDense`` and the whole model, loaded from
    them, give JAX's outputs within REL; ``dequantize_lm_params`` equals
    JAX's."""
    name, jcfg, tcfg, params = case
    jq = dataclasses.replace(jcfg, weight_dtype=mode, quant_group_size=gs)
    tq = dataclasses.replace(tcfg, weight_dtype=mode, quant_group_size=gs)
    toks = np.random.default_rng(2).integers(0, 64, (2, 16)).astype(np.int32)
    x = np.random.default_rng(3).standard_normal((2, 5, 32)).astype(np.float32)
    # The JAX model and layer jitted (one program each, not an eager compile
    # per op); its quantizer eager, as tools/quantize_lm.py runs it (under
    # jit XLA may divide by multiplying with the reciprocal).
    apply = jax.jit(lambda p, t: JT.TransformerLM(jq).apply({"params": p}, t))
    dense = jax.jit(lambda p, v: JQ.QuantDense(64, mode=mode, group_size=gs,
                                               dtype=jnp.float32).apply({"params": p}, v))
    kept = jax.device_get(JQ.quantize_lm_params(params, mode, group_size=gs, hp_dtype=None))
    # JAX's bf16 tree differs from it only where quantize_lm_params casts
    # the other float leaves with astype(hp_dtype): cast them the same way
    # (one eager JAX quantization a case, not two).
    quant = {path[:-1] for path, _ in _flat(kept) if path[-1] == "kernel_q"}
    to_bf16 = {}
    for path, leaf in _flat(kept):
        node = to_bf16
        for k in path[:-1]:
            node = node.setdefault(k, {})
        coded = path[:-1] in quant and path[-1] in ("kernel_q", "scale", "gscale")
        node[path[-1]] = leaf if coded else np.asarray(leaf).astype(jnp.bfloat16)
    for hp, jtree in ((None, kept), ("bfloat16", to_bf16)):
        tree = TQ.quantize_lm_params(params, mode, group_size=gs, hp_dtype=hp)
        _assert_trees_bit_equal(tree, jtree)
        assert TQ.tree_bytes(tree) == JQ.tree_bytes(jtree)
        model = model_from_tree(tq, tree, "cpu")
        _assert_trees_bit_equal(transformer_params_to_jax(model), jtree)  # held as stored
        with torch.no_grad():
            got = model(torch.from_numpy(toks).long()).numpy()
            layer = model.block_0.mlp_in(torch.from_numpy(x)).numpy()
        want = apply(jtree, jnp.asarray(toks))
        assert _rel(got, want) <= REL, (hp, _rel(got, want))
        assert _rel(layer, dense(jtree["block_0"]["mlp_in"], jnp.asarray(x))) <= REL
        _assert_trees_bit_equal(TQ.dequantize_lm_params(tree, mode, gs), jax.device_get(
            jax.jit(lambda p: JQ.dequantize_lm_params(p, mode, gs))(jtree)))


@pytest.mark.parametrize("mode,gs,min_agree,max_xent_delta",
                         [("int8", 0, 0.95, 0.02), ("int4", 8, 0.70, 0.40)])
def test_accuracy_floors_hold(case, mode, gs, min_agree, max_xent_delta):
    """JAX's floors (tests/test_quant.py) on the port's own models: argmax
    agreement with the unquantized model and the eval-loss delta."""
    _, _, tcfg, params = case
    native = model_from_tree(tcfg, params, "cpu")
    tq = dataclasses.replace(tcfg, weight_dtype=mode, quant_group_size=gs)
    quant = model_from_tree(tq, TQ.quantize_lm_params(params, mode, gs, hp_dtype=None), "cpu")
    batch = torch.from_numpy(np.random.default_rng(5).integers(1, 64, (8, 32)))
    with torch.no_grad():
        ref, got = native(batch), quant(batch)
    agree = float((ref.argmax(-1) == got.argmax(-1)).float().mean())
    assert agree >= min_agree, agree
    delta = abs(float(TT.next_token_loss(got, batch)) - float(TT.next_token_loss(ref, batch)))
    assert delta <= max_xent_delta, delta


@pytest.mark.parametrize("mode,gs", MODES)
def test_bundles_both_ways(tmp_path, learned, mode, gs):
    """``cli/quantize_lm.py`` writes the JAX tool's bytes (target and int4
    drafter); the JAX loader reads the port's bundle and the port's loader
    JAX's, bit for bit, with the quantization in the config."""
    import tools.quantize_lm as jax_tool

    _, _, params = learned
    meta = {"model": "TransformerLM", "parallelism": "dp", "config": {
        "vocab_size": 64, "d_model": 32, "num_heads": 4, "num_kv_heads": 0,
        "attention_window": 0, "use_bias": 1, "rope": 0, "rope_theta": 10000.0,
        "num_layers": 2, "d_ff": 64, "max_seq_len": 48}}
    src = str(tmp_path / "lm.msgpack")
    TC.export_inference_bundle(src, params, metadata=meta)
    ours, theirs = str(tmp_path / "port.msgpack"), str(tmp_path / "jax.msgpack")
    flags = ["--model", src, "--mode", mode, "--group_size", str(gs)]
    draft = ["--draft_model", src, "--draft_group_size", "16"]
    assert quant_cli.main([*flags, "--out", ours, *draft, "--draft_out", ours + ".draft"]) == 0
    jax_tool.main([*flags, "--out", theirs, *draft, "--draft_out", theirs + ".draft"])
    for a, b in ((ours, theirs), (ours + ".draft", theirs + ".draft")):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a
    cfg, model, got_meta = TC.load_lm_bundle(theirs, device="cpu")
    assert (cfg.weight_dtype, cfg.quant_group_size) == (mode, gs)
    jcfg_b, jparams, _ = JC.load_lm_bundle(ours)
    assert (jcfg_b.weight_dtype, jcfg_b.quant_group_size) == (mode, gs)
    _assert_trees_bit_equal(transformer_params_to_jax(model),
                            serialization.to_state_dict(jax.device_get(jparams)))
    assert got_meta["quantized_from"] == "lm.msgpack"


def _requests():
    rng = np.random.default_rng(11)
    fam = rng.integers(1, 64, 20).tolist()
    prompts = ([fam + rng.integers(1, 64, int(t)).tolist() for t in (2, 5)]
               + [rng.integers(1, 64, int(n)).tolist() for n in (3, 9, 17)])
    return [(p, {"max_new_tokens": b}) for p, b in zip(prompts, (7, 9, 12, 5, 8))]


def _drive(engine, reqs, warm):
    if warm:
        engine.warmup()
    base = engine.compile_count()
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
        assert engine.compile_count() == base
    return outs


@pytest.mark.parametrize("mode,gs", MODES)
def test_quantized_engine_matches_jax(learned, mode, gs):
    """Greedy churn through both engines on one quantized tree (bf16 high-
    precision leaves): the same streams; the port's layers stay quantized
    under ``hold_compute_weights`` and its weight bytes are the tree's."""
    jcfg, tcfg, params = learned
    tree = TQ.quantize_lm_params(params, mode, gs)
    jtree = JQ.quantize_lm_params(params, mode, gs)
    jq = dataclasses.replace(jcfg, weight_dtype=mode, quant_group_size=gs)
    tq = dataclasses.replace(tcfg, weight_dtype=mode, quant_group_size=gs)
    kw = dict(slots=3, max_len=48, prefill_len=32, page_size=16)
    want = _drive(JaxEngine(jq, jtree, **kw), _requests(), warm=False)
    engine = SlotEngine(tq, model_from_tree(tq, tree, "cpu"), device="cpu", **kw)
    assert _drive(engine, _requests(), warm=True) == want
    assert isinstance(engine.model.block_0.qkv, TQ.QuantDense)
    assert engine.weight_dtype == mode and engine.draft_weight_dtype == ""
    assert engine.weight_bytes_per_device == TQ.tree_bytes(tree)
    bf16 = dataclasses.replace(tq, compute_dtype=torch.bfloat16)
    held = SlotEngine(bf16, model_from_tree(bf16, tree, "cpu"), device="cpu", **kw)
    assert held.model.block_0.qkv.kernel_q.dtype == (torch.int8 if mode == "int8" else torch.uint8)
    assert held.weight_bytes_per_device == TQ.tree_bytes(tree)
