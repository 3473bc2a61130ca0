"""The port's blockwise attention, its model entry points and the ring's hop
count against the JAX package's, on the CPU.

  * ``blockwise_attention`` values and q/k/v gradients against the JAX
    ``blockwise_attention`` (its scan differentiated by JAX) on the same
    numpy inputs: causal and not, a window, q/kv offsets, end-aligned
    cross-length, and a block that does not divide S; f32, within 2e-6 of
    the largest value (outputs) and 5e-6 (gradients);
  * ``TransformerLM(attention="blockwise")`` logits against the JAX model's
    on the same weights (learned positions and rope + GQA + window), and on
    a sequence shard at its global positions (``positions=``): 2e-5;
  * ``ring_hops`` equal to the JAX ring's traced scan length
    (tests/test_window_ring.py's hop counts on the 8-way mesh);
  * in a world of one the ring is one hop: sp's step equals dp's and
    sp_tp's equals tp's, loss for loss (1e-4: the ring's dense block
    against flash's plain version, three Adam steps);
  * a fully masked row outputs 0 and passes no NaN back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_tensorflow_tpu.models import transformer as JT
from distributed_tensorflow_tpu.ops import attention as JA
from distributed_tensorflow_tpu.parallel.mesh import make_mesh
from distributed_tensorflow_tpu.parallel.ring_attention import ring_attention as jax_ring
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import transformer_params_to_jax
from distributed_tensorflow_tpu_torch.ops import attention as TA
from distributed_tensorflow_tpu_torch.parallel import sequence_parallel as tsp
from distributed_tensorflow_tpu_torch.parallel import tensor_parallel as ttp
from distributed_tensorflow_tpu_torch.parallel import three_d as ttd
from distributed_tensorflow_tpu_torch.parallel.data_parallel import build_lm_train_step
from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_tpu_torch.parallel.ring_attention import ring_attention, ring_hops
from distributed_tensorflow_tpu_torch.train.optimizers import make_optimizer

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

OUT_TOL, GRAD_TOL = 2e-6, 5e-6  # relative to the largest reference value (f32)

# (sq, skv, causal, window, q_offset, kv_offset, block_kv)
CASES = {
    "causal": (24, 24, True, None, None, 0, 8),
    "non_causal": (24, 24, False, None, None, 0, 8),
    "window": (24, 24, True, 5, None, 0, 8),
    "offsets": (12, 20, True, None, 30, 22, 6),
    "end_aligned_cross_length": (8, 24, True, 6, None, 0, 7),
    "block_not_dividing": (24, 24, True, None, None, 0, 10),
}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", CASES)
def test_blockwise_values_and_grads_match_jax(case):
    sq, skv, causal, window, q_off, kv_off, bk = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q, g = (rng.standard_normal((2, 3, sq, 16)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, 3, skv, 16)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, block_kv=bk, q_offset=q_off, kv_offset=kv_off, window=window)
    out, vjp = jax.vjp(jax.jit(lambda *a: JA.blockwise_attention(*a, **kw)), q, k, v)
    want = (out, *vjp(g))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = TA.blockwise_attention(tq, tk, tv, **kw)
    got.backward(torch.from_numpy(g))
    assert _rel(got.detach(), want[0]) <= OUT_TOL
    for name, t, w in zip("qkv", (tq, tk, tv), want[1:]):
        assert _rel(t.grad, w) <= GRAD_TOL, name


def test_fully_masked_rows_output_zero_and_finite_grads():
    """q rows before every key (q_offset below kv_offset) see nothing: the
    guard keeps them 0, and their gradient 0, not NaN."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.tensor(rng.standard_normal((1, 2, 8, 8)), dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    out = TA.blockwise_attention(q, k, v, causal=True, block_kv=4, q_offset=0, kv_offset=4)
    out.sum().backward()
    assert torch.equal(out[:, :, :4], torch.zeros_like(out[:, :, :4]))
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    assert torch.equal(q.grad[:, :, :4], torch.zeros_like(q.grad[:, :, :4]))


SHAPE = dict(vocab_size=32, d_model=32, num_heads=4, num_layers=2, d_ff=64, max_seq_len=24)
MODELS = {
    "learned": dict(SHAPE),
    "rope_gqa_window": dict(SHAPE, position="rope", num_kv_heads=2, attention_window=7),
}


@pytest.mark.parametrize("name", MODELS)
def test_blockwise_model_logits_match_jax(name):
    """The whole sequence, and its second half as a shard at its global
    positions (``positions=``, as a sequence shard embeds them), each
    against the JAX model's apply with the same positions."""
    kw = MODELS[name]
    model = TT.TransformerLM(TT.TransformerConfig(attention="blockwise", **kw), device="cpu")
    tokens = np.random.default_rng(2).integers(0, 32, (2, 24)).astype(np.int32)
    jcfg = JT.TransformerConfig(attention="blockwise", compute_dtype=jnp.float32, **kw)
    apply = jax.jit(lambda p, t, pos: JT.TransformerLM(jcfg).apply({"params": p}, t,
                                                                   positions=pos))
    params = transformer_params_to_jax(model)
    pos = np.broadcast_to(np.arange(12, 24, dtype=np.int32), (2, 12))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
        shard = model(torch.from_numpy(tokens[:, 12:]).long(), positions=torch.arange(12, 24))
    assert _rel(got, apply(params, tokens, np.broadcast_to(np.arange(24), (2, 24)))) <= 2e-5
    assert _rel(shard, apply(params, tokens[:, 12:], pos)) <= 2e-5


def _scan_lengths(closed_jaxpr):
    """Every lax.scan trip count in a jaxpr, nested bodies included."""
    lengths = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "scan":
                lengths.append(eqn.params["length"])
            for val in eqn.params.values():
                if hasattr(val, "jaxpr"):
                    walk(val.jaxpr)
                elif hasattr(val, "eqns"):
                    walk(val)

    walk(closed_jaxpr.jaxpr)
    return lengths


@pytest.mark.parametrize("window,hops", [(None, 8), (1, 1), (8, 2), (17, 3), (100, 8)])
def test_ring_hops_match_the_jax_scan(window, hops):
    """tests/test_window_ring.py's counts: s_local 8 on an 8-way mesh."""
    mesh = make_mesh(num_devices=8)
    fn = jax.shard_map(
        lambda q, k, v: jax_ring(q, k, v, axis_name="data", causal=True, window=window),
        mesh=mesh, in_specs=(P(None, None, "data", None),) * 3,
        out_specs=P(None, None, "data", None), check_vma=False)
    x = jnp.zeros((1, 1, 64, 8), jnp.float32)
    (length,) = _scan_lengths(jax.make_jaxpr(fn)(x, x, x))
    assert ring_hops(8, 8, window) == length == hops


def test_ring_of_one_is_blockwise_of_one_block():
    rng = np.random.default_rng(4)
    q, k, v = (torch.tensor(rng.standard_normal((1, 2, 16, 8)), dtype=torch.float32)
               for _ in range(3))
    for window in (None, 5):
        got = ring_attention(q, k, v, causal=True, window=window)
        want = TA.blockwise_attention(q, k, v, causal=True, block_kv=16, window=window)
        assert torch.equal(got, want)
        assert _rel(got, TA.dense_attention(q, k, v, causal=True, window=window)) <= 1e-6


@pytest.mark.parametrize("position", ["learned", "rope"])
def test_sp_and_sp_tp_in_a_world_of_one_take_dp_and_tp_steps(position):
    cfg = TT.TransformerConfig(attention="flash", position=position, num_kv_heads=2, **SHAPE)
    batches = [torch.from_numpy(np.random.default_rng(i).integers(0, 32, (2, 24)))
               for i in range(3)]

    def losses(model, build):
        opt = make_optimizer("adam", model.parameters(), 1e-2, total_steps=3)
        step = build(model, opt)
        return [float(step(t)["loss"]) for t in batches]

    dp = losses(TT.TransformerLM(cfg, device="cpu"), build_lm_train_step)
    sp = losses(tsp.make_sp_model(cfg, Mesh(), device="cpu"),
                lambda m, o: tsp.build_lm_train_step(m, o, Mesh()))
    tp = losses(ttp.TpTransformerLM(cfg, device="cpu"), ttp.build_tp_lm_train_step)
    sp_tp = losses(ttd.make_sp_tp_model(cfg, Mesh(), device="cpu"),
                   lambda m, o: ttd.build_sp_tp_lm_train_step(m, o, Mesh()))
    np.testing.assert_allclose(sp, dp, atol=1e-4, rtol=0)
    np.testing.assert_allclose(sp_tp, tp, atol=1e-4, rtol=0)
    assert dp[-1] != dp[0]  # the weights moved


def test_config_takes_blockwise_and_a_callable():
    TT.TransformerConfig(attention="blockwise")
    TT.TransformerConfig(attention=lambda q, k, v: q)
    with pytest.raises(ValueError, match="attention must be one of"):
        TT.TransformerConfig(attention="ring")
