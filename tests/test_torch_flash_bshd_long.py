"""The port's long-sequence backward family against the JAX package's.

The backward gate (``_fused_segment_rows`` and the scratch limit) picks the
same route on both sides: one fused call, the fused call per q segment (K8
on the packed long branch and on ``flash_attention_bshd``, K4 on
``flash_attention``), or the two-pass pair K5/K6. The same inputs, made
from a numpy seed, go through the JAX functions (their Pallas kernels in
interpret mode, blocks of 16, as tests/test_attention.py runs them) and
through the port on CPU tensors (the plain versions of the CUDA kernels);
both sides' gates are lowered together so that small shapes take the long
routes. Everything is f32; tolerance 1e-5 absolute, except where a test
names another.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import attention as JA
from distributed_tensorflow_tpu.ops import rope as JR
from distributed_tensorflow_tpu_torch.ops import attention as TA
from distributed_tensorflow_tpu_torch.ops import rope as TR

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

TOL = 1e-5
BLOCK = 16  # the JAX side's block_q/block_kv, and the port's gate block to match


@pytest.fixture
def gate(monkeypatch):
    """Set both packages' backward gate: the scratch limit in bytes, the
    block the port's gate fits (the JAX side's comes from its call), and
    optionally no segmentation at all (the two-pass route)."""
    monkeypatch.delenv("LIBTPU_INIT_ARGS", raising=False)

    def set_gate(limit, block=BLOCK, two_pass=False):
        for mod in (JA, TA):
            monkeypatch.setattr(mod, "_FUSED_BWD_SCRATCH_LIMIT", limit)
            if two_pass:
                monkeypatch.setattr(mod, "_fused_segment_rows", lambda *a: None)
        monkeypatch.setattr(TA, "_GATE_BLOCK", block)

    return set_gate


@pytest.fixture
def routes(monkeypatch):
    """Record each backward call the port makes: ("fused", counter, offset)
    or ("two_pass", offset)."""
    calls = []
    fused, two_pass = TA._backward, TA._backward_two_pass

    def spy_fused(counter, *args):
        calls.append(("fused", counter, args[11]))
        return fused(counter, *args)

    def spy_two_pass(*args, **kw):
        calls.append(("two_pass", args[11]))
        return two_pass(*args, **kw)

    monkeypatch.setattr(TA, "_backward", spy_fused)
    monkeypatch.setattr(TA, "_backward_two_pass", spy_two_pass)
    return calls


# The segment chooser on tests/test_attention.py's cases, plus the
# long-context call (seq 8192, head_dim 128) and the small shapes below.
SEGMENT_CASES = [(4096, 128, 1024), (16384, 128, 1024), (65536, 64, 1024), (8192, 128, 8192),
                 (12288, 128, 1024), (20480, 128, 3072), (8192, 128, 1024), (64, 16, 16),
                 (64, 8, 16), (2048, 8, 1024)]


@pytest.mark.parametrize("limit", [None, 4 * 1024 * 1024, 16 * 1024, 1024 * 1024])
def test_fused_segment_rows_matches_jax(gate, limit):
    gate(limit)
    assert TA._fused_bwd_scratch_limit() == JA._fused_bwd_scratch_limit()
    for sq, d, block in SEGMENT_CASES:
        assert TA._fit_block(block, sq) == JA._fit_block(block, sq, True), (sq, block)
        assert TA._fused_segment_rows(sq, d, block) == JA._fused_segment_rows(sq, d, block), \
            (sq, d, block)


def test_long_context_call_takes_four_segments(gate):
    """At the JAX defaults (2 MiB, block 1024) seq 8192 at head_dim 128 runs
    the fused backward on four q segments; seq 2048 fits one call."""
    gate(None, block=1024)
    assert TA._segment_rows(8192, 128) == 2048
    assert TA._segment_rows(2048, 128) == 2048


def _bshd_inputs(b, sq, skv, h, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, h, d)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, g


BSHD_CASES = {  # name -> (sq, skv, causal, window)
    "causal": (64, 64, True, None),
    "noncausal": (64, 64, False, None),
    "cross_16_32": (16, 32, True, None),
    "window": (64, 64, True, 8),
}


@pytest.mark.parametrize("case", sorted(BSHD_CASES))
def test_flash_attention_bshd_matches_jax(case):
    sq, skv, causal, window = BSHD_CASES[case]
    q, k, v, g = _bshd_inputs(2, sq, skv, 2, 16, seed=1)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    _, jlse = JA._flash_forward_bshd(jq, jk, jv, causal, BLOCK, BLOCK, None, True,
                                     with_lse=True, window=window)
    jout, vjp = jax.vjp(lambda a, b_, c: JA.flash_attention_bshd(
        a, b_, c, causal=causal, block_q=BLOCK, block_kv=BLOCK, interpret=True, window=window),
        jq, jk, jv)
    want = [jout, jlse.reshape(2, 2, sq), *vjp(jnp.asarray(g))]

    tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    out = TA.flash_attention_bshd(tq, tk, tv, causal=causal, window=window)
    _, lse = TA.flash_forward_bshd(tq.detach(), tk.detach(), tv.detach(), causal, window)
    got = [out, lse, *torch.autograd.grad(out, (tq, tk, tv), torch.tensor(g))]
    for name, t, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(w), atol=TOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("route", ["segments", "two_pass"])
@pytest.mark.parametrize("window", [None, 24])
def test_packed_long_branch_matches_jax(gate, routes, route, window):
    """The packed backward past its one-call limit — the JAX package unpacks
    (rotating q/k and repeating kv heads outside the kernel) and runs the
    BSHD backward; the port runs K8 per q segment, or K5/K6, on head views
    of qkv with rope at each row's position and GQA by head group. GQA
    (4 q / 2 kv), causal (+ window), per-batch rope tables, mirroring
    tests/test_attention.py's packed rope fallback test."""
    b, s, h, kv, d = 2, 64, 4, 2, 16
    gate(32 * 1024 if route == "segments" else 0)  # 32 rows of 1 KiB: two segments
    rng = np.random.default_rng(11)
    qkv = rng.standard_normal((b, s, (h + 2 * kv) * d)).astype(np.float32)
    g_out = rng.standard_normal((b, s, h * d)).astype(np.float32)
    positions = np.stack([np.arange(s), 37 + np.arange(s)])
    jcos, jsin = JR.rope_cos_sin(jnp.asarray(positions), d)
    tcos, tsin = TR.rope_cos_sin(torch.tensor(positions), d)

    want_out, vjp = jax.vjp(
        lambda x: JA.flash_attention_qkv(x, h, kv, causal=True, window=window, block_q=BLOCK,
                                         block_kv=BLOCK, interpret=True, rope_cos=jcos,
                                         rope_sin=jsin),
        jnp.asarray(qkv))
    (want_grad,) = vjp(jnp.asarray(g_out))
    x = torch.tensor(qkv, requires_grad=True)
    out = TA.flash_attention_qkv(x, h, kv, causal=True, window=window, rope_cos=tcos,
                                 rope_sin=tsin)
    (grad,) = torch.autograd.grad(out, x, torch.tensor(g_out))
    if route == "segments":
        assert routes == [("fused", "bshd_bwd", a) for a in (0, 32)]
    else:
        assert routes == [("two_pass", 0)]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=TOL, rtol=0)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), atol=TOL, rtol=0)


def test_long_context_lm_step_matches_jax(gate, routes):
    """One SGD step of a small long-context LM — GQA (4 q / 2 kv heads), rope
    θ 500000, bias-free, flash attention — from weights converted from the
    JAX model, at seq 1152 with the gate lowered to 576 KiB on both sides,
    so that each layer's backward runs on two q segments of 576 rows (the
    JAX model's default blocks fit to 576 at this length). The loss and
    every updated weight (w − lr·grad, so the gradients) within 1e-5 of the
    JAX step with its dense reference attention (test_packed_long_branch_
    matches_jax holds the port's long branch against the JAX kernels in
    interpret mode)."""
    from distributed_tensorflow_tpu.models import transformer as JT
    from distributed_tensorflow_tpu.parallel import data_parallel as jdp
    from distributed_tensorflow_tpu.parallel.mesh import make_mesh
    from distributed_tensorflow_tpu.train import optimizers as JO
    from distributed_tensorflow_tpu_torch.models import transformer as TT
    from distributed_tensorflow_tpu_torch.models.convert import transformer_params_from_jax
    from distributed_tensorflow_tpu_torch.parallel.data_parallel import build_lm_train_step
    from distributed_tensorflow_tpu_torch.train import optimizers as TO

    gate(576 * 1024, block=1024)
    s, lr = 1152, 0.5
    shape = dict(vocab_size=32, d_model=32, num_heads=4, num_kv_heads=2, num_layers=2, d_ff=64,
                 max_seq_len=s, attention="flash", use_bias=False, position="rope",
                 rope_theta=500000.0)
    jcfg = JT.TransformerConfig(compute_dtype=jnp.float32, **{**shape, "attention": "dense"})
    params = jax.device_get(
        JT.TransformerLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    )
    tokens = np.random.default_rng(0).integers(0, 32, (1, s)).astype(np.int32)

    mesh = make_mesh(num_devices=1)
    tx = JO.make_optimizer("sgd", lr, total_steps=1)
    jstep = jdp.build_lm_train_step(jcfg, tx, mesh)
    p, _, _, m = jstep(jdp.replicate(params, mesh), jdp.replicate(tx.init(params), mesh),
                       jnp.zeros((), jnp.int32),
                       jdp.shard_global_batch({"x": jnp.asarray(tokens)}, mesh)["x"],
                       jax.random.PRNGKey(0))

    model = TT.TransformerLM(TT.TransformerConfig(compute_dtype=torch.float32, **shape),
                             device="cpu")
    model.load_state_dict(transformer_params_from_jax(params))
    tstep = build_lm_train_step(model, TO.make_optimizer("sgd", model.parameters(), lr,
                                                         total_steps=1))
    loss = float(tstep(torch.from_numpy(tokens))["loss"])
    assert routes == [("fused", "bshd_bwd", a) for a in (0, 576)] * 2
    np.testing.assert_allclose(loss, float(m["loss"]), atol=1e-5, rtol=0)
    want = transformer_params_from_jax(jax.device_get(p))
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
