"""Head dims between the kernels' instances, and the kernels' source choice
(bf16 at 64, 128 and 256 on the warpgroup forward and fused backward).

The CUDA kernels are compiled for head_dim 32, 64, 128 and 256; any other
head_dim up to 256 runs zero-padded to the next of those, and any head_dim
above 256 zero-padded to the next multiple of 128 on the column-group
kernels (``*_dstream``), which take the head dim at run time. What makes that
exact is checked here on the CPU through the plain versions: the padded call
at the real head_dim's scale equals the unpadded one (f32, 1e-6 relative),
and the rope pairing survives only the half-by-half pad. The port is held
against the JAX package at head_dim 32 (the CLI's default d_model 128 over 4
heads), 80, 192 and 256 (Gemma 7B's), and through one training step at the
CLI's defaults (f32, 1e-4 absolute on the losses, the tolerance of
tests/test_torch_train_lm.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import transformer as JT
from distributed_tensorflow_tpu.ops import attention as JA
from distributed_tensorflow_tpu.parallel import data_parallel as jdp
from distributed_tensorflow_tpu.parallel.mesh import make_mesh
from distributed_tensorflow_tpu.train import optimizers as JO
from distributed_tensorflow_tpu_torch.cli import train_lm as cli
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import transformer_params_from_jax
from distributed_tensorflow_tpu_torch.ops import _build
from distributed_tensorflow_tpu_torch.ops import attention as TA
from distributed_tensorflow_tpu_torch.ops import rope as TR
from distributed_tensorflow_tpu_torch.parallel.data_parallel import build_lm_train_step
from distributed_tensorflow_tpu_torch.train import optimizers as TO

pytestmark = pytest.mark.torch_port

PAD_TOL = 1e-6  # relative to the largest value: f32 sums over zero columns change nothing


def _operands(d, b=2, h=4, kv=2, s=40, seed=0):
    rng = np.random.default_rng(seed)
    make = lambda n: torch.tensor(rng.standard_normal((b, n, s, d)), dtype=torch.float32)
    return make(h), make(kv), make(kv), make(h)


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("d", [48, 80, 160, 192])
def test_padded_plain_equals_unpadded_plain(d):
    """Forward and backward with rope, GQA and causal masking, at head_dim d
    and padded to the next instance: out, lse and every gradient agree."""
    q, k, v, g = _operands(d)
    cos, sin = TR.rope_tables(d, q.shape[2], 10000.0)
    dp = TA._instance_dim(d)
    pc, ps = TA.pad_rope_tables(cos, sin, dp)
    pad = lambda t: TA.pad_head_dim(t, dp)
    scale = 1.0 / math.sqrt(d)
    out, lse = TA.flash_forward_reference(q, k, v, True, cos=cos, sin=sin)
    out_p, lse_p = TA.flash_forward_reference(pad(q), pad(k), pad(v), True, scale=scale,
                                              cos=pc, sin=ps)
    assert out_p.shape[-1] == dp
    assert _rel(TA.unpad_head_dim(out_p, d), out) <= PAD_TOL
    assert (lse_p - lse).abs().max().item() <= PAD_TOL * lse.abs().max().item()
    grads = TA.flash_backward_reference(q, k, v, out, lse, g, True, cos=cos, sin=sin)
    grads_p = TA.flash_backward_reference(pad(q), pad(k), pad(v), pad(out), lse, pad(g), True,
                                          scale=scale, cos=pc, sin=ps)
    for name, got, want in zip(("dq", "dk", "dv"), grads_p, grads):
        assert _rel(TA.unpad_head_dim(got, d), want) <= PAD_TOL, name
        # The padded columns' gradients are exact zeros.
        assert torch.equal(got, TA.pad_head_dim(TA.unpad_head_dim(got, d), dp)), name


@pytest.mark.parametrize("d", [48, 80, 160, 192])
def test_tail_pad_breaks_the_rope_pairing(d):
    """The control: padding the tail instead pairs column i with i + dp/2,
    which holds another column or a zero, and the rotation comes out wrong."""
    q, k, v, _ = _operands(d, seed=1)
    cos, sin = TR.rope_tables(d, q.shape[2], 10000.0)
    dp = TA._instance_dim(d)
    z = dp // 2 - d // 2
    tail = lambda t: torch.nn.functional.pad(t, (0, dp - d))
    tc, ts = torch.nn.functional.pad(cos, (0, z), value=1.0), torch.nn.functional.pad(sin, (0, z))
    out, _ = TA.flash_forward_reference(q, k, v, True, cos=cos, sin=sin)
    out_t, _ = TA.flash_forward_reference(tail(q), tail(k), tail(v), True,
                                          scale=1.0 / math.sqrt(d), cos=tc, sin=ts)
    assert _rel(out_t[..., :d], out) > 0.1


def test_pad_round_trips_and_instances():
    x = torch.arange(2 * 3 * 80, dtype=torch.float32).reshape(2, 3, 80)
    p = TA.pad_head_dim(x, 128)
    assert p.shape == (2, 3, 128) and p.is_contiguous()
    assert torch.equal(p[..., :40], x[..., :40]) and torch.equal(p[..., 64:104], x[..., 40:])
    assert not p[..., 40:64].any() and not p[..., 104:].any()
    assert torch.equal(TA.unpad_head_dim(p, 80), x)
    odd = torch.ones(1, 33)
    assert torch.equal(TA.unpad_head_dim(TA.pad_head_dim(odd, 64), 33), odd)
    assert TA.pad_head_dim(x, 80) is x
    assert [TA._instance_dim(d) for d in (8, 32, 33, 64, 80, 96, 128, 129, 160, 192, 256)] == [
        32, 32, 64, 64, 128, 128, 128, 256, 256, 256, 256]
    # Above 256: the next multiple of 128, which the column-group kernels take.
    assert [TA._instance_dim(d) for d in (257, 300, 320, 384, 385, 512, 1000, 1024)] == [
        384, 384, 384, 384, 512, 512, 1024, 1024]
    cos, sin = TR.rope_tables(80, 5)
    pc, ps = TA.pad_rope_tables(cos, sin, 128)
    assert pc.shape == (1, 5, 64) and torch.equal(pc[..., :40], cos)
    assert torch.all(pc[..., 40:] == 1) and not ps[..., 40:].any()
    assert TA.pad_rope_tables(None, None, 128) == (None, None)


def test_kernel_wrappers_reject_head_dims_above_128():
    """The kernels take any head_dim (the name is the test's from when the
    limit was 128): one head of 320 passes the head-dim checks and is
    refused only for lying on the CPU, which the kernels do not take."""
    x = torch.zeros(1, 8, 3 * 320)
    with pytest.raises(ValueError, match="take CUDA tensors, got cpu"):
        TA.flash_forward_qkv_kernel(x, 1, 1, True, None, None, None, None)
    q = torch.zeros(1, 1, 8, 320)
    with pytest.raises(ValueError, match="take CUDA tensors, got cpu"):
        TA.flash_forward_kernel(q, q, q, True)


@pytest.mark.parametrize("case", [
    ((torch.bfloat16, 128, True), "flash_bwd_sm90"),
    ((torch.bfloat16, 64, True), "flash_bwd_sm90"),
    ((torch.float32, 128, True), "flash_bwd"),
    ((torch.bfloat16, 32, True), "flash_bwd"),
    ((torch.bfloat16, 128, False), "flash_bwd_sm90"),
    ((torch.bfloat16, 64, False), "flash_bwd_sm90"),
    ((torch.float32, 64, False), "flash_bwd"),
    ((torch.bfloat16, 256, True), "flash_bwd_sm90"),
    ((torch.bfloat16, 256, False), "flash_bwd_sm90"),
    ((torch.float32, 256, True), "flash_bwd"),
    ((torch.float32, 256, False), "flash_bwd"),
    ((torch.bfloat16, 384, True), "flash_bwd_dstream"),
    ((torch.bfloat16, 512, True), "flash_bwd_dstream"),
    ((torch.float32, 384, True), "flash_bwd_dstream"),
    ((torch.float32, 512, True), "flash_bwd_dstream"),
    ((torch.bfloat16, 512, False), "flash_bwd_cols_sm90"),
    ((torch.float32, 384, False), "flash_bwd_dstream"),
])
def test_backward_kernel_dispatch(case):
    args, want = case
    assert TA.backward_kernel(*args) == want


@pytest.mark.parametrize("case", [
    ((torch.bfloat16, 128), "flash_bwd_dq_sm90"),
    ((torch.bfloat16, 64), "flash_bwd_dq_sm90"),
    ((torch.float32, 128), "flash_bwd_dq"),
    ((torch.float32, 64), "flash_bwd_dq"),
    ((torch.bfloat16, 32), "flash_bwd_dq"),
    ((torch.bfloat16, 256), "flash_bwd_dq_sm90"),
    ((torch.float32, 256), "flash_bwd_dq"),
    ((torch.bfloat16, 384), "flash_bwd_dq_cols_sm90"),
    ((torch.bfloat16, 512), "flash_bwd_dq_cols_sm90"),
    ((torch.float32, 384), "flash_bwd_dq_dstream"),
    ((torch.float32, 512), "flash_bwd_dq_dstream"),
])
def test_backward_dq_kernel_dispatch(case):
    """K5: bf16 at 64/128/256 on the warpgroup kernel; f32 and 32 on the
    plain-design one; bf16 at 384/512 on the warpgroup kernel above 256, f32
    above 256 on the column-group kernel."""
    args, want = case
    assert TA.backward_dq_kernel(*args) == want


@pytest.mark.parametrize("case", [
    ((torch.bfloat16, 128), "flash_fwd_pipe_sm90"),
    ((torch.bfloat16, 64), "flash_fwd_pipe_sm90"),
    ((torch.float32, 128), "flash_fwd_pipe"),
    ((torch.float32, 64), "flash_fwd_pipe"),
    ((torch.bfloat16, 256), "flash_fwd_pipe_sm90"),
    ((torch.float32, 256), "flash_fwd_pipe"),
    ((torch.bfloat16, TA._pipe_instance_dim(80)), "flash_fwd_pipe_sm90"),
    ((torch.float32, TA._pipe_instance_dim(200)), "flash_fwd_pipe"),
    ((torch.bfloat16, TA._pipe_instance_dim(320)), "flash_fwd_cols_sm90"),
])
def test_pipe_forward_kernel_dispatch(case):
    """K9: bf16 on the warpgroup kernel, f32 on the old one, at 64, 128 and
    256 and the head dims padded to them; above 256 the forward's source."""
    args, want = case
    assert TA.pipe_forward_kernel(*args) == want


@pytest.mark.parametrize("d", [160, 192, 256])
def test_head_dims_to_256_keep_the_plain_design_kernels(d):
    """Head dims 129-256 run the instance 256: in bf16 the warpgroup forward,
    fused backward (K6 included) and two-pass dq kernel (K5), in f32 the
    plain-design kernels. (The name is the test's from when every call at
    256 took the plain design.)"""
    dp = TA._instance_dim(d)
    assert dp == 256
    assert TA.forward_kernel(torch.bfloat16, dp) == "flash_fwd_sm90"
    assert TA.backward_kernel(torch.bfloat16, dp, True) == "flash_bwd_sm90"
    assert TA.backward_kernel(torch.bfloat16, dp, False) == "flash_bwd_sm90"
    assert TA.forward_kernel(torch.float32, dp) == "flash_fwd"
    assert TA.backward_kernel(torch.float32, dp, True) == "flash_bwd"
    assert TA.backward_kernel(torch.float32, dp, False) == "flash_bwd"
    assert TA.backward_dq_kernel(torch.bfloat16, dp) == "flash_bwd_dq_sm90"
    assert TA.backward_dq_kernel(torch.float32, dp) == "flash_bwd_dq"


def test_new_sm90_sources_are_built_on_the_shared_header():
    assert {"flash_bwd_dq_sm90", "flash_fwd_pipe_sm90"} <= set(_build.sources())
    for name in ("flash_bwd_dq_sm90", "flash_fwd_pipe_sm90"):
        assert _build.library_path(name).name.startswith(f"{name}-")
        assert '#include "sm90_common.cuh"' in (_build.CSRC / f"{name}.cu").read_text()
    for name in TA.SOURCE_LAUNCHES:
        assert (_build.CSRC / f"{name}.cu").exists(), name


def test_new_backward_source_is_built():
    assert {"flash_bwd", "flash_bwd_sm90", "flash_bwd_dq", "flash_fwd",
            "flash_fwd_pipe"} <= set(_build.sources())
    assert _build.library_path("flash_bwd_sm90").name.startswith("flash_bwd_sm90-")


def test_route_gate_reads_the_real_head_dim(monkeypatch):
    """The backward's route is decided on the caller's head_dim, before any
    padding, so a padded shape takes the JAX package's route."""
    seen = []
    real = TA._segment_rows
    monkeypatch.setattr(TA, "_segment_rows", lambda sq, d: seen.append(d) or real(sq, d))
    q, k, v, _ = _operands(80, b=1, h=2, kv=1, s=16)
    for t in (q, k, v):
        t.requires_grad_(True)
    TA.flash_attention(q, k, v, causal=True).sum().backward()
    qkv = torch.randn(1, 16, 6 * 48, requires_grad=True)
    TA.flash_attention_qkv(qkv, 2, causal=True).sum().backward()
    assert seen == [80, 48]


B, S, H = 2, 64, 4


@pytest.mark.parametrize("d,kv,window,rope", [(32, 4, None, False), (32, 2, 8, True),
                                              (80, 2, None, True)])
def test_flash_qkv_at_head_dim_matches_jax(d, kv, window, rope):
    """flash_attention_qkv at head_dim 32 (an instance) and 80 (padded on the
    card) against the JAX function in interpret mode: out and dqkv within
    1e-4 absolute (f32)."""
    rng = np.random.default_rng(d + kv)
    qkv = rng.standard_normal((B, S, (H + 2 * kv) * d)).astype(np.float32)
    g = rng.standard_normal((B, S, H * d)).astype(np.float32)
    kw = dict(rope_theta=10000.0) if rope else {}
    out, vjp = jax.vjp(lambda t: JA.flash_attention_qkv(t, H, kv, causal=True, interpret=True,
                                                        window=window, **kw), jnp.asarray(qkv))
    (want_d,) = vjp(jnp.asarray(g))
    x = torch.tensor(qkv, requires_grad=True)
    got = TA.flash_attention_qkv(x, H, kv, causal=True, window=window, **kw)
    (got_d,) = torch.autograd.grad(got, x, torch.tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-4, rtol=0)


@pytest.mark.parametrize("d", [192, 256])
def test_wide_head_flash_qkv_matches_jax(d):
    """flash_attention_qkv at head_dim 192 (padded to 256 on the card) and
    256 (Gemma 7B's head width) — rope, 4 query heads on 2 kv heads, causal,
    batch 1, seq 128 — against the JAX function in interpret mode: out and
    each of dq, dk, dv within 1e-4 absolute (f32)."""
    h, kv, s = 4, 2, 128
    rng = np.random.default_rng(d)
    qkv = rng.standard_normal((1, s, (h + 2 * kv) * d)).astype(np.float32)
    g = rng.standard_normal((1, s, h * d)).astype(np.float32)
    out, vjp = jax.vjp(lambda t: JA.flash_attention_qkv(t, h, kv, causal=True, interpret=True,
                                                        rope_theta=10000.0), jnp.asarray(qkv))
    (want_d,) = vjp(jnp.asarray(g))
    x = torch.tensor(qkv, requires_grad=True)
    got = TA.flash_attention_qkv(x, h, kv, causal=True, rope_theta=10000.0)
    (got_d,) = torch.autograd.grad(got, x, torch.tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-4, rtol=0)
    sections = np.cumsum([h * d, kv * d])
    for name, got_g, want_g in zip(("dq", "dk", "dv"), np.split(got_d.numpy(), sections, -1),
                                   np.split(np.asarray(want_d), sections, -1)):
        assert np.abs(want_g).max() > 0, name
        np.testing.assert_allclose(got_g, want_g, atol=1e-4, rtol=0, err_msg=name)


def _cli_config():
    """The model config cli/train_lm.py builds from its own defaults with
    --attention flash, in f32 (its CPU compute dtype)."""
    args = cli.build_parser().parse_args(["--attention", "flash", "--device", "cpu"])
    shape = dict(vocab_size=args.vocab_size, d_model=args.d_model, num_heads=args.num_heads,
                 num_layers=args.num_layers, d_ff=args.d_ff, max_seq_len=args.seq_len,
                 use_bias=bool(args.use_bias), attention=args.attention)
    return args, shape


def test_cli_defaults_step_matches_jax():
    """Two Adam steps at the CLI's defaults (d_model 128 over 4 heads: dh 32,
    4 layers, seq 128, batch 8, flash attention) from the same weights and
    the CLI's own synthetic batches: the port's losses equal the JAX
    trainer's within 1e-4."""
    args, shape = _cli_config()
    assert shape["d_model"] // args.num_heads == 32
    jcfg = JT.TransformerConfig(compute_dtype=jnp.float32, **shape)
    params = jax.device_get(
        JT.TransformerLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    )
    rng = np.random.default_rng(args.seed)
    batches = [cli.synthetic_tokens(rng, args.batch_size, args.seq_len, args.vocab_size)
               for _ in range(2)]
    mesh = make_mesh(num_devices=1)
    tx = JO.make_optimizer(args.optimizer, args.learning_rate, total_steps=2)
    jstep = jdp.build_lm_train_step(jcfg, tx, mesh)
    p, o, n = jdp.replicate(params, mesh), jdp.replicate(tx.init(params), mesh), jnp.zeros(
        (), jnp.int32)
    want = []
    for t in batches:
        p, o, n, m = jstep(p, o, n, jdp.shard_global_batch({"x": jnp.asarray(t)}, mesh)["x"],
                           jax.random.PRNGKey(0))
        want.append(float(m["loss"]))
    model = TT.TransformerLM(TT.TransformerConfig(compute_dtype=torch.float32, **shape),
                             device="cpu")
    model.load_state_dict(transformer_params_from_jax(params))
    opt = TO.make_optimizer(args.optimizer, model.parameters(), args.learning_rate,
                            total_steps=2)
    step = build_lm_train_step(model, opt)
    got = [float(step(torch.from_numpy(t))["loss"]) for t in batches]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert got[1] != got[0]


def test_cli_trains_at_its_defaults_on_cpu(capsys):
    """The CLI itself at its defaults with flash attention (dh 32), on the
    CPU: finite losses at each boundary."""
    import json

    cli.main(["--attention", "flash", "--device", "cpu", "--training_steps", "2",
              "--eval_step_interval", "1"])
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in records)
