"""Head dims above 256 — the column-group kernels' range — against the JAX
package on the CPU.

On the card any head_dim d above 256 runs zero-padded to the next multiple
of 128 on the column-group kernels (``csrc/*_dstream.cu``); on the CPU the
port takes the plain versions of the same routes at the real d. Checked
here:

  * ``flash_attention_qkv`` at d 320 (rope, 4 query heads on 2 kv heads) and
    d 512, and ``flash_attention`` at d 512 cross-length, against the JAX
    functions in interpret mode (f32, 1e-4 absolute, the limit of
    tests/test_torch_head_dims.py);
  * the backward's route gate at the trainer's lengths: d 320 takes q
    segments of 1024 rows (K8), d 512 the two-pass pair K5/K6 at any
    sequence of 2048 rows or more, on both packages; and, with the gate
    lowered on both, each route's gradients at a small size against JAX's;
  * two Adam steps of ``cli/train_lm.py``'s model at ``--d_model 512
    --num_heads 1`` (d 512; one layer, batch 4) against the JAX trainer's
    step from the same weights and batches (losses within 1e-4);
  * the rope tables at these widths: cos and sin of the f32 angles,
    rounded from f64.
"""

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
from distributed_tensorflow_tpu_torch.ops import attention as TA
from distributed_tensorflow_tpu_torch.ops.rope import rope_cos_sin
from distributed_tensorflow_tpu_torch.parallel.data_parallel import build_lm_train_step
from distributed_tensorflow_tpu_torch.train import optimizers as TO

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

H, S, BLOCK = 4, 128, 64


def _qkv_case(d, kv, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((1, S, (H + 2 * kv) * d)).astype(np.float32)
    g = rng.standard_normal((1, S, H * d)).astype(np.float32)
    return qkv, g


def _check_qkv_grads(got_d, want_d, d, kv):
    sections = np.cumsum([H * d, kv * d])
    for name, got_g, want_g in zip(("dq", "dk", "dv"), np.split(got_d, sections, -1),
                                   np.split(np.asarray(want_d), sections, -1)):
        assert np.abs(want_g).max() > 0, name
        np.testing.assert_allclose(got_g, want_g, atol=1e-4, rtol=0, err_msg=name)


def _port_qkv(qkv, g, kv, kw):
    x = torch.tensor(qkv, requires_grad=True)
    out = TA.flash_attention_qkv(x, H, kv, causal=True, **kw)
    (dx,) = torch.autograd.grad(out, x, torch.tensor(g))
    return out.detach().numpy(), dx.numpy()


def _jax_qkv(qkv, g, kv, kw):
    out, vjp = jax.vjp(lambda t: JA.flash_attention_qkv(t, H, kv, causal=True, interpret=True,
                                                        block_q=BLOCK, block_kv=BLOCK, **kw),
                       jnp.asarray(qkv))
    return np.asarray(out), vjp(jnp.asarray(g))[0]


@pytest.mark.parametrize("d,kv,rope", [(320, 2, True), (512, 4, False)])
def test_flash_qkv_above_256_matches_jax(d, kv, rope):
    """Packed qkv, causal, batch 1, seq 128: out and each of dq, dk, dv."""
    qkv, g = _qkv_case(d, kv, seed=d)
    kw = dict(rope_theta=10000.0) if rope else {}
    got, got_d = _port_qkv(qkv, g, kv, kw)
    want, want_d = _jax_qkv(qkv, g, kv, kw)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    _check_qkv_grads(got_d, want_d, d, kv)


def test_flash_bhsd_d512_cross_length_matches_jax():
    """BHSD at d 512, 64 queries end-aligned against 128 keys, causal with a
    window: out and each gradient."""
    d, sq, skv = 512, 64, 128
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 2, n, d)).astype(np.float32) for n in (sq, skv, skv))
    g = rng.standard_normal((1, 2, sq, d)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b, c: JA.flash_attention(a, b, c, causal=True, window=48,
                                                           block_q=BLOCK, block_kv=BLOCK,
                                                           interpret=True),
                        *map(jnp.asarray, (q, k, v)))
    want_g = vjp(jnp.asarray(g))
    xs = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    got = TA.flash_attention(*xs, causal=True, window=48)
    got_g = torch.autograd.grad(got, xs, torch.tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0, err_msg=name)


def test_gate_above_256_at_the_trainer_lengths(monkeypatch):
    """d 320: one f32 dq row and its delta take 2,048 bytes of the 2 MiB
    gate, so seq 2048 and 8192 run the fused kernel on q segments of 1024
    (K8). d 512: 2,560 bytes a row leave 819 rows, under the gate's block of
    1024, so no segmentation exists and the two-pass pair K5/K6 runs."""
    monkeypatch.delenv("LIBTPU_INIT_ARGS", raising=False)
    assert TA._fused_bwd_scratch_limit() == JA._fused_bwd_scratch_limit()
    for seq in (2048, 8192):
        want = JA._fused_segment_rows(seq, 320, JA._fit_block(1024, seq))
        assert TA._segment_rows(seq, 320) == want == 1024
    assert TA._dq_scratch_bytes_per_row(512) == JA._dq_scratch_bytes_per_row(512) == 2560
    for seq in (2048, 4096, 8192):
        assert seq * TA._dq_scratch_bytes_per_row(512) > TA._fused_bwd_scratch_limit()
        assert JA._fused_segment_rows(seq, 512, JA._fit_block(1024, seq)) is None
        assert TA._segment_rows(seq, 512) is None


@pytest.mark.parametrize("d,kv,rows,route", [(320, 2, 64, "segments"),
                                             (512, 4, 32, "two_pass")])
def test_lowered_gate_routes_match_jax(monkeypatch, d, kv, rows, route):
    """The gate lowered on both packages to ``rows`` rows of dq scratch at
    blocks of 64: d 320 takes two q segments of 64 (K8's route), d 512 the
    two-pass pair (no segment of 32 rows holds a block of 64). Both routes'
    dqkv against JAX's on the same route, rope at d 320."""
    monkeypatch.delenv("LIBTPU_INIT_ARGS", raising=False)
    limit = rows * TA._dq_scratch_bytes_per_row(d)
    for mod in (JA, TA):
        monkeypatch.setattr(mod, "_FUSED_BWD_SCRATCH_LIMIT", limit)
    monkeypatch.setattr(TA, "_GATE_BLOCK", BLOCK)
    want_rows = JA._fused_segment_rows(S, d, JA._fit_block(BLOCK, S))
    assert TA._segment_rows(S, d) == want_rows == (64 if route == "segments" else None)
    seen = []
    for name in ("_backward", "_backward_two_pass"):
        real = getattr(TA, name)
        monkeypatch.setattr(TA, name, lambda *a, _n=name, _r=real: seen.append(_n) or _r(*a))
    qkv, g = _qkv_case(d, kv, seed=d + 1)
    kw = dict(rope_theta=10000.0) if d == 320 else {}
    _, got_d = _port_qkv(qkv, g, kv, kw)
    assert seen == (["_backward"] * 2 if route == "segments" else ["_backward_two_pass"])
    _, want_d = _jax_qkv(qkv, g, kv, kw)
    _check_qkv_grads(got_d, want_d, d, kv)


def test_cli_step_at_head_dim_512_matches_jax():
    """Two Adam steps of the CLI's model at --d_model 512 --num_heads 1 (one
    head of 512, flash attention; one layer and batch 4 to keep the JAX
    side's interpret-mode kernels quick, the CLI's other defaults: seq 128,
    d_ff 512) from the same weights and the CLI's own synthetic batches: the
    port's losses equal the JAX trainer's within 1e-4. The JAX step runs its
    dense reference attention: test_flash_qkv_above_256_matches_jax and the
    two-pass tests hold the port's kernels above 256 against the JAX kernels
    in interpret mode."""
    args = cli.build_parser().parse_args(["--attention", "flash", "--device", "cpu",
                                          "--d_model", "512", "--num_heads", "1",
                                          "--num_layers", "1", "--batch_size", "4"])
    assert args.d_model // args.num_heads == 512
    shape = dict(vocab_size=args.vocab_size, d_model=args.d_model, num_heads=args.num_heads,
                 num_layers=args.num_layers, d_ff=args.d_ff, max_seq_len=args.seq_len,
                 use_bias=bool(args.use_bias), attention=args.attention)
    jcfg = JT.TransformerConfig(compute_dtype=jnp.float32, **{**shape, "attention": "dense"})
    params = jax.device_get(
        JT.TransformerLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    )
    rng = np.random.default_rng(args.seed)
    batches = [cli.synthetic_tokens(rng, args.batch_size, args.seq_len, args.vocab_size)
               for _ in range(2)]
    mesh = make_mesh(num_devices=1)
    tx = JO.make_optimizer(args.optimizer, args.learning_rate, total_steps=2)
    jstep = jdp.build_lm_train_step(jcfg, tx, mesh)
    p, o = jdp.replicate(params, mesh), jdp.replicate(tx.init(params), mesh)
    n = jnp.zeros((), jnp.int32)
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


def test_rope_tables_are_f64_values_rounded():
    """cos and sin of the f32 angles pos · θ^(-i/half), as f64 values
    rounded to f32, within 2 ulp, over 8192 positions at d 320 and 512.
    (torch's vectorised f32 cos on AVX-512 CPUs was seen off by up to
    1.5e-4 in some processes, which took the d 320 rope case past its
    1e-4.)"""
    pos = torch.arange(8192)
    for d in (320, 512):
        half = d // 2
        cos, sin = rope_cos_sin(pos, d, 10000.0)
        inv_freq = 10000.0 ** (-torch.arange(half, dtype=torch.float32) / half)
        ang = (pos.to(torch.float32)[:, None] * inv_freq).double().numpy()
        for got, want in ((cos, np.cos(ang)), (sin, np.sin(ang))):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want.astype(np.float32), atol=1.2e-7, rtol=0)
