"""The warpgroup kernels this slice adds above the old instances, on the CPU.

bf16 calls at head_dim 384 and 512 (and every head dim padded to them,
257-512) run the forward ``csrc/flash_fwd_cols_sm90.cu`` on the card, and
bf16 K5 at head_dim 256 runs ``csrc/flash_bwd_dq_sm90.cu``; f32 keeps the
plain-design and column-group kernels. What can be checked here, with no
card: the source table and the new source's build entry; the bf16 slice as
a whole above 256 — ``flash_attention_qkv`` with GQA, a window and rope at
d 320 (padded to 384 on the card) and with GQA and a window at d 512,
forward and backward, against the JAX function in interpret mode (2e-2 of
the largest |out| and 3e-2 of the largest |dqkv|, chip_smoke.py's bf16
limits); the two-pass route at d 256 (K6 then K5), forced on both packages
by lowering the gate, with rope and GQA, against JAX's (f32, 1e-4 absolute);
and that CPU calls launch no kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import attention as JA
from distributed_tensorflow_tpu_torch.ops import _build
from distributed_tensorflow_tpu_torch.ops import attention as TA

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

BLOCK = 64


def test_warpgroup_forward_above_256_source_is_built():
    assert "flash_fwd_cols_sm90" in _build.sources()
    assert "flash_fwd_cols_sm90" in TA.SOURCE_LAUNCHES
    assert _build.library_path("flash_fwd_cols_sm90").name.startswith("flash_fwd_cols_sm90-")
    text = (_build.CSRC / "flash_fwd_cols_sm90.cu").read_text()
    # the warpgroup pieces, and the column-group family's prepare pass
    assert '#include "sm90_common.cuh"' in text and '#include "flash_dstream.cuh"' in text


@pytest.mark.parametrize("dh,dtype,want", [
    (257, torch.bfloat16, "flash_fwd_cols_sm90"), (320, torch.bfloat16, "flash_fwd_cols_sm90"),
    (384, torch.bfloat16, "flash_fwd_cols_sm90"), (400, torch.bfloat16, "flash_fwd_cols_sm90"),
    (512, torch.bfloat16, "flash_fwd_cols_sm90"), (513, torch.bfloat16, "flash_fwd_dstream"),
    (320, torch.float32, "flash_fwd_dstream"), (512, torch.float32, "flash_fwd_dstream"),
])
def test_forward_above_256_dispatch_at_the_instance(dh, dtype, want):
    """Head dims 257-384 run the instance 384 and 385-512 the instance 512,
    in bf16 on the warpgroup kernel; bf16 above 512 and f32 above 256 stay
    on the column-group forward; the fused backward stays column-group, and
    K5 goes with the forward (bf16 at 384/512 on its warpgroup kernel)."""
    dp = TA._instance_dim(dh)
    assert TA.forward_kernel(dtype, dp) == want
    assert TA.backward_kernel(dtype, dp, True) == "flash_bwd_dstream"
    k5 = "flash_bwd_dq_cols_sm90" if want == "flash_fwd_cols_sm90" else "flash_bwd_dq_dstream"
    assert TA.backward_dq_kernel(dtype, dp) == k5


def _tables(s, half, seed):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, (1, s, half)).astype(np.float32)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@pytest.mark.parametrize("d,h,kv,rope", [(320, 4, 2, True), (512, 2, 1, False)])
def test_bf16_flash_qkv_above_256_matches_jax(d, h, kv, rope):
    """The slice as a whole in bf16 above 256: ``flash_attention_qkv`` with
    GQA and a window (and rope tables at d 320), forward and backward,
    against the JAX function in interpret mode on the same numpy inputs."""
    b, s, window = 1, 128, 48
    rng = np.random.default_rng(d)
    qkv = rng.standard_normal((b, s, (h + 2 * kv) * d)).astype(np.float32)
    g = rng.standard_normal((b, s, h * d)).astype(np.float32)
    cos, sin = _tables(s, d // 2, seed=d + 1) if rope else (None, None)
    jkw = dict(rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin)) if rope else {}
    tkw = dict(rope_cos=torch.tensor(cos), rope_sin=torch.tensor(sin)) if rope else {}
    x = jnp.asarray(qkv).astype(jnp.bfloat16)
    out_j, vjp = jax.vjp(
        lambda t: JA.flash_attention_qkv(t, h, kv, causal=True, interpret=True, window=window,
                                         block_q=BLOCK, block_kv=BLOCK, **jkw), x)
    (dqkv_j,) = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    xt = torch.tensor(qkv).to(torch.bfloat16).requires_grad_(True)
    out_t = TA.flash_attention_qkv(xt, h, kv, causal=True, window=window, **tkw)
    (dqkv_t,) = torch.autograd.grad(out_t, xt, torch.tensor(g).to(torch.bfloat16))
    for got, want, tol in ((out_t, out_j, 2e-2), (dqkv_t, dqkv_j, 3e-2)):
        want = np.asarray(want.astype(jnp.float32))
        got = got.detach().float().numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_two_pass_route_at_d256_matches_jax(monkeypatch):
    """K6 then K5 at head_dim 256 — the route bf16 K5 at 256 serves on the
    card — forced on both packages by a gate of 32 dq rows (under the block
    of 64, so no q segmentation exists), with rope and GQA (4 query heads on
    2 kv heads): dq, dk and dv against JAX's on the same route."""
    d, h, kv, s = 256, 4, 2, 128
    monkeypatch.delenv("LIBTPU_INIT_ARGS", raising=False)
    limit = 32 * TA._dq_scratch_bytes_per_row(d)
    for mod in (JA, TA):
        monkeypatch.setattr(mod, "_FUSED_BWD_SCRATCH_LIMIT", limit)
    monkeypatch.setattr(TA, "_GATE_BLOCK", BLOCK)
    assert TA._segment_rows(s, d) is None
    assert JA._fused_segment_rows(s, d, JA._fit_block(BLOCK, s)) is None
    seen = []
    real = TA._backward_two_pass
    monkeypatch.setattr(TA, "_backward_two_pass", lambda *a: seen.append(1) or real(*a))
    rng = np.random.default_rng(11)
    qkv = rng.standard_normal((1, s, (h + 2 * kv) * d)).astype(np.float32)
    g = rng.standard_normal((1, s, h * d)).astype(np.float32)
    x = torch.tensor(qkv, requires_grad=True)
    out = TA.flash_attention_qkv(x, h, kv, causal=True, rope_theta=10000.0)
    (got,) = torch.autograd.grad(out, x, torch.tensor(g))
    assert seen == [1]
    _, vjp = jax.vjp(lambda t: JA.flash_attention_qkv(t, h, kv, causal=True, interpret=True,
                                                      block_q=BLOCK, block_kv=BLOCK,
                                                      rope_theta=10000.0), jnp.asarray(qkv))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    sections = np.cumsum([h * d, kv * d])
    for name, a, w in zip(("dq", "dk", "dv"), np.split(got.numpy(), sections, -1),
                          np.split(want, sections, -1)):
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(a, w, atol=1e-4, rtol=0, err_msg=name)


def test_cpu_bf16_calls_above_256_launch_no_kernel():
    """bf16 at head_dim 320 and 512 — the new forward's calls on the card —
    runs the plain versions for CPU tensors, launching and counting
    nothing."""
    before = dict(TA.KERNEL_LAUNCHES), dict(TA.SOURCE_LAUNCHES)
    for d in (320, 512):
        qkv = torch.randn(1, 32, 3 * 2 * d).to(torch.bfloat16).requires_grad_(True)
        TA.flash_attention_qkv(qkv, 2, 2, causal=True).float().sum().backward()
        assert qkv.grad is not None
    assert (dict(TA.KERNEL_LAUNCHES), dict(TA.SOURCE_LAUNCHES)) == before
