"""The warpgroup forward's dispatch and its rotate-once design, on the CPU.

bf16 calls at head_dim 64, 128 or 256 run ``csrc/flash_fwd_sm90.cu`` on the card
(:func:`forward_kernel`; at 384 and 512 ``csrc/flash_fwd_cols_sm90.cu``); under rope that kernel rotates k once a call
(``flash_fwd_rotate_k``) and q inside its blocks. What can be checked here,
with no card: the dispatch table; the plain version of the rotate pass
against the JAX package's ``ops/rope.py::apply_rope`` on the same numpy
inputs cast to bf16 (bit for bit: both rotate in f32 and round once); the
composition the kernel relies on (the plain forward on q and k rotated
beforehand equals the plain rope forward, bit for bit); the bf16 slice as a
whole — ``flash_attention_qkv`` with GQA, window and rope at head_dim 64,
forward and backward — against the JAX function in interpret mode (2e-2 of
the largest |out| and 3e-2 of the largest |dqkv|, chip_smoke.py's bf16 limits:
the two round p, dS and the rotated operands to bf16 at different places);
and that CPU calls launch no kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import attention as JA
from distributed_tensorflow_tpu.ops import rope as JR
from distributed_tensorflow_tpu_torch.ops import _build
from distributed_tensorflow_tpu_torch.ops import attention as TA

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)


@pytest.mark.parametrize("case", [
    ((torch.bfloat16, 128), "flash_fwd_sm90"),
    ((torch.bfloat16, 64), "flash_fwd_sm90"),
    ((torch.bfloat16, 32), "flash_fwd"),
    ((torch.float32, 128), "flash_fwd"),
    ((torch.float32, 64), "flash_fwd"),
    ((torch.float32, 32), "flash_fwd"),
    ((torch.bfloat16, 256), "flash_fwd_sm90"),
    ((torch.float32, 256), "flash_fwd"),
    ((torch.bfloat16, 384), "flash_fwd_cols_sm90"),
    ((torch.bfloat16, 512), "flash_fwd_cols_sm90"),
    ((torch.float32, 384), "flash_fwd_dstream"),
    ((torch.float32, 512), "flash_fwd_dstream"),
    ((torch.bfloat16, 640), "flash_fwd_dstream"),
    ((torch.float32, 640), "flash_fwd_dstream"),
])
def test_forward_kernel_dispatch(case):
    args, want = case
    assert TA.forward_kernel(*args) == want


@pytest.mark.parametrize("dh,want", [(80, "flash_fwd_sm90"), (48, "flash_fwd_sm90"),
                                     (20, "flash_fwd"), (160, "flash_fwd_sm90")])
def test_padded_head_dims_dispatch_at_their_instance(dh, want):
    """dh 80 runs the instance 128, dh 48 the instance 64 and dh 160 the
    instance 256 (all bf16 on the warpgroup kernel); dh 20 runs the instance
    32 on flash_fwd.cu."""
    assert TA.forward_kernel(torch.bfloat16, TA._instance_dim(dh)) == want


def test_warpgroup_forward_source_is_built():
    assert {"flash_fwd", "flash_fwd_sm90", "flash_bwd_sm90"} <= set(_build.sources())
    assert _build.library_path("flash_fwd_sm90").name.startswith("flash_fwd_sm90-")
    for name in ("flash_fwd_sm90", "flash_bwd_sm90"):  # both on the shared header
        assert '#include "sm90_common.cuh"' in (_build.CSRC / f"{name}.cu").read_text()


def _tables(b, s, half, seed):
    """f32 (b, s, half) tables from numpy: the same values for both packages."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, (b, s, half)).astype(np.float32)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@pytest.mark.parametrize("tb,d", [(1, 64), (2, 128), (1, 256)])
def test_rotate_k_reference_matches_jax_apply_rope(tb, d):
    """The rotate pass's plain version on (B, KV, S, D) bf16 k, shared (1)
    or per-batch (2) tables, against JAX's apply_rope on the (B, S, KV, D)
    layout of the same bf16 values: equal bit for bit."""
    b, kv, s = 2, 3, 40
    rng = np.random.default_rng(tb * d)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    cos, sin = _tables(tb, s, d // 2, seed=d)
    want = JR.apply_rope(jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(cos), jnp.asarray(sin))
    kt = torch.tensor(k).to(torch.bfloat16).transpose(1, 2)  # a strided BHSD view
    got = TA.rotate_k_reference(kt, torch.tensor(cos), torch.tensor(sin))
    assert got.is_contiguous() and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.transpose(1, 2).float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# name -> (h, kv, sq, skv, causal, window, q_pos_offset)
COMPOSE = {
    "causal_gqa": (4, 2, 24, 24, True, None, None),
    "window_gqa": (4, 1, 24, 24, True, 5, None),
    "cross_offset": (2, 2, 8, 32, True, None, 10),
    "noncausal_cross": (2, 1, 12, 20, False, None, 3),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(COMPOSE))
def test_rope_forward_is_q_rotated_against_k_rotated_once(case, dtype):
    """The plain rope forward equals the plain forward, without tables, on q
    rotated at its rows' positions and k rotated once by the rotate pass's
    plain version — out and lse bit for bit: what the warpgroup kernel
    computes, q rotated in its blocks and k read from the rotated scratch."""
    h, kv, sq, skv, causal, window, off = COMPOSE[case]
    d, b = 16, 2
    rng = np.random.default_rng(7)
    q = torch.tensor(rng.standard_normal((b, h, sq, d)), dtype=torch.float32).to(dtype)
    k, v = (torch.tensor(rng.standard_normal((b, kv, skv, d)), dtype=torch.float32).to(dtype)
            for _ in range(2))
    cos, sin = (torch.tensor(t) for t in _tables(b, skv, d // 2, seed=3))
    pos = TA._offset(sq, skv, off)
    want = TA.flash_forward_reference(q, k, v, causal, window, None, off, cos, sin)
    got = TA.flash_forward_reference(TA._rotate(q, cos, sin, pos),
                                     TA.rotate_k_reference(k, cos, sin), v, causal, window, None,
                                     off)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bf16_flash_qkv_at_d64_matches_jax():
    """The slice as a whole in bf16 at head_dim 64 (the instance the
    warpgroup kernels take on the card): ``flash_attention_qkv`` with GQA,
    a window and rope tables, forward and backward, against the JAX function
    in interpret mode on the same numpy inputs."""
    b, s, h, kv, d, window = 2, 64, 4, 2, 64, 24
    rng = np.random.default_rng(0)
    qkv = rng.standard_normal((b, s, (h + 2 * kv) * d)).astype(np.float32)
    g = rng.standard_normal((b, s, h * d)).astype(np.float32)
    cos, sin = _tables(1, s, d // 2, seed=1)
    x = jnp.asarray(qkv).astype(jnp.bfloat16)
    out_j, vjp = jax.vjp(
        lambda t: JA.flash_attention_qkv(t, h, kv, causal=True, interpret=True, window=window,
                                         rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin)),
        x)
    (dqkv_j,) = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    xt = torch.tensor(qkv).to(torch.bfloat16).requires_grad_(True)
    out_t = TA.flash_attention_qkv(xt, h, kv, causal=True, window=window,
                                   rope_cos=torch.tensor(cos), rope_sin=torch.tensor(sin))
    (dqkv_t,) = torch.autograd.grad(out_t, xt, torch.tensor(g).to(torch.bfloat16))
    for got, want, tol in ((out_t, out_j, 2e-2), (dqkv_t, dqkv_j, 3e-2)):
        want = np.asarray(want.astype(jnp.float32))
        got = got.detach().float().numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_cpu_bf16_calls_launch_no_kernel(monkeypatch):
    """bf16 at head_dim 64 — the warpgroup kernels' calls on the card — runs
    the plain versions for CPU tensors through every public op and the
    two-pass route (K5/K6), launching nothing and counting nothing."""
    before = dict(TA.KERNEL_LAUNCHES), dict(TA.SOURCE_LAUNCHES)
    cos, sin = (torch.tensor(t) for t in _tables(1, 32, 32, seed=2))
    qkv = torch.randn(1, 32, 4 * 64).to(torch.bfloat16).requires_grad_(True)
    TA.flash_attention_qkv(qkv, 2, 1, causal=True, rope_cos=cos, rope_sin=sin).float().sum() \
        .backward()
    q, k, v = (torch.randn(1, 2, 32, 64).to(torch.bfloat16).requires_grad_(True)
               for _ in range(3))
    TA.flash_attention(q, k, v, causal=True).float().sum().backward()
    monkeypatch.setattr(TA, "_FUSED_BWD_SCRATCH_LIMIT", 1)  # no fused route: the two-pass pair
    qs, ks, vs = (torch.randn(1, 32, 2, 64).to(torch.bfloat16).requires_grad_(True)
                  for _ in range(3))
    TA.flash_attention_bshd(qs, ks, vs, causal=True).float().sum().backward()
    assert all(t.grad is not None for t in (qkv, q, qs))
    assert (dict(TA.KERNEL_LAUNCHES), dict(TA.SOURCE_LAUNCHES)) == before
    assert set(before[0].values()) == set(before[1].values()) == {0}
    assert "flash_fwd_sm90" in before[1]
