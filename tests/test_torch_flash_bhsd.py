"""The port's BHSD flash attention (kernels K3/K4) against the JAX package's.

The same (B, H, S, D) inputs, made from a numpy seed, go through the JAX
``flash_attention`` / ``_flash_forward(with_lse=True)`` / ``jax.vjp`` (the
Pallas kernels in interpret mode, as tests/test_attention.py runs them) and
through the port's ``flash_attention`` on CPU tensors (the plain versions of
the CUDA kernels). Everything is f32. Tolerances, absolute: 1e-5 on out and
lse, 1e-4 on the gradients (their sums run over more products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import attention as JA
from distributed_tensorflow_tpu_torch.ops import attention as TA

pytestmark = pytest.mark.torch_port

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
BLOCK = 16  # JAX block size; _fit_block shrinks it to divide short sequences

# name -> (sq, skv, causal, window); the cross-length pairs and the masked
# shapes are tests/test_attention.py's.
CASES = {
    "causal": (64, 64, True, None),
    "noncausal": (64, 64, False, None),
    "window": (64, 64, True, 8),
    "cross_4_32": (4, 32, True, None),
    "cross_16_32": (16, 32, True, None),
    "cross_8_24": (8, 24, True, None),
    "cross_window_16_40": (16, 40, True, 6),
    "noncausal_cross_24_40": (24, 40, False, None),
    "fully_masked_rows_12_8": (12, 8, True, None),
    "mixed_masked_tile_16_8": (16, 8, True, None),
}


def _inputs(sq, skv, b=2, h=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    g = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return q, k, v, g


def _jax_side(q, k, v, g, causal, window):
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    out, lse = JA._flash_forward(jq, jk, jv, causal, BLOCK, BLOCK, None, True,
                                 with_lse=True, window=window)
    _, vjp = jax.vjp(
        lambda a, b_, c: JA.flash_attention(a, b_, c, causal=causal, block_q=BLOCK,
                                            block_kv=BLOCK, interpret=True, window=window),
        jq, jk, jv,
    )
    grads = vjp(jnp.asarray(g))
    return [np.asarray(t) for t in (out, lse, *grads)]


def _torch_side(q, k, v, g, causal, window):
    tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    out = TA.flash_attention(tq, tk, tv, causal=causal, window=window)
    _, lse = TA.flash_forward_reference(tq.detach(), tk.detach(), tv.detach(), causal, window)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(g))
    return [t.detach().numpy() for t in (out, lse, *grads)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_bhsd_matches_jax(case):
    sq, skv, causal, window = CASES[case]
    inputs = _inputs(sq, skv)
    want = _jax_side(*inputs, causal, window)
    got = _torch_side(*inputs, causal, window)
    for name, w, t in zip(("out", "lse", "dq", "dk", "dv"), want, got):
        assert t.shape == w.shape, name
        assert np.isfinite(t).all(), name
        tol = FWD_TOL if name in ("out", "lse") else GRAD_TOL
        np.testing.assert_allclose(t, w, atol=tol, rtol=0, err_msg=name)


def test_fully_masked_rows_are_zero_not_nan():
    """sq > skv, causal: the first sq - skv queries see no key. Their output
    and gradients are exactly 0 and every value is finite."""
    q, k, v, g = (torch.tensor(t) for t in _inputs(12, 8, seed=5))
    out, lse = TA.flash_forward_reference(q, k, v, causal=True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (out[:, :, :4] == 0).all() and (out[:, :, 4:] != 0).any()
    assert (lse[:, :, :4] <= TA.NEG_INF / 2).all()
    dq, dk, dv = TA.flash_backward_reference(q, k, v, out, lse, g, causal=True)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert (dq[:, :, :4] == 0).all()


@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 6)])
def test_segments_through_q_pos_offset_match_whole(causal, window):
    """K4 on q segments (each placed by q_pos_offset) gives the whole call's
    dq rows and, summed, its dk/dv — and each segment equals the JAX
    package's segment call of ``_flash_backward_fused``."""
    sq = skv = 64
    seg = 16
    q, k, v, g = (torch.tensor(t) for t in _inputs(sq, skv, seed=7))
    out, lse = TA.flash_forward_reference(q, k, v, causal, window)
    whole = TA.flash_backward_reference(q, k, v, out, lse, g, causal, window)
    dqs, dk, dv = [], 0, 0
    for a in range(0, sq, seg):
        rows = slice(a, a + seg)
        out_s, lse_s = TA.flash_forward_reference(q[:, :, rows], k, v, causal, window,
                                                  q_pos_offset=a)
        np.testing.assert_allclose(out_s.numpy(), out[:, :, rows].numpy(), atol=FWD_TOL, rtol=0)
        np.testing.assert_allclose(lse_s.numpy(), lse[:, :, rows].numpy(), atol=FWD_TOL, rtol=0)
        args = (q[:, :, rows], k, v, out[:, :, rows], lse[:, :, rows], g[:, :, rows])
        got = TA.flash_backward_reference(*args, causal, window, q_pos_offset=a)
        want = JA._flash_backward_fused(*(jnp.asarray(t.numpy()) for t in args), causal,
                                        BLOCK, BLOCK, None, True, q_pos_offset=a, window=window)
        for name, t, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=0,
                                       err_msg=f"segment {a}: {name}")
        dqs.append(got[0])
        dk, dv = dk + got[1], dv + got[2]
    np.testing.assert_allclose(torch.cat(dqs, dim=2).numpy(), whole[0].numpy(), atol=FWD_TOL,
                               rtol=0)
    np.testing.assert_allclose(dk.numpy(), whole[1].numpy(), atol=GRAD_TOL, rtol=0)
    np.testing.assert_allclose(dv.numpy(), whole[2].numpy(), atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("case", ["causal", "window", "cross_16_32", "fully_masked_rows_12_8"])
def test_grads_match_autograd_through_dense_attention(case):
    """``FlashAttention``'s explicit backward equals torch autograd through
    the port's ``dense_attention`` on the same inputs."""
    sq, skv, causal, window = CASES[case]
    q, k, v, g = _inputs(sq, skv, seed=3)

    def grads(fn):
        ts = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
        out = fn(*ts, causal=causal, window=window)
        return [out.detach(), *torch.autograd.grad(out, ts, torch.tensor(g))]

    for name, t, w in zip(("out", "dq", "dk", "dv"), grads(TA.flash_attention),
                          grads(TA.dense_attention)):
        tol = FWD_TOL if name == "out" else GRAD_TOL
        np.testing.assert_allclose(t.numpy(), w.numpy(), atol=tol, rtol=0, err_msg=name)


def test_flash_attention_rejects_bad_arguments():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="window requires causal"):
        TA.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="k and v must be"):
        TA.flash_attention(q, torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 8, 8))
    with pytest.raises(ValueError, match=r"\(B, H, S, head_dim\)"):
        TA.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        TA.flash_forward_kernel(q, q, q, causal=True)
