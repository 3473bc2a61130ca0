"""The port's flash attention against the JAX package's, on the CPU.

The same packed-qkv inputs, made from a numpy seed, go through the JAX
``flash_attention_qkv`` (its Pallas kernels in interpret mode, as
tests/test_attention.py runs them) and through the port's
``flash_attention_qkv`` (on CPU tensors: the plain versions of the CUDA
kernels). Everything is f32; tolerance 1e-4 absolute on out, lse and dqkv.
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

B, S, H, DH = 2, 64, 4, 32
TOL = 1e-4

CASES = {
    "causal": dict(kv=4, causal=True),
    "noncausal": dict(kv=4, causal=False),
    "window": dict(kv=4, causal=True, window=8),
    "gqa": dict(kv=2, causal=True),
    "rope_tables": dict(kv=4, causal=True, rope="tables"),
    "rope_theta": dict(kv=4, causal=True, rope="theta"),
    "gqa_window_rope": dict(kv=2, causal=True, window=8, rope="tables"),
}


def _inputs(kv, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, S, (H + 2 * kv) * DH)).astype(np.float32)
    g = rng.standard_normal((B, S, H * DH)).astype(np.float32)
    return qkv, g


def _rope_kwargs(mode, lib):
    if mode == "tables":
        if lib == "jax":
            cos, sin = JR.rope_tables(DH, S, 10000.0)
            return dict(rope_cos=cos, rope_sin=sin)
        cos, sin = TR.rope_tables(DH, S, 10000.0)
        return dict(rope_cos=cos, rope_sin=sin)
    if mode == "theta":
        return dict(rope_theta=10000.0)
    return {}


def _jax_side(qkv, g, kv, causal, window=None, rope=None):
    kw = _rope_kwargs(rope, "jax")
    x = jnp.asarray(qkv)
    _, lse = JA._flash_forward_qkv(
        x, H, kv, causal, 1024, 1024, None, True, with_lse=True, window=window, **kw
    )
    out, vjp = jax.vjp(
        lambda t: JA.flash_attention_qkv(t, H, kv, causal=causal, interpret=True,
                                         window=window, **kw),
        x,
    )
    (dqkv,) = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(lse).reshape(B, H, S), np.asarray(dqkv)


def _torch_side(qkv, g, kv, causal, window=None, rope=None):
    kw = _rope_kwargs(rope, "torch")
    x = torch.tensor(qkv, requires_grad=True)
    out = TA.flash_attention_qkv(x, H, kv, causal=causal, window=window, **kw)
    _, lse = TA.flash_forward_qkv_reference(x.detach(), H, kv, causal, window, **kw)
    (dqkv,) = torch.autograd.grad(out, x, torch.tensor(g))
    return out.detach().numpy(), lse.numpy(), dqkv.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_qkv_matches_jax(case):
    spec = dict(CASES[case])
    qkv, g = _inputs(spec["kv"])
    want = _jax_side(qkv, g, **spec)
    got = _torch_side(qkv, g, **spec)
    for name, w, t in zip(("out", "lse", "dqkv"), want, got):
        assert t.shape == w.shape, name
        np.testing.assert_allclose(t, w, atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", ["causal", "gqa_window_rope", "noncausal"])
def test_backward_reference_matches_autograd_of_plain_forward(case):
    """The explicit backward formula the CUDA kernel implements equals
    torch autograd through the plain forward."""
    spec = dict(CASES[case])
    kv, rope = spec.pop("kv"), spec.pop("rope", None)
    kw = _rope_kwargs(rope, "torch")
    qkv, g = _inputs(kv, seed=1)
    x = torch.tensor(qkv, requires_grad=True)
    out, lse = TA.flash_forward_qkv_reference(x, H, kv, **spec, **kw)
    (want,) = torch.autograd.grad(out, x, torch.tensor(g))
    got = TA.flash_backward_qkv_reference(
        x.detach(), out.detach(), lse.detach(), torch.tensor(g), H, kv, **spec, **kw
    )
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)


def test_dense_attention_matches_jax():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((B, H, S, DH)).astype(np.float32) for _ in range(3))
    for causal, window in ((False, None), (True, None), (True, 5)):
        want = JA.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, window=window)
        got = TA.dense_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                 causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_rope_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, H, DH)).astype(np.float32)
    jc, js = JR.rope_tables(DH, S, 500.0)
    tc, ts = TR.rope_tables(DH, S, 500.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=0)
    want = JR.apply_rope(jnp.asarray(x), jc, js)
    got = TR.apply_rope(torch.tensor(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_flash_qkv_rejects_bad_arguments():
    x = torch.zeros(1, 8, 6 * 16)
    with pytest.raises(ValueError, match="window requires causal"):
        TA.flash_attention_qkv(x, 2, causal=False, window=4)
    with pytest.raises(ValueError, match="multiple of num_kv_heads"):
        TA.flash_attention_qkv(torch.zeros(1, 8, 7 * 16), 3, 2, causal=True)
    with pytest.raises(ValueError, match="rope_cos must be"):
        TA.flash_attention_qkv(x, 2, causal=True, rope_cos=torch.zeros(1, 8, 4),
                               rope_sin=torch.zeros(1, 8, 4))
    with pytest.raises(ValueError, match="not both"):
        cos, sin = TR.rope_tables(16, 8)
        TA.flash_attention_qkv(x, 2, causal=True, rope_cos=cos, rope_sin=sin,
                               rope_theta=1e4)
