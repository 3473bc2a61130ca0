"""K6 above head_dim 256 on the warpgroup kernel, on the CPU.

bf16 K6 (the two-pass pair's dk/dv half) at head_dim 384 and 512, and at
every head dim padded to them (257-512), runs
``csrc/flash_bwd_cols_sm90.cu`` on the card; the fused backward with dq,
f32, and head dims above 512 stay on ``csrc/flash_bwd_dstream.cu``. What can
be checked here, with no card: the dispatch, the new source's build entry
and launch counter, and the two-pass route itself above 256 — forced on
both packages by lowering the gate — against the JAX package's
``_flash_backward`` two-pass in interpret mode on the same numpy inputs:
f32 at head_dim 384 with GQA, rope and a window and at 512, to 1e-4
absolute (the tolerance of the d 256 route test), and bf16 at 512 to 3e-2
of the largest |dqkv| (chip_smoke.py's bf16 limit).
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

BLOCK = 64


@pytest.mark.parametrize("dh,dtype,want_dq,want", [
    (384, torch.bfloat16, False, "flash_bwd_cols_sm90"),
    (512, torch.bfloat16, False, "flash_bwd_cols_sm90"),
    (320, torch.bfloat16, False, "flash_bwd_cols_sm90"),
    (257, torch.bfloat16, False, "flash_bwd_cols_sm90"),
    (384, torch.bfloat16, True, "flash_bwd_dstream"),
    (512, torch.bfloat16, True, "flash_bwd_dstream"),
    (384, torch.float32, False, "flash_bwd_dstream"),
    (512, torch.float32, False, "flash_bwd_dstream"),
    (640, torch.bfloat16, False, "flash_bwd_dstream"),
])
def test_k6_above_256_dispatch(dh, dtype, want_dq, want):
    """bf16 K6 at the instances 384 and 512 runs the warpgroup kernel; with dq
    (K2/K4/K8), in f32 and above 512 the column-group kernel."""
    assert TA.backward_kernel(dtype, TA._instance_dim(dh), want_dq) == want


def test_k6_warpgroup_source_is_built_and_counted():
    assert "flash_bwd_cols_sm90" in _build.sources()
    assert "flash_bwd_cols_sm90" in TA.SOURCE_LAUNCHES
    assert _build.library_path("flash_bwd_cols_sm90").name.startswith("flash_bwd_cols_sm90-")
    text = (_build.CSRC / "flash_bwd_cols_sm90.cu").read_text()
    assert '#include "sm90_common.cuh"' in text and '#include "flash_dstream.cuh"' in text
    # the column-group backward's C contract, scratches included
    assert TA._SOURCE_ARGTYPES["flash_bwd_cols_sm90"] is TA._SOURCE_ARGTYPES["flash_bwd_dstream"]
    assert TA._scratch_specs("flash_bwd_cols_sm90", torch.bfloat16, 2, 4, 2, 16, 24, 512, True) \
        == (((2, 4, 16, 512), torch.bfloat16), ((2, 2, 24, 512), torch.bfloat16),
            ((2, 2, 24, 512), torch.float32))


def _tables(s, half, seed):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, (1, s, half)).astype(np.float32)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@pytest.mark.parametrize("d,h,kv,window,rope,dtype", [
    (384, 4, 2, 48, True, "float32"),
    (512, 2, 2, None, False, "float32"),
    (512, 2, 1, None, False, "bfloat16"),
])
def test_two_pass_route_above_256_matches_jax(monkeypatch, d, h, kv, window, rope, dtype):
    """K6 then K5 above 256 — the route bf16 K6 at 384/512 serves on the
    card — forced on both packages by a gate of 32 dq rows (under the block
    of 64, so no q segmentation exists): dq, dk and dv of
    ``flash_attention_qkv`` against JAX's on the same route."""
    s = 128
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
    rng = np.random.default_rng(d + h)
    qkv = rng.standard_normal((1, s, (h + 2 * kv) * d)).astype(np.float32)
    g = rng.standard_normal((1, s, h * d)).astype(np.float32)
    cos, sin = _tables(s, d // 2, seed=d) if rope else (None, None)
    jkw = dict(rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin)) if rope else {}
    tkw = dict(rope_cos=torch.tensor(cos), rope_sin=torch.tensor(sin)) if rope else {}
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x = torch.tensor(qkv).to(tdt).requires_grad_(True)
    out = TA.flash_attention_qkv(x, h, kv, causal=True, window=window, **tkw)
    (got,) = torch.autograd.grad(out, x, torch.tensor(g).to(tdt))
    assert seen == [1]
    _, vjp = jax.vjp(lambda t: JA.flash_attention_qkv(t, h, kv, causal=True, interpret=True,
                                                      window=window, block_q=BLOCK,
                                                      block_kv=BLOCK, **jkw),
                     jnp.asarray(qkv).astype(jdt))
    want = np.asarray(vjp(jnp.asarray(g).astype(jdt))[0].astype(jnp.float32))
    got = got.float().numpy()
    sections = np.cumsum([h * d, kv * d])
    for name, a, w in zip(("dq", "dk", "dv"), np.split(got, sections, -1),
                          np.split(want, sections, -1)):
        assert np.abs(w).max() > 0, name
        if dtype == "float32":
            np.testing.assert_allclose(a, w, atol=1e-4, rtol=0, err_msg=name)
        else:
            assert np.abs(a - w).max() <= 3e-2 * np.abs(want).max(), name
