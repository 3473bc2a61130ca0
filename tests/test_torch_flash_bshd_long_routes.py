"""The port's long-sequence backward routes on the BHSD op and the plain
two-pass pair, against the JAX package's (split out of
tests/test_torch_flash_bshd_long.py, whose docstring, gate and tolerance
these tests share, so that the two halves run on two test workers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import attention as JA
from distributed_tensorflow_tpu_torch.ops import attention as TA
from distributed_tensorflow_tpu_torch.ops import rope as TR
from test_torch_flash_bshd_long import BLOCK, TOL, gate, routes  # noqa: F401 (fixtures)

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)


BHSD_CASES = {  # name -> (sq, skv, causal, window)
    "causal": (64, 64, True, None),
    "window": (64, 64, True, 24),
    "cross_32_64": (32, 64, True, None),
}


@pytest.mark.parametrize("route", ["segments", "two_pass"])
@pytest.mark.parametrize("case", sorted(BHSD_CASES))
def test_flash_attention_long_routes_match_jax(gate, routes, route, case):
    """``flash_attention`` (the tp path's BHSD op) on its segmented branch
    (K4 per q segment) and its two-pass branch (K5/K6)."""
    sq, skv, causal, window = BHSD_CASES[case]
    d = 16
    # d 16: 1 KiB of scratch a row, so sq/2 KiB allows two segments.
    gate(sq // 2 * 1024 if route == "segments" else 0, two_pass=route == "two_pass")
    rng = np.random.default_rng(9)
    q, g = (rng.standard_normal((2, 2, sq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, 2, skv, d)).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(lambda a, b_, c: JA.flash_attention(
        a, b_, c, causal=causal, block_q=BLOCK, block_kv=BLOCK, interpret=True, window=window),
        *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(g))
    ts = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    out = TA.flash_attention(*ts, causal=causal, window=window)
    got = torch.autograd.grad(out, ts, torch.tensor(g))
    off = skv - sq
    if route == "segments":
        assert routes == [("fused", "bhsd_bwd", off + a) for a in (0, sq // 2)]
    else:
        assert routes == [("two_pass", off)]
    for name, t, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", ["causal", "window", "cross_32_64"])
def test_plain_two_pass_matches_fused_and_jax(case):
    """The plain K5 and K6 on a GQA + rope q segment equal the plain fused
    backward on it; without rope and GQA they equal the JAX package's
    two-pass kernels (``_flash_backward`` with no segmentation)."""
    sq, skv, causal, window = BHSD_CASES[case]
    rng = np.random.default_rng(5)
    q, g = (torch.tensor(rng.standard_normal((1, 4, 16, 16)), dtype=torch.float32)
            for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((1, 2, skv, 16)), dtype=torch.float32)
            for _ in range(2))
    cos, sin = TR.rope_tables(16, skv, 500000.0)
    off = skv - 16 - 8  # a segment ending 8 rows before the last key
    args = (causal, window, None, off, cos, sin)
    out, lse = TA.flash_forward_reference(q, k, v, *args)
    fused = TA.flash_backward_reference(q, k, v, out, lse, g, *args)
    two_pass = (TA.flash_backward_dq_reference(q, k, v, out, lse, g, *args),
                *TA.flash_backward_dkv_reference(q, k, v, out, lse, g, *args))
    for name, t, w in zip(("dq", "dk", "dv"), two_pass, fused):
        np.testing.assert_allclose(t.numpy(), w.numpy(), atol=1e-6, rtol=0, err_msg=name)

    q, g = (rng.standard_normal((2, 2, sq, 16)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, 2, skv, 16)).astype(np.float32) for _ in range(2))
    tq, tk, tv, tg = (torch.tensor(t) for t in (q, k, v, g))
    out, lse = TA.flash_forward_reference(tq, tk, tv, causal, window)
    got = (TA.flash_backward_dq_reference(tq, tk, tv, out, lse, tg, causal, window),
           *TA.flash_backward_dkv_reference(tq, tk, tv, out, lse, tg, causal, window))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "_FUSED_BWD_SCRATCH_LIMIT", 0)
        want = JA._flash_backward(*(jnp.asarray(t) for t in (q, k, v, out.numpy())),
                                  jnp.asarray(lse.numpy()), jnp.asarray(g), causal, BLOCK, BLOCK,
                                  None, True, window=window)
    for name, t, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=TOL, rtol=0, err_msg=name)
