"""The port's kernel probes (K9, K10) against the JAX package's.

The JAX side is the repo's ``tools/pipeline_probe.py`` (``pipe_flash_forward``)
and ``tools/bshd_probe.py`` (``bshd_forward``), their Pallas kernels run in
interpret mode on the CPU (``pallas_call`` patched with ``interpret=True``),
imported with the persistent compilation cache off. The port's side is
``distributed_tensorflow_tpu_torch.tools`` on CPU tensors: the plain
versions of the CUDA kernels. The same inputs, made from a numpy seed, go
through both. Everything is f32; tolerance 1e-5 absolute.
"""

import functools

import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import attention as JA
from distributed_tensorflow_tpu_torch.ops import attention as TA
from distributed_tensorflow_tpu_torch.tools import bshd_probe as TB
from distributed_tensorflow_tpu_torch.tools import pipeline_probe as TP

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

TOL = 1e-5


@pytest.fixture
def jax_probes(monkeypatch):
    """The JAX probe modules, with pallas_call in interpret mode."""
    monkeypatch.setenv("DTF_COMPILATION_CACHE", "0")
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        functools.partial(jax.experimental.pallas.pallas_call, interpret=True))
    from tools import bshd_probe, pipeline_probe

    return pipeline_probe, bshd_probe


def _inputs(shape_q, shape_kv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q).astype(np.float32)
    k = rng.standard_normal(shape_kv).astype(np.float32)
    v = rng.standard_normal(shape_kv).astype(np.float32)
    return q, k, v


def _jax_pipe(jp, q, k, v, causal, block_q, block_kv):
    out = jp.pipe_flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                block_q=block_q, block_kv=block_kv)
    return np.asarray(out)


def _port_pipe(q, k, v, causal):
    return TP.pipe_flash_forward(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal).numpy()


@pytest.mark.parametrize("blocks", [(64, 64), (64, 128), (128, 64)], ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_pipe_flash_forward_matches_jax(jax_probes, causal, blocks):
    q, k, v = _inputs((1, 2, 256, 64), (1, 2, 256, 64))
    want = _jax_pipe(jax_probes[0], q, k, v, causal, *blocks)
    got = _port_pipe(q, k, v, causal)
    assert got.shape == want.shape == (1, 2, 256, 64)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_pipe_flash_forward_cross_length_matches_jax(jax_probes):
    q, k, v = _inputs((1, 2, 128, 64), (1, 2, 256, 64), seed=1)
    want = _jax_pipe(jax_probes[0], q, k, v, True, 64, 64)
    got = _port_pipe(q, k, v, True)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_pipe_flash_forward_masked_rows_are_zero_as_in_jax(jax_probes):
    # Sq 256 > Skv 128: end-aligned, so the first 128 query rows attend no
    # key and both sides must give exact zeros there.
    q, k, v = _inputs((1, 2, 256, 64), (1, 2, 128, 64), seed=2)
    want = _jax_pipe(jax_probes[0], q, k, v, True, 64, 64)
    got = _port_pipe(q, k, v, True)
    assert not want[:, :, :128].any() and not got[:, :, :128].any()
    assert np.abs(got[:, :, 128:]).max() > 0
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_bshd_forward_matches_jax(jax_probes, monkeypatch):
    jb = jax_probes[1]
    b, h, s, dh, block = 2, 3, 256, 64, 64
    for name, val in dict(B=b, H=h, S=s, dh=dh, bq=block, bkv=block, num_q=s // block,
                          num_kv=s // block, s=1.0 / np.sqrt(dh)).items():
        monkeypatch.setattr(jb, name, val)
    q, k, v = _inputs((b, s, h * dh), (b, s, h * dh), seed=3)
    want_out, want_lse = (np.asarray(t) for t in jb.bshd_forward(*map(jnp.asarray, (q, k, v))))
    got_out, got_lse = (t.numpy() for t in TB.bshd_forward(*map(torch.from_numpy, (q, k, v)), h))
    assert got_out.shape == want_out.shape == (b, s, h * dh)
    assert got_lse.shape == want_lse.shape == (b * h, s, 1)
    assert got_lse.dtype == np.float32
    np.testing.assert_allclose(got_out, want_out, atol=TOL, rtol=0)
    np.testing.assert_allclose(got_lse, want_lse, atol=TOL, rtol=0)


# (sq, skv, causal): lengths no 64-row tile divides, as the CUDA kernel
# masks them and the TPU probe cannot take them.
RAGGED = {"causal_200": (200, 200, True), "cross_72_200": (72, 200, True),
          "masked_rows_200_72": (200, 72, True), "noncausal_136_200": (136, 200, False)}


@pytest.mark.parametrize("case", sorted(RAGGED))
def test_pipe_plain_version_matches_dense_at_ragged_lengths(case):
    sq, skv, causal = RAGGED[case]
    q, k, v = _inputs((2, 2, sq, 64), (2, 2, skv, 64), seed=4)
    got = _port_pipe(q, k, v, causal)
    want = np.asarray(JA.dense_attention(*(jnp.asarray(t) for t in (q, k, v)), causal=causal))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    ref, _ = TA.flash_forward_reference(*(torch.from_numpy(t) for t in (q, k, v)), causal)
    np.testing.assert_array_equal(got, ref.numpy())


def test_pipe_flash_forward_takes_no_kv_head_groups():
    q = torch.zeros(1, 4, 8, 64)
    k = v = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="heads"):
        TP.pipe_flash_forward(q, k, v)


def test_cpu_calls_launch_no_probe_kernel():
    before = dict(TA.KERNEL_LAUNCHES)
    q, k, v = (torch.randn(1, 2, 16, 64) for _ in range(3))
    assert TP.pipe_flash_forward(q, k, v).shape == (1, 2, 16, 64)
    x = torch.randn(1, 16, 2 * 64)
    out, lse = TB.bshd_forward(x, x, x, 2)
    assert out.shape == (1, 16, 128) and lse.shape == (2, 16, 1)
    assert TA.KERNEL_LAUNCHES == before
    assert TA.KERNEL_LAUNCHES["pipe_fwd"] == TA.KERNEL_LAUNCHES["probe_bshd_fwd"] == 0


@pytest.mark.parametrize("probe", [TP, TB], ids=["pipeline_probe", "bshd_probe"])
def test_probe_main_raises_without_a_card(probe):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main()
