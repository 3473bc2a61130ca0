"""The pipelining probe (K9) at any head dim, on the CPU.

The JAX ``tools/pipeline_probe.py::pipe_flash_forward`` takes its head dim
from q's shape. On the card the port's K9 runs its kernels at head_dim 64,
128 and 256, pads any other head_dim up to 256 to the next of them, and
above 256 runs the shipped forward at that head dim
(``ops.attention._launch_pipe_forward``). Here the port's CPU path (the
plain version at the real head dim) and the padded computation the launch
makes (the plain version on zero-padded operands at the real head dim's
scale, the real columns taken back) are each held against the JAX function,
its Pallas kernel in interpret mode, at head dims 80 (padded to 128), 200
(to 256) and 320 (above 256: the forward's instance 384): B 1, 2 heads,
S 128, 64-row blocks, causal and non-causal, f32 inputs from a numpy seed,
1e-5 absolute. Then the source each instance runs.
"""

import functools

import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.ops import attention as TA
from distributed_tensorflow_tpu_torch.tools import pipeline_probe as TP

pytestmark = pytest.mark.torch_port

TOL = 1e-5


@pytest.fixture
def jax_pipe(monkeypatch):
    """The JAX probe's pipe_flash_forward with pallas_call in interpret mode."""
    monkeypatch.setenv("DTF_COMPILATION_CACHE", "0")
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        functools.partial(jax.experimental.pallas.pallas_call, interpret=True))
    from tools import pipeline_probe

    return pipeline_probe.pipe_flash_forward


def _inputs(d, seed, b=1, h=2, s=128):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))


def _padded_plain(q, k, v, causal):
    """What the launch computes: the operands padded to K9's instance, the
    plain version at the real head dim's scale, the real columns back."""
    d = q.shape[-1]
    dp = TA._pipe_instance_dim(d)
    assert dp != d
    padded = [TA.pad_head_dim(torch.from_numpy(t), dp) for t in (q, k, v)]
    out = TP.pipe_flash_forward_reference(*padded, causal, scale=d ** -0.5)
    return TA.unpad_head_dim(out, d).numpy()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("d", [80, 200, 320])
def test_pipe_flash_forward_matches_jax_at_padded_head_dims(jax_pipe, d, causal):
    q, k, v = _inputs(d, seed=d)
    want = np.asarray(jax_pipe(*(jnp.asarray(t) for t in (q, k, v)), causal=causal, block_q=64,
                               block_kv=64))
    got = TP.pipe_flash_forward(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal).numpy()
    assert got.shape == want.shape == (1, 2, 128, d)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(_padded_plain(q, k, v, causal), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("d,want", [(32, 64), (64, 64), (80, 128), (128, 128), (200, 256),
                                    (256, 256), (320, 384), (512, 512)])
def test_pipe_instance_dim(d, want):
    """K9's instances are 64, 128 and 256; above 256 it takes the forward's
    (the next multiple of 128)."""
    assert TA._pipe_instance_dim(d) == want


@pytest.mark.parametrize("case", [
    ((torch.bfloat16, 256), "flash_fwd_pipe_sm90"),
    ((torch.float32, 256), "flash_fwd_pipe"),
    ((torch.bfloat16, 384), "flash_fwd_cols_sm90"),
    ((torch.bfloat16, 512), "flash_fwd_cols_sm90"),
    ((torch.float32, 384), "flash_fwd_dstream"),
    ((torch.bfloat16, 640), "flash_fwd_dstream"),
])
def test_pipe_forward_kernel_names_every_instance(case):
    """At 256 K9's own kernels; above 256 the forward's source for that
    instance, which the call runs."""
    args, want = case
    assert TA.pipe_forward_kernel(*args) == want


@pytest.mark.parametrize("d", [80, 200, 320])
def test_pipe_padded_head_dims_on_cpu_launch_no_kernel(d):
    before, sources = dict(TA.KERNEL_LAUNCHES), dict(TA.SOURCE_LAUNCHES)
    q, k, v = (torch.from_numpy(t) for t in _inputs(d, seed=1))
    assert TP.pipe_flash_forward(q, k, v).shape == (1, 2, 128, d)
    assert TA.KERNEL_LAUNCHES == before and TA.SOURCE_LAUNCHES == sources
