"""The `wide` path — Gemma 7B's attention width (16 heads of 256) at its 8192
context — against the JAX package on the CPU.

At seq 8192 and head_dim 256 both packages' backward gate sends the packed
backward to the fused BSHD kernel on q segments of 1024 rows (K8). A cut of
that path, a training step of TransformerLM at d_model 512 over 2 heads of
256 with rope θ 10000, 2 layers, seq 256, bias-free, f32, goes through
both packages from the same weights (the port's, seeded, carried to the
JAX model by ``models/convert.py``) and the same numpy-seeded tokens, with
both gates lowered together so that the backward takes the same segmented
route. The JAX side runs its Pallas kernels in interpret mode (blocks of
64); the port takes the plain versions of its kernels on CPU tensors. The
loss agrees within 1e-5 absolute and every parameter gradient within 2e-4
of the largest gradient magnitude, the limits of
tests/test_torch_transformer.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import transformer as JT
from distributed_tensorflow_tpu.ops import attention as JA
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import transformer_params_to_jax
from distributed_tensorflow_tpu_torch.ops import attention as TA

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

BLOCK = 64  # the JAX side's block_q/block_kv, and the port's gate block to match
D, S = 256, 256
# d_model 512 over 2 heads of 256; the repo's block (LayerNorm, GELU MLP at 4x).
SHAPE = dict(vocab_size=256, d_model=2 * D, num_heads=2, num_layers=2, d_ff=8 * D,
             max_seq_len=S, use_bias=False, position="rope", rope_theta=10000.0,
             attention="flash")


def test_wide_path_gate_takes_k8_on_eight_segments(monkeypatch):
    """At Gemma 7B's context and head width the packed backward leaves the
    one-call kernel (its whole-sequence dq scratch would not fit the gate's
    2 MiB) for q segments of 1024 rows, on both packages."""
    monkeypatch.delenv("LIBTPU_INIT_ARGS", raising=False)
    assert TA._fused_bwd_scratch_limit() == JA._fused_bwd_scratch_limit()
    assert 8192 * TA._dq_scratch_bytes_per_row(D) > TA._fused_bwd_scratch_limit()
    assert 8192 * JA._dq_scratch_bytes_per_row(D) > JA._fused_bwd_scratch_limit()
    want = JA._fused_segment_rows(8192, D, JA._fit_block(1024, 8192))
    assert TA._segment_rows(8192, D) == want == 1024


def _jax_flash_in_interpret_mode(monkeypatch):
    """The JAX model's packed flash call with blocks of BLOCK rows, in
    interpret mode."""
    real = JA.flash_attention_qkv

    def flash(*args, **kw):
        return real(*args, block_q=BLOCK, block_kv=BLOCK, interpret=True, **kw)

    monkeypatch.setattr(JA, "flash_attention_qkv", flash)


def test_wide_path_training_step_matches_jax(monkeypatch):
    monkeypatch.delenv("LIBTPU_INIT_ARGS", raising=False)
    # 128 rows of dq scratch (1536 bytes a row at head_dim 256): the 256 rows
    # take two q segments of 128 on both sides.
    limit = 128 * TA._dq_scratch_bytes_per_row(D)
    for mod in (JA, TA):
        monkeypatch.setattr(mod, "_FUSED_BWD_SCRATCH_LIMIT", limit)
    monkeypatch.setattr(TA, "_GATE_BLOCK", BLOCK)
    assert TA._segment_rows(S, D) == JA._fused_segment_rows(S, D, JA._fit_block(BLOCK, S)) == 128
    _jax_flash_in_interpret_mode(monkeypatch)
    calls = []
    fused = TA._backward
    monkeypatch.setattr(TA, "_backward",
                        lambda counter, *a: calls.append((counter, a[11])) or fused(counter, *a))

    # The port's seeded weights, carried to the JAX model.
    model = TT.TransformerLM(TT.TransformerConfig(compute_dtype=torch.float32, **SHAPE), seed=0,
                             device="cpu")
    assert model.cfg.head_dim == D
    params = transformer_params_to_jax(model)
    jcfg = JT.TransformerConfig(compute_dtype=jnp.float32, **SHAPE)
    tokens = np.random.default_rng(3).integers(0, SHAPE["vocab_size"], (1, S)).astype(np.int32)

    def jax_loss(p):
        return JT.next_token_loss(JT.TransformerLM(jcfg).apply({"params": p}, tokens), tokens)

    want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(params)
    want = jax.tree_util.tree_map(np.asarray, want)

    t = torch.from_numpy(tokens)
    loss = TT.next_token_loss(model(t), t)
    loss.backward()
    # Each layer's backward: the fused call on the two q segments (K8).
    assert calls == [("bshd_bwd", 0), ("bshd_bwd", 128)] * SHAPE["num_layers"]
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), atol=1e-5, rtol=0)
    got = dict(jax.tree_util.tree_leaves_with_path(transformer_params_to_jax(model, grads=True)))
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert set(got) == {p for p, _ in want_leaves}
    scale = max(float(np.abs(w).max()) for _, w in want_leaves)
    for path, w in want_leaves:
        np.testing.assert_allclose(got[path], w, atol=2e-4 * scale, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
