"""The port's TransformerLM against the JAX package's, on the CPU in f32.

flax parameters are carried into the port through ``models/convert.py``;
both models then see the same numpy-seeded tokens. Logits agree within
1e-4 absolute, the loss within 1e-5, and every parameter gradient within
2e-4 of the largest gradient magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import transformer as JT
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import (
    transformer_params_from_jax,
    transformer_params_to_jax,
)

pytestmark = pytest.mark.torch_port

B, S = 2, 64
SHAPE = dict(vocab_size=32, d_model=64, num_heads=4, num_layers=2, d_ff=128, max_seq_len=S)
CASES = {
    "learned_dense": dict(position="learned", attention="dense"),
    "learned_flash": dict(position="learned", attention="flash"),
    "rope_gqa_window_dense": dict(position="rope", attention="dense", num_kv_heads=2,
                                  attention_window=16),
    "rope_gqa_window_flash": dict(position="rope", attention="flash", num_kv_heads=2,
                                  attention_window=16),
}


def _pair(case, seed=0):
    kw = dict(SHAPE, **CASES[case])
    jcfg = JT.TransformerConfig(compute_dtype=jnp.float32, **kw)
    tcfg = TT.TransformerConfig(compute_dtype=torch.float32, **kw)
    params = jax.device_get(
        JT.TransformerLM(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))[
            "params"
        ]
    )
    model = TT.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(transformer_params_from_jax(params))
    tokens = np.random.default_rng(seed).integers(0, SHAPE["vocab_size"], (B, S)).astype(np.int32)
    return jcfg, params, model, tokens


def _jax_loss(jcfg, params, tokens):
    logits = JT.TransformerLM(jcfg).apply({"params": params}, tokens)
    return JT.next_token_loss(logits, tokens), logits


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_and_loss_match_jax(case):
    jcfg, params, model, tokens = _pair(case)
    want_loss, want_logits = _jax_loss(jcfg, params, jnp.asarray(tokens))
    t = torch.from_numpy(tokens)
    logits = model(t)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=0)
    loss = TT.next_token_loss(logits, t)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["learned_flash", "rope_gqa_window_flash"])
def test_param_gradients_match_jax(case):
    jcfg, params, model, tokens = _pair(case, seed=1)
    want = jax.grad(lambda p: _jax_loss(jcfg, p, jnp.asarray(tokens))[0])(params)
    want = jax.tree_util.tree_map(np.asarray, want)
    t = torch.from_numpy(tokens)
    TT.next_token_loss(model(t), t).backward()
    got = transformer_params_to_jax(model, grads=True)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(got_leaves) == {p for p, _ in want_leaves}
    scale = max(float(np.abs(w).max()) for _, w in want_leaves)
    for path, w in want_leaves:
        np.testing.assert_allclose(got_leaves[path], w, atol=2e-4 * scale, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_params_round_trip_through_the_bridge():
    _, params, model, _ = _pair("rope_gqa_window_flash")
    back = transformer_params_to_jax(model)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


def test_config_rejects_unknown_choices():
    with pytest.raises(ValueError, match="position"):
        TT.TransformerConfig(position="rotary")
    with pytest.raises(ValueError, match="attention"):
        TT.TransformerConfig(attention="blockwise")
    with pytest.raises(ValueError, match="num_kv_heads"):
        TT.TransformerConfig(num_heads=4, num_kv_heads=3)
