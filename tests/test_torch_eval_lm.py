"""The port's ``cli/eval_lm.py`` and the eval half of its text dataset
against the JAX package's ``tools/eval_lm.py`` and ``data/text.py``.

A bundle exported by the JAX package from numpy-seeded weights (2 layers,
d_model 32, 4 heads, seq 16) is scored by both tools on the same file: the
same JSON keys, ``text_file`` and ``tokens_scored``, and rounded values
equal to the last place (one unit apart at most, where the two f32 sums
round on either side of a boundary).
"""

import json

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.data import text as JX
from distributed_tensorflow_tpu.train import checkpoint as JC
from distributed_tensorflow_tpu_torch.cli import eval_lm
from distributed_tensorflow_tpu_torch.data import text as TX
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import transformer_params_to_jax

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

CONFIG = {"vocab_size": 256, "d_model": 32, "num_heads": 4, "num_kv_heads": 0,
          "attention_window": 0, "use_bias": 0, "rope": 1, "rope_theta": 10000.0,
          "num_layers": 2, "d_ff": 64, "max_seq_len": 16}


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A JAX-exported bundle of numpy-seeded weights, and a text file."""
    d = tmp_path_factory.mktemp("eval")
    cfg = TT.TransformerConfig(vocab_size=256, d_model=32, num_heads=4, num_layers=2, d_ff=64,
                               max_seq_len=16, use_bias=False, position="rope")
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32),
        transformer_params_to_jax(TT.TransformerLM(cfg, device="cpu")))
    path = str(d / "lm.msgpack")
    JC.export_inference_bundle(path, params, metadata={
        "model": "TransformerLM", "parallelism": "dp", "config": CONFIG})
    text = d / "c.txt"
    text.write_bytes(bytes(rng.integers(32, 127, 1000).astype(np.uint8)))
    return path, str(text)


@pytest.mark.parametrize("flags", [["--batch_size", "3"],
                                   ["--batch_size", "4", "--holdout_fraction", "0"]])
def test_eval_lm_prints_the_jax_json(bundle, flags, capsys):
    import tools.eval_lm as jax_eval

    path, text = bundle
    argv = ["--model", path, "--text_file", text, *flags]
    want_nll = jax_eval.main(argv)
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    got_nll = eval_lm.main([*argv, "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert got.keys() == want.keys()
    assert (got["text_file"], got["tokens_scored"]) == (want["text_file"], want["tokens_scored"])
    # The rounded values: equal, or one unit of the last place apart where
    # the two f32 sums' last bits straddle a rounding boundary (perplexity
    # 270 moves its 4th decimal at 2e-7 relative).
    for key in ("nll_per_byte", "perplexity", "bits_per_byte"):
        assert abs(got[key] - want[key]) <= 1.0001e-4, key
    assert got["tokens_scored"] == (15 * 62 if "0" in flags else 15 * 3)
    assert got_nll == pytest.approx(want_nll, rel=1e-6)


def test_eval_lm_raises_without_a_card_unless_cpu_is_asked(bundle):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="--device cpu"):
        eval_lm.main(["--model", bundle[0], "--text_file", bundle[1]])


def test_eval_lm_exits_on_a_tp_bundle_or_a_short_holdout(tmp_path, bundle):
    state, meta = JC.load_inference_bundle(bundle[0])
    tp = str(tmp_path / "tp.msgpack")
    JC.export_inference_bundle(tp, state, metadata={**meta, "parallelism": "tp"})
    with pytest.raises(SystemExit, match="tp bundles use a different param factorization"):
        eval_lm.main(["--model", tp, "--text_file", bundle[1], "--device", "cpu"])
    with pytest.raises(SystemExit, match="holdout too short"):
        eval_lm.main(["--model", bundle[0], "--text_file", bundle[1], "--device", "cpu",
                      "--holdout_fraction", "0.01"])


@pytest.mark.parametrize("n,batch", [(1000, 3), (1000, 8), (160, 4)])
def test_eval_batches_match_the_jax_dataset(n, batch):
    tokens = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    ours, ref = TX.ByteTextDataset(tokens, 16, 0.2), JX.ByteTextDataset(tokens, 16, 0.2)
    np.testing.assert_array_equal(ours.eval_tokens, ref.eval_tokens)
    got, want = list(ours.eval_batches(batch)), list(ref.eval_batches(batch))
    assert [b.shape for b in got] == [b.shape for b in want]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_encode_decode_match_jax():
    s = "héllo, wörld — ✓"
    np.testing.assert_array_equal(TX.encode_text(s), JX.encode_text(s))
    ids = np.concatenate([TX.encode_text(s), [0xFF, 300]])
    assert TX.decode_tokens(ids) == JX.decode_tokens(ids)
    assert TX.decode_tokens(TX.encode_text(s)) == s
