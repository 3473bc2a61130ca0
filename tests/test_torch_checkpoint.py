"""The port's checkpoints and inference bundles against the JAX package's.

The same numpy-seeded weights go through both packages at a small size (2
layers, d_model 32, 4 heads, seq 16): the msgpack codec writes flax's bytes,
bundles and committed steps written by either package load in the other
(logits within 1e-5 relative in f32), two tensor-parallel ranks written from
one process reassemble in the JAX reader, and the trainer resumes bitwise
on the CPU.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from distributed_tensorflow_tpu.models import transformer as JT
from distributed_tensorflow_tpu.train import checkpoint as JC
from distributed_tensorflow_tpu.utils import protowire as jpw
from distributed_tensorflow_tpu.utils.summary import read_records
from distributed_tensorflow_tpu_torch.cli import train_lm as cli
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import (
    tp_params_to_jax,
    transformer_params_to_jax,
)
from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
    TpTransformerLM,
    init_tp_params,
    shard_params,
)
from distributed_tensorflow_tpu_torch.train import checkpoint as TC
from distributed_tensorflow_tpu_torch.train import optimizers as TO
from distributed_tensorflow_tpu_torch.utils import faults, msgpack_state
from test_torch_train_lm import run_ranks

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

S = 16
CONFIG = {"vocab_size": 64, "d_model": 32, "num_heads": 4, "num_kv_heads": 2,
          "attention_window": 0, "use_bias": 1, "rope": 1, "rope_theta": 500.0,
          "num_layers": 2, "d_ff": 64, "max_seq_len": S}
META = {"model": "TransformerLM", "parallelism": "dp", "config": CONFIG}
CLI_SHAPE = ["--device", "cpu", "--seq_len", "16", "--batch_size", "2", "--d_model", "32",
             "--num_heads", "4", "--num_layers", "2", "--d_ff", "64", "--attention", "flash"]


def _cfg_kwargs():
    return dict(vocab_size=CONFIG["vocab_size"], d_model=32, num_heads=4, num_kv_heads=2,
                num_layers=2, d_ff=64, max_seq_len=S, position="rope", rope_theta=500.0)


@pytest.fixture(scope="module")
def params():
    """A numpy-seeded flax params tree of the small model."""
    model = TT.TransformerLM(TT.TransformerConfig(**_cfg_kwargs()), seed=0, device="cpu")
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        transformer_params_to_jax(model))


def _tokens(seed=1, b=2):
    return np.random.default_rng(seed).integers(0, CONFIG["vocab_size"], (b, S)).astype(np.int32)


@functools.cache
def _jax_apply():
    cfg = JT.TransformerConfig(compute_dtype=jnp.float32, **_cfg_kwargs())
    return jax.jit(lambda p, t: JT.TransformerLM(cfg).apply({"params": p}, t))


def _jax_logits(params, tokens):
    return np.asarray(_jax_apply()(params, jnp.asarray(tokens)))


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _assert_trees_equal(a, b):
    fa, ta = jax.tree_util.tree_flatten_with_path(a)
    fb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert ta == tb
    for (pa, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=jax.tree_util.keystr(pa))


# ---------------------------------------------------------------------------
# The msgpack codec.
# ---------------------------------------------------------------------------


def test_msgpack_bytes_equal_flax(params):
    tree = {**params, "extra": {"n": None, "t": True, "i": -129, "big": 2**40, "f": 1.25,
                                "s": "x" * 40, "scalar": np.float32(2.5), "count": np.int64(7),
                                "empty": np.zeros((0, 3), np.float32), "bytes": b"\x00\x01"}}
    want = serialization.msgpack_serialize(tree)
    assert msgpack_state.dumps(tree) == want
    _assert_trees_equal(msgpack_state.loads(want), serialization.msgpack_restore(want))
    _assert_trees_equal(serialization.msgpack_restore(msgpack_state.dumps(tree)),
                        msgpack_state.loads(want))


def test_msgpack_chunked_array_round_trips_both_ways(monkeypatch):
    monkeypatch.setattr(msgpack_state, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    arr = np.random.default_rng(2).standard_normal((5, 7)).astype(np.float32)  # 140 bytes
    tree = {"w": arr, "small": np.ones(3, np.float32)}
    ours, theirs = msgpack_state.dumps(tree), serialization.msgpack_serialize(tree)
    assert ours == theirs and b"__msgpack_chunked_array__" in ours
    np.testing.assert_array_equal(msgpack_state.loads(theirs)["w"], arr)
    np.testing.assert_array_equal(serialization.msgpack_restore(ours)["w"], arr)


# ---------------------------------------------------------------------------
# Inference bundles.
# ---------------------------------------------------------------------------


def test_jax_bundle_loads_in_the_port(tmp_path, params):
    path = str(tmp_path / "lm.msgpack")
    JC.export_inference_bundle(path, params, metadata=META)
    cfg, model, meta = TC.load_lm_bundle(path, device="cpu")
    assert meta == {"format": "dtf_tpu.params.v1", **META}
    assert (cfg.position, cfg.rope_theta, cfg.kv_heads, cfg.attention) == ("rope", 500.0, 2,
                                                                           "dense")
    tokens = _tokens()
    got = model(torch.from_numpy(tokens)).detach().numpy()
    assert _rel(got, _jax_logits(params, tokens)) <= 1e-5


def test_port_bundle_loads_in_jax_and_equals_jax_bytes(tmp_path, params):
    ours, theirs = str(tmp_path / "port.msgpack"), str(tmp_path / "jax.msgpack")
    n = TC.export_inference_bundle(ours, params, metadata=META)
    JC.export_inference_bundle(theirs, params, metadata=META)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read() and n == os.path.getsize(theirs)
    cfg, jparams, meta = JC.load_lm_bundle(ours)
    assert meta == TC.load_inference_bundle(ours)[1]
    tokens = _tokens(seed=3)
    model = TC.load_lm_bundle(ours, device="cpu")[1]
    got = model(torch.from_numpy(tokens)).detach().numpy()
    assert _rel(got, _jax_logits(jparams, tokens)) <= 1e-5


def test_tp_bundle_is_refused_with_the_jax_message(tmp_path, params):
    path = str(tmp_path / "tp.msgpack")
    TC.export_inference_bundle(path, params, metadata={**META, "parallelism": "tp"})
    with pytest.raises(ValueError) as ours:
        TC.load_lm_bundle(path, device="cpu")
    with pytest.raises(ValueError) as theirs:
        JC.load_lm_bundle(path)
    assert str(ours.value) == str(theirs.value) and "tp bundles" in str(ours.value)


def test_pp_bundle_unstacks_as_in_jax(tmp_path, params):
    from distributed_tensorflow_tpu.parallel import pipeline_parallel as jpp

    stacked = jax.device_get(jpp.stack_stage_params(params, num_stages=2))
    _assert_trees_equal(TC.unstack_stage_params(stacked), jpp.unstack_stage_params(stacked))
    path = str(tmp_path / "pp.msgpack")
    JC.export_inference_bundle(path, stacked, metadata={**META, "parallelism": "pp"})
    model = TC.load_lm_bundle(path, device="cpu")[1]
    tokens = _tokens(seed=4)
    got = model(torch.from_numpy(tokens)).detach().numpy()
    assert _rel(got, _jax_logits(params, tokens)) <= 1e-5


def test_quantized_bundle_is_not_ported_yet(tmp_path, params):
    path = str(tmp_path / "q.msgpack")
    meta = {**META, "config": {**CONFIG, "weight_dtype": "int8", "quant_group_size": 32}}
    TC.export_inference_bundle(path, params, metadata=meta)
    with pytest.raises(ValueError, match="not ported yet"):
        TC.load_lm_bundle(path, device="cpu")


# ---------------------------------------------------------------------------
# Committed steps.
# ---------------------------------------------------------------------------


def test_committed_steps_read_both_ways(tmp_path, params):
    tree = {"params": params, "global_step": np.int32(7),
            "opt": [np.arange(4, dtype=np.float32), {"m": torch.ones(2, 3)}]}
    want = {**tree, "opt": [tree["opt"][0], {"m": np.ones((2, 3), np.float32)}]}
    TC.write_committed_step(str(tmp_path / "port"), 7, tree)
    assert JC.list_committed_steps(str(tmp_path / "port")) == [7]
    _assert_trees_equal(JC.read_step(str(tmp_path / "port"), 7), want)
    JC.write_committed_step(str(tmp_path / "jax"), 3, want)
    assert TC.list_committed_steps(str(tmp_path / "jax")) == [3]
    _assert_trees_equal(TC.read_step(str(tmp_path / "jax"), 3), want)
    _assert_trees_equal(TC.read_step(str(tmp_path / "jax"), 3, template={"params": params}),
                        {"params": params})
    with pytest.raises(OSError, match="missing leaf"):
        TC.read_step(str(tmp_path / "jax"), 3, template={"nope": np.zeros(1)})


def test_uncommitted_step_is_invisible_to_both(tmp_path, params):
    d = str(tmp_path / "ck")
    TC.write_committed_step(d, 1, {"w": np.ones(3)})
    faults.configure("ckpt_publish")
    try:
        with pytest.raises(faults.InjectedFault):
            TC.write_committed_step(d, 2, {"w": np.zeros(3)})
    finally:
        faults.reset()
    assert os.path.isdir(os.path.join(d, "2"))  # written, never committed
    assert TC.list_committed_steps(d) == JC.list_committed_steps(d) == [1]
    for read in (TC.read_step, JC.read_step):
        with pytest.raises(OSError, match="not committed"):
            read(d, 2)


def _tp_rank_state(cfg, whole, rank, steps=1):
    """Rank ``rank`` of two: its slices of ``whole`` and an optimizer that
    took ``steps`` steps on fixed gradients."""
    mesh = Mesh(data_size=1, model_size=2, data_rank=0, model_rank=rank)
    model = TpTransformerLM(cfg, mesh, device="cpu")
    model.load_state_dict(shard_params(whole, mesh))
    # Rate 0: the moments move, the weights stay those of ``whole``.
    opt = TO.make_optimizer("adam", model.parameters(), 0.0, total_steps=10)
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.linspace(-1, 1, p.numel()).reshape(p.shape)
        opt.step()
    return mesh, model, opt


def test_tp_ranks_reassemble_in_jax_and_resplit(tmp_path):
    """Two tensor-parallel ranks written from one process (index bounds in
    the whole shapes): the JAX reader reassembles the whole tree (the
    JAX-named tree of the whole model, models/convert.py), and the port
    restores it into the whole model and into each rank again."""
    cfg = TT.TransformerConfig(**_cfg_kwargs())
    whole = init_tp_params(cfg, seed=0)
    d = str(tmp_path / "ck")
    ranks = [_tp_rank_state(cfg, whole, r) for r in range(2)]
    for r, (mesh, model, opt) in enumerate(ranks):
        TC.ShardStore(d, rank=r, world_size=2).write_tree(5, TC.train_state(model, opt, 5, mesh))
    TC.ShardStore(d, rank=0, world_size=2).commit(5)
    got = JC.read_step(d, 5)
    one = TpTransformerLM(cfg, device="cpu")
    one.load_state_dict(whole)
    _assert_trees_equal(got["params"], tp_params_to_jax(one))
    # Re-split at another layout: whole, then each rank again (bitwise).
    fresh = TpTransformerLM(cfg, device="cpu", seed=9)
    opt = TO.make_optimizer("adam", fresh.parameters(), 1e-2, total_steps=10)
    assert TC.restore_train_state(5, got, fresh, opt) == 5
    _assert_trees_equal(tp_params_to_jax(fresh), got["params"])
    for r, (mesh, model, ref_opt) in enumerate(ranks):
        other = _tp_rank_state(cfg, init_tp_params(cfg, seed=9), r, steps=0)[1:]
        assert TC.restore_train_state(5, got, *other, mesh) == 5
        for (n, a), (_, b) in zip(model.state_dict().items(), other[0].state_dict().items()):
            assert torch.equal(a, b), n
        for p, q in zip(model.parameters(), other[0].parameters()):
            for k, v in ref_opt.optimizer.state[p].items():
                assert torch.equal(v, other[1].optimizer.state[q][k]), k


# ---------------------------------------------------------------------------
# The manager.
# ---------------------------------------------------------------------------


def _state():
    return {"params": {"w": np.arange(6, dtype=np.float32)}, "global_step": np.int32(1)}


def test_timed_autosave_gate(tmp_path):
    mngr = TC.CheckpointManager(str(tmp_path / "ck"), save_interval_secs=3600)
    assert not mngr.maybe_save(1, _state())  # interval not yet elapsed
    assert mngr.maybe_save(2, _state(), force=True)
    mngr._last_save -= 7200
    assert mngr.maybe_save(3, _state())  # interval elapsed
    assert mngr.latest_step() == 3 and mngr.all_steps() == [2, 3]
    assert mngr.stall_seconds > 0 and mngr.last_save_bytes == 6 * 4 + 4


def test_keep_n(tmp_path):
    mngr = TC.CheckpointManager(str(tmp_path / "ck"), save_interval_secs=0, max_to_keep=2)
    for s in (1, 2, 3, 4):
        mngr.save(s, _state())
    assert mngr.latest_step() == 4
    assert mngr.all_steps() == JC.list_committed_steps(mngr.directory) == [3, 4]


def test_restore_walks_back_past_unreadable_steps(tmp_path):
    d = str(tmp_path / "ck")
    mngr = TC.CheckpointManager(d, max_to_keep=5)
    for s in (1, 2, 3):
        mngr.save(s, {"w": np.full(4, s, np.float32)})
    with open(os.path.join(d, "2", "shard_p0.npz"), "r+b") as fh:
        fh.truncate(20)  # a torn step
    faults.configure("ckpt_restore:2")  # both reads of step 3 fail
    try:
        step, tree = mngr.restore_latest()
    finally:
        faults.reset()
    assert step == 1 and np.all(tree["w"] == 1)
    assert TC.CheckpointManager(str(tmp_path / "empty")).restore_latest() is None


# ---------------------------------------------------------------------------
# The trainer.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("text") / "c.txt"
    rng = np.random.default_rng(6)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta"]
    path.write_bytes(b" ".join(words[i] for i in rng.integers(0, len(words), 400)))
    return str(path)


def test_resume_is_bitwise_on_cpu(tmp_path, corpus, capsys):
    flags = [*CLI_SHAPE, "--text_file", corpus, "--eval_step_interval", "2"]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    loss = cli.main([*flags, "--training_steps", "6", "--train_dir", one])
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    cli.main([*flags, "--training_steps", "3", "--train_dir", two])
    capsys.readouterr()
    resumed = cli.main([*flags, "--training_steps", "6", "--train_dir", two])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"restored checkpoint at step 3 from {two}"
    assert [json.loads(line)["loss"] for line in out[1:]] == [r["loss"] for r in want[1:]]
    assert resumed == loss  # bitwise
    assert TC.list_committed_steps(two) == [3, 6]
    _assert_trees_equal(TC.read_step(two, 6), TC.read_step(one, 6))

    # Resumed at its last step: nothing to train, NaN, and nothing saved.
    assert np.isnan(cli.main([*flags, "--training_steps", "6", "--train_dir", two]))
    assert capsys.readouterr().out.splitlines() == [f"restored checkpoint at step 6 from {two}"]

    # The JAX reader finds the chief's scalars in the event file.
    (events,) = [f for f in os.listdir(one) if f.startswith("events.out.tfevents")]
    scalars = {}
    for rec in list(read_records(os.path.join(one, events)))[1:]:
        fields = {f: v for f, _, v in jpw.iter_fields(rec)}
        for _, _, value in jpw.iter_fields(fields[5]):
            tag_value = {f: v for f, _, v in jpw.iter_fields(value)}
            scalars.setdefault(tag_value[1].decode(), {})[fields[2]] = float(
                np.frombuffer(tag_value[2], "<f4")[0])
    assert sorted(scalars) == ["loss", "steps_per_sec"]  # no MFU without a peak rate
    assert {s: round(v, 4) for s, v in scalars["loss"].items()} == {
        r["step"]: r["loss"] for r in want}
    rates = {r["step"]: r["steps_per_sec"] for r in want if "steps_per_sec" in r}
    assert sorted(scalars["steps_per_sec"]) == sorted(rates)
    for s, v in scalars["steps_per_sec"].items():  # the record rounds to 2 places
        assert abs(v - rates[s]) <= 0.005 + 1e-6 * v


def test_resume_into_another_model_raises(tmp_path, corpus):
    flags = [*CLI_SHAPE, "--text_file", corpus, "--train_dir", str(tmp_path / "ck")]
    cli.main([*flags, "--training_steps", "1"])
    again = [*flags, "--training_steps", "2"]
    with pytest.raises(OSError, match=r"shape mismatch for \['params'\]\['block_0'\]\['mlp_in'\]"):
        cli.main([*again, "--d_ff", "128"])
    with pytest.raises(OSError, match=r"missing leaf \['params'\]\['block_2'\]"):
        cli.main([*again, "--num_layers", "3"])
    with pytest.raises(OSError, match=r"missing leaf \['opt_state'\]\['state'\]"):
        cli.main([*again, "--optimizer", "momentum"])


def test_cli_exports_a_bundle_jax_loads(tmp_path, corpus, capsys):
    path = str(tmp_path / "lm.msgpack")
    cli.main([*CLI_SHAPE, "--text_file", corpus, "--training_steps", "2", "--output", path,
              "--num_kv_heads", "2", "--position", "rope", "--attention_window", "8"])
    assert capsys.readouterr().out.splitlines()[-1] == f"exported {path}"
    params, meta = JC.load_inference_bundle(path)
    assert meta == {"format": "dtf_tpu.params.v1", "model": "TransformerLM",
                    "parallelism": "dp", "config": {
                        "vocab_size": 256, "d_model": 32, "num_heads": 4, "num_kv_heads": 2,
                        "attention_window": 8, "use_bias": 1, "rope": 1, "rope_theta": 10000.0,
                        "num_layers": 2, "d_ff": 64, "max_seq_len": 16}}
    cfg, model, _ = TC.load_lm_bundle(path, device="cpu")
    assert (cfg.kv_heads, cfg.attention_window, cfg.position) == (2, 8, "rope")
    _assert_trees_equal(transformer_params_to_jax(model), params)


def test_multiprocess_tp_checkpoints_and_skips_output(tmp_path, corpus, capsys):
    """Two tensor-parallel ranks save their blocks into one committed step
    and skip --output; one process resumes that step at another split and
    trains on as an uninterrupted run does."""
    flags = ["--device", "cpu", "--parallelism", "tp", "--eval_step_interval", "2",
             "--seq_len", "16", "--batch_size", "2", "--d_model", "32", "--num_heads", "4",
             "--num_layers", "2", "--d_ff", "64", "--attention", "flash", "--text_file", corpus]
    d, out = str(tmp_path / "ck"), str(tmp_path / "lm.msgpack")
    outs = run_ranks([*flags, "--training_steps", "4", "--model_parallel", "2",
                      "--train_dir", d, "--output", out])
    assert outs[0].splitlines()[-1].startswith("skipping --output: tp params are sharded")
    assert outs[1] == "" and not os.path.exists(out)
    assert sorted(os.listdir(os.path.join(d, "4"))) == [
        "COMMIT.json", "manifest_p0.json", "manifest_p1.json", "shard_p0.npz", "shard_p1.npz"]
    with open(os.path.join(d, "4", "manifest_p1.json")) as fh:
        blocks = {e["path"]: e["index"] for e in json.load(fh)["entries"]}
    assert blocks["['params']['block_0']['q']['kernel']"] == [[0, 32], [16, 32]]
    assert blocks["['opt_state']['state']['block_1.mlp_out.weight']['exp_avg']"] == [
        [0, 32], [32, 64]]
    assert all(i is not None for i in blocks.values())  # whole leaves are the chief's
    resumed = cli.main([*flags, "--training_steps", "6", "--train_dir", d])
    assert capsys.readouterr().out.splitlines()[0] == f"restored checkpoint at step 4 from {d}"
    want = cli.main([*flags, "--training_steps", "6"])
    assert resumed == pytest.approx(want, abs=1e-3)
