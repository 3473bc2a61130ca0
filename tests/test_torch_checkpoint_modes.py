"""Checkpoints in every parallelism mode: the port's pp and 3d steps in the
JAX package's stage-stacked layout, restores at another split, and the
trainer resuming in dp, tp, pp, 3d, sp and sp_tp.

  * two pipeline stages (and a data 1 x pipe 2 x model 2 grid of 3d ranks)
    written from one process, each rank its own block with its bounds in
    the whole leaf: the JAX ``read_step`` gives ``stages`` leaves equal to
    the JAX ``stack_stage_params`` of the same weights (3d: of the tp
    model's, the JAX ``init_3d_params`` layout), and the Adam moments
    stacked alike;
  * that tree written again by the JAX ``write_committed_step`` restores
    into two stages and into one, bitwise (parameters, moments, step);
  * the CLI in a world of one, every mode: 2 steps, then resumed to 4,
    equals 4 steps straight, bitwise;
  * two processes: pp (two stages) saves one committed step that one
    process resumes as a single stage, its loss within 1e-3 of an
    uninterrupted run; sp (the sequence split in two) passes the bitwise
    cross-process check, its chief exports the bundle, and its losses
    equal one process's within 1e-4.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.parallel import pipeline_parallel as jpp
from distributed_tensorflow_tpu.train import checkpoint as JC
from distributed_tensorflow_tpu_torch.cli import train_lm as cli
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import (
    tp_params_to_jax,
    transformer_params_to_jax,
)
from distributed_tensorflow_tpu_torch.parallel import pipeline_parallel as tpp
from distributed_tensorflow_tpu_torch.parallel import tensor_parallel as ttp
from distributed_tensorflow_tpu_torch.parallel import three_d as ttd
from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_tpu_torch.train import checkpoint as TC
from distributed_tensorflow_tpu_torch.train.optimizers import make_optimizer
from test_torch_train_lm import rank_outputs, start_ranks

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

CFG = dict(vocab_size=32, d_model=32, num_heads=4, num_kv_heads=2, num_layers=4, d_ff=64,
           max_seq_len=16, use_bias=True)
FLAGS = ["--device", "cpu", "--seq_len", "16", "--batch_size", "2", "--d_model", "32",
         "--num_heads", "4", "--num_kv_heads", "2", "--num_layers", "2", "--d_ff", "64",
         "--attention", "flash", "--position", "rope", "--eval_step_interval", "2"]
MODES = {
    "dp": [], "tp": ["--parallelism", "tp"], "pp": ["--parallelism", "pp"],
    "3d": ["--parallelism", "3d"], "sp": ["--parallelism", "sp"],
    "sp_tp": ["--parallelism", "sp_tp"],
}


def _fake_step(model, opt, seed):
    """One optimizer step on seeded gradients: moments to save."""
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()


def _write(d, step, ranks):
    """Each rank's ``train_state`` written as that rank, then the commit."""
    for r, (model, opt, mesh) in enumerate(ranks):
        TC.ShardStore(d, r, len(ranks)).write_tree(step, TC.train_state(model, opt, step, mesh))
    TC.ShardStore(d, 0, len(ranks)).commit(step)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _pp_ranks():
    cfg = TT.TransformerConfig(**CFG)
    ranks = []
    for s in range(2):
        mesh = Mesh(pipe_size=2, pipe_rank=s, pipe_ranks=(0, 1))
        model = tpp.PipelineLM(cfg, mesh, seed=1, device="cpu")
        opt = make_optimizer("adam", model.parameters(), 1e-2, total_steps=10)
        _fake_step(model, opt, s)
        ranks.append((model, opt, mesh))
    return cfg, ranks


@pytest.fixture(scope="module")
def pp_step(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pp_step"))
    cfg, ranks = _pp_ranks()
    _write(d, 5, ranks)
    return d, cfg, ranks


def test_pp_save_reads_in_jax_as_stacked_stages(pp_step):
    d, cfg, ranks = pp_step
    got = JC.read_step(d, 5)
    whole = TT.TransformerLM(cfg, device="cpu")
    whole.load_state_dict(tpp.unstage_state_dicts([m.state_dict() for m, _, _ in ranks]))
    _assert_equal(got["params"], jpp.stack_stage_params(transformer_params_to_jax(whole), 2))
    state = got["opt_state"]["state"]
    assert state["stages.qkv.weight"]["exp_avg"].shape == (2, 2, 32 + 2 * 2 * 8, 32)
    assert state["stages.qkv.weight"]["step"].shape == (2, 2)
    for s, (model, opt, _) in enumerate(ranks):
        p = dict(model.named_parameters())["blocks.1.mlp_in.weight"]
        np.testing.assert_array_equal(state["stages.mlp_in.weight"]["exp_avg_sq"][s, 1],
                                      opt.optimizer.state[p]["exp_avg_sq"].numpy())
    with open(os.path.join(d, "5", "manifest_p1.json")) as fh:
        entries = {e["path"]: e["index"] for e in json.load(fh)["entries"]}
    # Stage 1 writes its own block of each stacked leaf, and nothing else.
    assert entries["['params']['stages']['qkv']['kernel']"] == [[1, 2], [0, 2], [0, 32], [0, 64]]
    assert all(i is not None and "stages" in p for p, i in entries.items())


def test_3d_save_reads_in_jax_as_the_init_3d_layout(tmp_path):
    cfg = TT.TransformerConfig(**CFG)
    ranks = []
    for r in range(4):
        mesh = Mesh(model_size=2, model_rank=r % 2, pipe_size=2, pipe_rank=r // 2,
                    pipe_ranks=(r % 2, 2 + r % 2))
        model = ttd.ThreeDLM(cfg, mesh, seed=2, device="cpu")
        ranks.append((model, make_optimizer("sgd", model.parameters(), 0.1, 10), mesh))
    d = str(tmp_path)
    _write(d, 3, ranks)
    got = JC.read_step(d, 3)
    tp = ttp.TpTransformerLM(cfg, device="cpu", seed=2)
    _assert_equal(got["params"], jpp.stack_stage_params(tp_params_to_jax(tp), 2))
    with open(os.path.join(d, "3", "manifest_p3.json")) as fh:
        entries = {e["path"]: e["index"] for e in json.load(fh)["entries"]}
    # Rank 3 (stage 1, model rank 1): its half of q's columns; whole-width
    # leaves of the stage are model rank 0's.
    assert entries["['params']['stages']['q']['kernel']"] == [[1, 2], [0, 2], [0, 32], [16, 32]]
    assert "['params']['stages']['proj_bias']" not in entries


def test_jax_written_pp_step_restores_at_two_and_one_stage(pp_step, tmp_path):
    d, cfg, ranks = pp_step
    tree = JC.read_step(d, 5)
    jd = str(tmp_path / "jax")
    JC.write_committed_step(jd, 5, tree)
    restored = TC.read_step(jd, 5)
    for stages in (2, 1):
        for s in range(stages):
            mesh = Mesh(pipe_size=stages, pipe_rank=s, pipe_ranks=tuple(range(stages)))
            model = tpp.PipelineLM(cfg, mesh, seed=9, device="cpu")
            opt = make_optimizer("adam", model.parameters(), 1e-2, total_steps=10)
            assert TC.restore_train_state(5, restored, model, opt, mesh) == 5
            per = 4 // stages
            for name, p in model.named_parameters():
                head, _, rest = name.partition(".")
                if head == "blocks":
                    i, _, rest = rest.partition(".")
                    layer = s * per + int(i)
                    src_model, src_opt, _ = ranks[layer // 2]
                    src = dict(src_model.named_parameters())[f"blocks.{layer % 2}.{rest}"]
                else:
                    src_model, src_opt, _ = ranks[0]
                    src = dict(src_model.named_parameters())[name]
                assert torch.equal(p, src), name
                saved, got = src_opt.optimizer.state[src], opt.optimizer.state[p]
                assert sorted(saved) == sorted(got)
                assert all(torch.equal(saved[k], got[k]) for k in saved), name


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("text") / "c.txt"
    path.write_bytes(b"the quick brown fox jumps over the lazy dog. " * 60)
    return str(path)


@pytest.mark.parametrize("mode", MODES)
def test_cli_resume_equals_an_uninterrupted_run(mode, tmp_path, corpus, capsys):
    flags = [*FLAGS, *MODES[mode], "--text_file", corpus]
    want = cli.main([*flags, "--training_steps", "4"])
    d = str(tmp_path / "ck")
    cli.main([*flags, "--training_steps", "2", "--train_dir", d])
    capsys.readouterr()
    got = cli.main([*flags, "--training_steps", "4", "--train_dir", d])
    assert capsys.readouterr().out.splitlines()[0] == f"restored checkpoint at step 2 from {d}"
    assert got == want  # bitwise
    assert TC.list_committed_steps(d) == [2, 4]


def _two_process(tmp, corpus, mode, extra):
    """``mode`` over two processes with --train_dir (and ``extra``), its
    flags and processes; started when a test first asks for it."""
    flags = [*FLAGS, "--parallelism", mode, "--model_parallel", "2", "--text_file", corpus,
             "--training_steps", "4", "--train_dir", str(tmp / mode), *extra]
    procs = start_ranks([flags])
    yield procs, tmp, flags
    for proc in procs:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def two_process_pp(tmp_path_factory, corpus):
    yield from _two_process(tmp_path_factory.mktemp("pp_two_process"), corpus, "pp", [])


@pytest.fixture(scope="module")
def two_process_sp(tmp_path_factory, corpus):
    tmp = tmp_path_factory.mktemp("sp_two_process")
    yield from _two_process(tmp, corpus, "sp", ["--output", str(tmp / "sp.msgpack")])


def test_two_process_pp_step_resumes_at_one_stage(two_process_pp, corpus, capsys):
    procs, tmp, _ = two_process_pp
    rank_outputs(procs)
    d = str(tmp / "pp")
    assert sorted(os.listdir(os.path.join(d, "4"))) == [
        "COMMIT.json", "manifest_p0.json", "manifest_p1.json", "shard_p0.npz", "shard_p1.npz"]
    flags = [*FLAGS, "--parallelism", "pp", "--text_file", corpus]
    resumed = cli.main([*flags, "--training_steps", "6", "--train_dir", d])
    assert capsys.readouterr().out.splitlines()[0] == f"restored checkpoint at step 4 from {d}"
    want = cli.main([*flags, "--training_steps", "6"])
    assert resumed == pytest.approx(want, abs=1e-3)


def test_two_process_sp_checks_consistency_and_exports(two_process_sp, corpus, capsys):
    procs, tmp, _ = two_process_sp
    (outs,) = rank_outputs(procs)
    lines = outs[0].splitlines()
    assert outs[1] == ""  # only the chief prints
    assert lines[-1] == f"exported {tmp / 'sp.msgpack'}"
    records = [json.loads(x) for x in lines if x.startswith("{")]
    assert [r["step"] for r in records] == [2, 4] and records[0]["parallelism"] == "sp"
    cli.main([*FLAGS, "--parallelism", "sp", "--text_file", corpus, "--training_steps", "4"])
    want = [json.loads(x)["loss"] for x in capsys.readouterr().out.splitlines()]
    np.testing.assert_allclose([r["loss"] for r in records], want, atol=1e-4, rtol=0)
    params, meta = JC.load_inference_bundle(str(tmp / "sp.msgpack"))
    assert meta["parallelism"] == "sp" and "block_1" in params
    # Replicated parameters: the chief wrote the whole step.
    with open(tmp / "sp" / "4" / "manifest_p1.json") as fh:
        assert json.load(fh)["entries"] == []
