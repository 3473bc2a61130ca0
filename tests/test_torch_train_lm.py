"""The port's optimizers, train step and CLI against the JAX package's.

From the same flax weights and the same numpy-seeded tokens, the port's
``build_lm_train_step`` and the JAX package's (on a one-device mesh) take
the same optimizer steps; their losses agree within 1e-4. The JAX step runs
its dense reference attention (tests/test_torch_attention.py holds the
port's flash against the JAX kernels in interpret mode). Schedules are
compared value by value with optax's. The CLI runs on the CPU.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import transformer as JT
from distributed_tensorflow_tpu.parallel import data_parallel as jdp
from distributed_tensorflow_tpu.parallel.mesh import make_mesh
from distributed_tensorflow_tpu.train import optimizers as JO
from distributed_tensorflow_tpu_torch.cli import train_lm as cli
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import (
    transformer_params_from_jax,
    transformer_params_to_jax,
)
from distributed_tensorflow_tpu_torch.parallel.data_parallel import build_lm_train_step
from distributed_tensorflow_tpu_torch.train import optimizers as TO

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

B, S = 2, 32
SHAPE = dict(vocab_size=32, d_model=32, num_heads=2, num_layers=1, d_ff=64, max_seq_len=S,
             attention="flash")


def _losses(optimizer, steps, schedule="constant", clip=0.0, lr=1e-2):
    jcfg = JT.TransformerConfig(compute_dtype=jnp.float32, **{**SHAPE, "attention": "dense"})
    # The port draws the weights (no JAX init to compile); both packages
    # start from them.
    params = transformer_params_to_jax(
        TT.TransformerLM(TT.TransformerConfig(compute_dtype=torch.float32, **SHAPE),
                         device="cpu"))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, SHAPE["vocab_size"], (B, S)).astype(np.int32) for _ in range(steps)]

    mesh = make_mesh(num_devices=1)
    tx = JO.make_optimizer(optimizer, lr, total_steps=steps, schedule=schedule,
                           warmup_steps=1, grad_clip_norm=clip)
    jstep = jdp.build_lm_train_step(jcfg, tx, mesh)
    p, o = jdp.replicate(params, mesh), jdp.replicate(tx.init(params), mesh)
    g = jdp.replicate(jnp.zeros((), jnp.int32), mesh)  # as the step returns it: one compile
    want = []
    for t in batches:
        p, o, g, m = jstep(p, o, g, jdp.shard_global_batch({"x": jnp.asarray(t)}, mesh)["x"],
                           jax.random.PRNGKey(0))
        want.append(float(m["loss"]))

    model = TT.TransformerLM(TT.TransformerConfig(compute_dtype=torch.float32, **SHAPE),
                             device="cpu")
    model.load_state_dict(transformer_params_from_jax(params))
    opt = TO.make_optimizer(optimizer, model.parameters(), lr, total_steps=steps,
                            schedule=schedule, warmup_steps=1, grad_clip_norm=clip)
    tstep = build_lm_train_step(model, opt)
    got = [float(tstep(torch.from_numpy(t))["loss"]) for t in batches]
    return np.array(got), np.array(want)


@pytest.mark.parametrize(
    "optimizer,steps,schedule,clip",
    [
        ("adam", 3, "constant", 0.0),
        ("adamw", 2, "constant", 0.0),
        ("sgd", 2, "constant", 0.0),
        ("momentum", 2, "constant", 0.0),
        ("adam", 3, "warmup_cosine", 0.5),
    ],
)
def test_train_steps_match_jax(optimizer, steps, schedule, clip):
    got, want = _losses(optimizer, steps, schedule, clip)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if optimizer != "sgd":
        assert got[-1] != got[0]  # the weights moved


@pytest.mark.parametrize("name", TO.SCHEDULES)
def test_schedules_match_optax(name):
    want = JO.make_schedule(name, 0.1, total_steps=20, warmup_steps=5, final_scale=0.1)
    got = TO.make_schedule(name, 0.1, total_steps=20, warmup_steps=5, final_scale=0.1)
    for count in range(0, 25):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-9)


def test_clip_by_global_norm_matches_optax():
    import optax

    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.tensor(g)
        TO.clip_by_global_norm_(params, max_norm)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_synthetic_tokens_match_the_jax_trainer():
    import tools.train_lm as jcli

    a = cli.synthetic_tokens(np.random.default_rng(3), 2, 16, 40)
    b = jcli.synthetic_tokens(np.random.default_rng(3), 2, 16, 40)
    np.testing.assert_array_equal(a, b)


def test_text_windows_match_the_jax_dataset():
    from distributed_tensorflow_tpu.data.text import ByteTextDataset as JaxText
    from distributed_tensorflow_tpu_torch.data.text import ByteTextDataset

    tokens = np.frombuffer(b"the quick brown fox jumps over the lazy dog. " * 30, np.uint8)
    ours, ref = ByteTextDataset(tokens, 24, 0.1, seed=5), JaxText(tokens, 24, 0.1, seed=5)
    for step in (0, 7):
        np.testing.assert_array_equal(ours.train_batch(3, step), ref.train_batch(3, step))


def test_cli_trains_on_cpu_and_prints_records(capsys):
    loss = cli.main([
        "--device", "cpu", "--training_steps", "4", "--eval_step_interval", "2",
        "--seq_len", "32", "--batch_size", "2", "--d_model", "32", "--num_heads", "2",
        "--num_kv_heads", "1", "--num_layers", "1", "--d_ff", "64", "--attention", "flash",
        "--position", "rope", "--attention_window", "8",
    ])
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in records] == [2, 4]
    assert all(r["parallelism"] == "dp" and np.isfinite(r["loss"]) for r in records)
    assert "steps_per_sec" not in records[0]  # the first window is warm-up
    assert records[1]["steps_per_sec"] > 0 and records[1]["tokens_per_sec"] > 0
    assert "mfu" not in records[1]  # no peak rate on the CPU
    assert loss == pytest.approx(records[1]["loss"], abs=1e-4)


def test_cli_trains_on_a_text_file(tmp_path, capsys):
    path = tmp_path / "c.txt"
    path.write_bytes(b"the quick brown fox. " * 40)
    cli.main(["--device", "cpu", "--text_file", str(path), "--training_steps", "2",
              "--eval_step_interval", "2", "--seq_len", "16", "--batch_size", "2",
              "--d_model", "32", "--num_heads", "2", "--num_layers", "1", "--d_ff", "32"])
    (record,) = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert record["step"] == 2 and np.isfinite(record["loss"])


def test_cli_tp_trains_in_a_world_of_one_on_cpu(capsys):
    loss = cli.main([
        "--device", "cpu", "--parallelism", "tp", "--training_steps", "4",
        "--eval_step_interval", "2", "--seq_len", "32", "--batch_size", "2", "--d_model", "32",
        "--num_heads", "2", "--num_layers", "1", "--d_ff", "64", "--attention", "flash",
        "--position", "rope",
    ])
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in records] == [2, 4]
    assert all(r["parallelism"] == "tp" and np.isfinite(r["loss"]) for r in records)
    assert "steps_per_sec" not in records[0] and records[1]["tokens_per_sec"] > 0
    assert "mfu" not in records[1]  # no peak rate on the CPU
    assert loss == pytest.approx(records[1]["loss"], abs=1e-4)
    assert not torch.distributed.is_initialized()  # the world of one is torn down


# One rank of the multi-process runs: the CLI's main over each flag list in turn.
_RANK = r"""
import json, sys
from distributed_tensorflow_tpu_torch.cli import train_lm
for flags in json.loads(sys.argv[1]):
    print("\x1e", flush=True)  # separates the runs' output
    train_lm.main(flags)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(runs, n=2):
    """The CLI in ``n`` processes joined by the reference-style
    --worker_hosts/--task_index (gloo over loopback, rendezvous at the first
    host), each of ``runs`` (a list of flags) in turn in the same processes,
    each on a fresh port. Returns the processes; :func:`rank_outputs` waits
    for them."""
    ports = [_free_port() for _ in runs]
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    env["OMP_NUM_THREADS"] = "1"  # tiny shapes: one thread per rank keeps the host free
    procs = []
    for r in range(n):
        argv = [[*flags, "--worker_hosts", ",".join(f"127.0.0.1:{port + i}" for i in range(n)),
                 "--task_index", str(r)] for flags, port in zip(runs, ports)]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK, json.dumps(argv)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def rank_outputs(procs):
    """For each run of :func:`start_ranks`, each rank's stdout."""
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        outs.append(out.split("\x1e\n")[1:])
    return [list(run) for run in zip(*outs)]


def run_ranks(flags, n=2):
    """One run in ``n`` processes (:func:`start_ranks`): each rank's stdout."""
    return rank_outputs(start_ranks([flags], n))[0]


FLAGS = ["--device", "cpu", "--training_steps", "4", "--eval_step_interval", "2",
         "--seq_len", "32", "--batch_size", "2", "--d_model", "32", "--num_heads", "2",
         "--d_ff", "64", "--attention", "flash", "--position", "rope"]
TP_FLAGS = ["--parallelism", "tp", "--num_layers", "1", *FLAGS]
PP_FLAGS = ["--parallelism", "pp", "--num_layers", "2", *FLAGS]


@pytest.fixture(scope="module", autouse=True)
def two_process_procs(tmp_path_factory):
    """tp, then pp (asked for --output), over two processes: started once,
    when the file starts, so that they run beside its other tests."""
    out = tmp_path_factory.mktemp("pp_output") / "lm.msgpack"
    procs = start_ranks([[*TP_FLAGS, "--model_parallel", "2"],
                         [*PP_FLAGS, "--model_parallel", "2", "--output", str(out)]])
    yield procs, out
    for proc in procs:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def two_process_runs(two_process_procs):
    procs, pp_output = two_process_procs
    return {**dict(zip(("tp", "pp"), rank_outputs(procs))), "pp_output": pp_output}


def _one_process_losses(flags, capsys):
    cli.main(flags)
    return [json.loads(line)["loss"] for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_cli_tp_over_worker_hosts_matches_one_process(two_process_runs, capsys):
    """Two processes joined by the reference-style --worker_hosts/--task_index
    (gloo over loopback, rendezvous at the first host) train the model split
    in two and print the losses of one process training it whole."""
    want = _one_process_losses(TP_FLAGS, capsys)
    outs = two_process_runs["tp"]
    records = [json.loads(line) for line in outs[0].splitlines()]
    assert outs[1] == ""  # only the chief prints
    assert [r["step"] for r in records] == [2, 4]
    np.testing.assert_allclose([r["loss"] for r in records], want, atol=1e-4, rtol=0)


def test_cli_pp_over_worker_hosts_matches_one_process_dp(two_process_runs, capsys):
    """Two pipeline stages in two processes (--model_parallel 2, 2
    microbatches) print the losses of one process training the same model
    data-parallel; pp parameters live on two processes, so --output is
    skipped."""
    want = _one_process_losses(["--parallelism", "dp", *PP_FLAGS[2:]], capsys)
    outs = two_process_runs["pp"]
    lines = outs[0].splitlines()
    records = [json.loads(line) for line in lines if line.startswith("{")]
    assert outs[1] == ""  # only the chief prints
    assert lines[-1].startswith("skipping --output: pp params are sharded")
    assert not two_process_runs["pp_output"].exists()
    assert [r["step"] for r in records] == [2, 4]
    assert all(r["parallelism"] == "pp" for r in records)
    np.testing.assert_allclose([r["loss"] for r in records], want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode,base", [("pp", "dp"), ("3d", "tp")])
def test_cli_pp_and_3d_train_in_a_world_of_one(mode, base, tmp_path, capsys):
    """pp and 3d on one process print the losses of dp and tp on the same
    flags (the same seed's weights), and --output exports the stage-stacked
    tree the JAX trainer exports, with the mode in the metadata."""
    from distributed_tensorflow_tpu.train import checkpoint as JC
    from distributed_tensorflow_tpu_torch.parallel.pipeline_parallel import unstack_stage_params

    flags = [*PP_FLAGS[2:], "--remat"]
    want = _one_process_losses(["--parallelism", base, *flags], capsys)
    path = str(tmp_path / "lm.msgpack")
    got = _one_process_losses(["--parallelism", mode, "--model_parallel", "1",
                               "--num_microbatches", "2", *flags, "--output", path], capsys)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    params, meta = JC.load_inference_bundle(path)
    assert meta["parallelism"] == mode and meta["config"]["num_layers"] == 2
    leaf = jax.tree_util.tree_leaves(params["stages"])[0]
    assert leaf.shape[:2] == (1, 2)  # (stages, layers a stage)
    plain = unstack_stage_params(params)
    assert sorted(plain) == ["block_0", "block_1", "lm_head", "ln_f", "tok_embed"]
    block = {"pp": {"ln1", "qkv", "proj", "ln2", "mlp_in", "mlp_out"},
             "3d": {"ln1", "q", "k", "v", "proj", "proj_bias", "ln2", "mlp_in", "mlp_out",
                    "mlp_out_bias"}}[mode]
    assert set(plain["block_0"]) == block


@pytest.mark.parametrize("mode", ["pp", "3d"])
def test_cli_train_dir_under_pp_and_3d_is_not_ported_yet(mode, tmp_path):
    """--train_dir under pp and 3d is ported now (the name stays, so that
    runs before and after line up): the run commits its last step in the
    stage-stacked layout. Resume, restores at another split and the layout
    against the JAX reader: tests/test_torch_checkpoint_modes.py."""
    from distributed_tensorflow_tpu_torch.train.checkpoint import list_committed_steps, read_step

    cli.main([*PP_FLAGS[2:], "--parallelism", mode, "--training_steps", "2",
              "--train_dir", str(tmp_path)])
    assert list_committed_steps(str(tmp_path)) == [2]
    stages = read_step(str(tmp_path), 2)["params"]["stages"]
    assert jax.tree_util.tree_leaves(stages)[0].shape[:2] == (1, 2)  # (stages, layers a stage)


def test_cli_tp_raises_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--parallelism", "tp", "--device", "cuda", "--training_steps", "1"])


@pytest.mark.parametrize("flag", [
    ["--profile_start_step", "1"], ["--parallelism", "ep"], ["--steps_per_call", "2"],
    ["--num_experts", "2"], ["--parallelism", "fsdp"], ["--profile_dir", "x"], ["--obs_dir", "x"],
    ["--slo", "default"], ["--job_name", "ps"],
])
def test_cli_rejects_flags_of_later_slices(flag):
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(flag)
