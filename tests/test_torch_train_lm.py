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
from distributed_tensorflow_tpu_torch.models.convert import transformer_params_from_jax
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
    params = jax.device_get(
        JT.TransformerLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    )
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, SHAPE["vocab_size"], (B, S)).astype(np.int32) for _ in range(steps)]

    mesh = make_mesh(num_devices=1)
    tx = JO.make_optimizer(optimizer, lr, total_steps=steps, schedule=schedule,
                           warmup_steps=1, grad_clip_norm=clip)
    jstep = jdp.build_lm_train_step(jcfg, tx, mesh)
    p, o, g = jdp.replicate(params, mesh), jdp.replicate(tx.init(params), mesh), jnp.zeros((), jnp.int32)
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


def run_ranks(flags, n=2):
    """The CLI in ``n`` processes joined by the reference-style
    --worker_hosts/--task_index (gloo over loopback, rendezvous at the first
    host); returns each rank's stdout."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    hosts = ",".join(f"127.0.0.1:{port + r}" for r in range(n))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    env["OMP_NUM_THREADS"] = "1"  # tiny shapes: one thread per rank keeps the host free
    procs = [subprocess.Popen(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.train_lm", *flags,
         "--worker_hosts", hosts, "--task_index", str(r)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for r in range(n)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        outs.append(out)
    return outs


def test_cli_tp_over_worker_hosts_matches_one_process(capsys):
    """Two processes joined by the reference-style --worker_hosts/--task_index
    (gloo over loopback, rendezvous at the first host) train the model split
    in two and print the losses of one process training it whole."""
    flags = ["--device", "cpu", "--parallelism", "tp", "--training_steps", "4",
             "--eval_step_interval", "2", "--seq_len", "32", "--batch_size", "2",
             "--d_model", "32", "--num_heads", "2", "--num_layers", "1", "--d_ff", "64",
             "--attention", "flash", "--position", "rope"]
    cli.main(flags)
    want = [json.loads(line)["loss"] for line in capsys.readouterr().out.splitlines()]
    outs = run_ranks([*flags, "--model_parallel", "2"])
    records = [json.loads(line) for line in outs[0].splitlines()]
    assert outs[1] == ""  # only the chief prints
    assert [r["step"] for r in records] == [2, 4]
    np.testing.assert_allclose([r["loss"] for r in records], want, atol=1e-4, rtol=0)


def test_cli_tp_raises_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--parallelism", "tp", "--device", "cuda", "--training_steps", "1"])


@pytest.mark.parametrize("flag", [
    ["--parallelism", "sp"], ["--remat"], ["--steps_per_call", "2"], ["--num_microbatches", "2"],
    ["--pipeline_parallel", "2"], ["--profile_dir", "x"], ["--obs_dir", "x"], ["--slo", "default"],
    ["--attention", "blockwise"],
])
def test_cli_rejects_flags_of_later_slices(flag):
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(flag)
