"""The port's ring attention, sequence-parallel step and ``sp_tp`` step over
gloo process groups against the JAX package's on CPU device meshes.

  * two gloo ranks (a FileStore rendezvous) each hold half the sequence:
    ``ring_attention`` values and q/k/v gradients against the JAX
    ``ring_attention`` under ``shard_map`` on two CPU devices, full causal,
    non-causal and windowed (window 5 over shards of 8: one shard back, two
    hops; window 1: one hop, no exchange), within 2e-6 of the largest
    value (outputs) and 5e-6 (gradients); the exchanges each rank made
    (hops − 1 forward, as many backward);
  * the same two ranks take the JAX ``sequence_parallel.build_lm_train_step``'s
    two Adam steps (bias-free, f32) on a (data 1, model 2) mesh, learned
    positions and rope + GQA: losses within 1e-5, parameters within 1e-5 of
    the largest, the two ranks' parameters bitwise equal;
  * four gloo ranks (data 1 x pipe 2 x model 2) take the JAX
    ``build_sp_tp_lm_train_step``'s two Adam steps on a (1, 2, 2) mesh
    (rope + GQA): losses within 1e-5, the gathered parameters within 1e-5.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from distributed_tensorflow_tpu.models import transformer as JT
from distributed_tensorflow_tpu.parallel import data_parallel as jdp
from distributed_tensorflow_tpu.parallel import sequence_parallel as jsp
from distributed_tensorflow_tpu.parallel import tensor_parallel as jtp
from distributed_tensorflow_tpu.parallel import three_d as jtd
from distributed_tensorflow_tpu.parallel.mesh import make_mesh, make_mesh3
from distributed_tensorflow_tpu.parallel.ring_attention import ring_attention as jax_ring
from distributed_tensorflow_tpu.train import optimizers as JO
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import (
    tp_params_to_jax,
    transformer_params_to_jax,
)
from distributed_tensorflow_tpu_torch.parallel import tensor_parallel as ttp

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_TOL, GRAD_TOL = 2e-6, 5e-6
B, H, S, D = 2, 3, 16, 8  # ring operands: two shards of 8
RING_CASES = {"causal": (True, None, 2), "non_causal": (False, None, 2),
              "window_5": (True, 5, 2), "window_1": (True, 1, 1)}  # causal, window, hops
SEQ, STEPS, LR = 16, 2, 0.1
SHAPE = dict(vocab_size=32, d_model=32, num_heads=4, num_layers=2, d_ff=64, max_seq_len=SEQ,
             use_bias=False)
SP_MODELS = {"learned": dict(SHAPE), "rope_gqa": dict(SHAPE, position="rope", num_kv_heads=2)}
SP_TP_MODEL = dict(SHAPE, position="rope", num_kv_heads=2)

# One rank of the gloo runs: imports the port and torch only.
_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import transformer_params_from_jax
from distributed_tensorflow_tpu_torch.parallel import ring_attention as ra
from distributed_tensorflow_tpu_torch.parallel import sequence_parallel as sp
from distributed_tensorflow_tpu_torch.parallel import tensor_parallel as ttp
from distributed_tensorflow_tpu_torch.parallel import three_d as td
from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh3
from distributed_tensorflow_tpu_torch.train.optimizers import make_optimizer

torch.set_num_threads(1)
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.load(open(f"{tmp}/spec.json"))
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=world)
exchanges = [0]
exchange = ra.exchange
def counted(*a):
    exchanges[0] += 1
    return exchange(*a)
ra.exchange = counted

def tree(path):
    flat, out = np.load(path), {}
    for key in flat.files:
        *mods, leaf = key.split("/")
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = flat[key]
    return out

def train(model, mesh, axis):
    opt = make_optimizer("sgd", model.parameters(), spec["lr"], total_steps=spec["steps"])
    build = sp.build_lm_train_step if axis == "model" else td.build_sp_tp_lm_train_step
    step = build(model, opt, mesh) if axis == "pipe" else build(model, opt, mesh, axis)
    return [float(step(sp.shard_lm_batch(torch.from_numpy(t), mesh, axis))["loss"])
            for t in np.load(f"{tmp}/batches.npy")]

out = {}
if world == 2:
    ops = np.load(f"{tmp}/ring.npz")
    cols = slice(rank * ops["q"].shape[2] // 2, (rank + 1) * ops["q"].shape[2] // 2)
    for name, (causal, window, _) in spec["ring"].items():
        q, k, v = (torch.tensor(ops[n][:, :, cols], requires_grad=True) for n in "qkv")
        exchanges[0] = 0
        o = ra.ring_attention(q, k, v, group=dist.group.WORLD, causal=causal, window=window)
        fwd = exchanges[0]
        o.backward(torch.from_numpy(np.ascontiguousarray(ops["g"][:, :, cols])))
        out[f"ring/{name}/out"] = o.detach().numpy()
        for n, t in zip("qkv", (q, k, v)):
            out[f"ring/{name}/d{n}"] = t.grad.numpy()
        out[f"ring/{name}/exchanges"] = np.array([fwd, exchanges[0] - fwd])
    mesh = make_mesh3(1, 2)
    for name, kw in spec["sp"].items():
        model = sp.make_sp_model(TT.TransformerConfig(**kw), mesh, device="cpu")
        model.load_state_dict(transformer_params_from_jax(tree(f"{tmp}/sp_{name}.npz")))
        out[f"sp/{name}/losses"] = np.array(train(model, mesh, "model"))
        for k, v in model.state_dict().items():
            out[f"sp/{name}/param/{k}"] = v.numpy()
else:
    mesh = make_mesh3(2, 2)
    model = td.make_sp_tp_model(TT.TransformerConfig(**spec["sp_tp"]), mesh, device="cpu")
    model.load_state_dict(ttp.shard_params(transformer_params_from_jax(
        tree(f"{tmp}/sp_tp.npz")), mesh))
    out["sp_tp/losses"] = np.array(train(model, mesh, "pipe"))
    for k, v in ttp.gather_params(model.state_dict(), mesh).items():
        out[f"sp_tp/param/{k}"] = v.numpy()
np.savez(f"{tmp}/rank_{rank}.npz", **out)
dist.destroy_process_group()
"""


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    ring = {n: rng.standard_normal((B, H, S, D)).astype(np.float32) for n in "qkvg"}
    batches = np.stack([rng.integers(0, SHAPE["vocab_size"], (4, SEQ)).astype(np.int32)
                        for _ in range(STEPS)])
    # The port draws the weights; both packages start from them.
    sp_params = {name: transformer_params_to_jax(
        TT.TransformerLM(TT.TransformerConfig(**kw), seed=3, device="cpu"))
        for name, kw in SP_MODELS.items()}
    sp_tp_params = tp_params_to_jax(
        ttp.TpTransformerLM(TT.TransformerConfig(**SP_TP_MODEL), seed=4, device="cpu"))
    return ring, batches, sp_params, sp_tp_params


def _start(tmp, world):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    env["OMP_NUM_THREADS"] = "1"  # tiny shapes: one thread per rank keeps the host free
    return [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), str(tmp)],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(world)]


def _gloo_run(inputs, tmp_path_factory, world):
    """The ``world``-rank run's directory and processes (two ranks: the ring
    and sp; four: sp_tp); a test waits for them in :func:`_results`."""
    ring, batches, sp_params, sp_tp_params = inputs
    tmp = tmp_path_factory.mktemp(f"ring_gloo_{world}")
    np.savez(tmp / "ring.npz", **ring)
    np.save(tmp / "batches.npy", batches)
    for name, params in sp_params.items():
        np.savez(tmp / f"sp_{name}.npz", **_flat(params))
    np.savez(tmp / "sp_tp.npz", **_flat(sp_tp_params))
    (tmp / "spec.json").write_text(json.dumps(
        {"ring": RING_CASES, "sp": SP_MODELS, "sp_tp": SP_TP_MODEL, "lr": LR, "steps": STEPS}))
    procs = _start(tmp, world)
    yield tmp, procs
    for proc in procs:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def two_ranks(inputs, tmp_path_factory):
    yield from _gloo_run(inputs, tmp_path_factory, 2)


@pytest.fixture(scope="module")
def four_ranks(inputs, tmp_path_factory):
    yield from _gloo_run(inputs, tmp_path_factory, 4)


def _results(run):
    tmp, procs = run
    for proc in procs:
        out, _ = proc.communicate(timeout=180)
        assert proc.returncode == 0, out
    return [np.load(tmp / f"rank_{r}.npz") for r in range(len(procs))]


def _rel(got, want):
    """Largest error over the largest reference value (1 where the reference
    is all zero: window 1's dq and dk)."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1.0))


def test_ring_values_grads_and_hops_match_jax(inputs, two_ranks):
    ring = inputs[0]
    mesh = make_mesh(num_devices=2)
    ranks = _results(two_ranks)
    for name, (causal, window, hops) in RING_CASES.items():
        fn = jax.shard_map(
            lambda q, k, v: jax_ring(q, k, v, axis_name="data", causal=causal, window=window),
            mesh=mesh, in_specs=(P(None, None, "data", None),) * 3,
            out_specs=P(None, None, "data", None), check_vma=False)
        out, vjp = jax.vjp(jax.jit(fn), ring["q"], ring["k"], ring["v"])
        want = {"out": out, **dict(zip(("dq", "dk", "dv"), vjp(ring["g"])))}
        for key, w in want.items():
            got = np.concatenate([r[f"ring/{name}/{key}"] for r in ranks], axis=2)
            assert _rel(got, w) <= (OUT_TOL if key == "out" else GRAD_TOL), (name, key)
        for r in ranks:  # hops − 1 exchanges each way
            assert r[f"ring/{name}/exchanges"].tolist() == [hops - 1, hops - 1], name


def _jax_sp_run(name, params, batches):
    cfg = JT.TransformerConfig(compute_dtype=jnp.float32, **SP_MODELS[name])
    mesh = make_mesh(num_devices=2, model_parallel=2)
    tx = JO.make_optimizer("sgd", LR, total_steps=STEPS)
    step = jsp.build_lm_train_step(cfg, tx, mesh, donate=False)
    p, o = jdp.replicate(params, mesh), jdp.replicate(tx.init(params), mesh)
    g = jdp.replicate(jnp.zeros((), jnp.int32), mesh)
    losses = []
    for t in batches:
        p, o, g, m = step(p, o, g, jsp.shard_lm_batch(jnp.asarray(t), mesh),
                          jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return np.array(losses), jax.device_get(p)


def test_sp_step_over_two_ranks_matches_jax(inputs, two_ranks):
    _, batches, sp_params, _ = inputs
    want = {name: _jax_sp_run(name, sp_params[name], batches) for name in SP_MODELS}
    ranks = _results(two_ranks)
    for name, (want_losses, want_params) in want.items():
        for r in ranks:
            np.testing.assert_allclose(r[f"sp/{name}/losses"], want_losses, atol=1e-5, rtol=0)
        assert want_losses[-1] != want_losses[0]  # the weights moved
        prefix = f"sp/{name}/param/"
        keys = [k for k in ranks[0].files if k.startswith(prefix)]
        for k in keys:  # replicated: the same bits on both ranks
            np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)
        model = TT.TransformerLM(TT.TransformerConfig(**SP_MODELS[name]), device="cpu")
        model.load_state_dict({k[len(prefix):]: torch.from_numpy(ranks[0][k]) for k in keys})
        got, ref = _flat(transformer_params_to_jax(model)), _flat(want_params)
        assert got.keys() == ref.keys()
        scale = max(float(np.abs(w).max()) for w in ref.values())
        for k, w in ref.items():
            np.testing.assert_allclose(got[k], w, atol=1e-5 * scale, rtol=0,
                                       err_msg=f"{name} {k}")


def test_sp_tp_step_over_four_ranks_matches_jax(inputs, four_ranks):
    _, batches, _, host = inputs
    cfg = JT.TransformerConfig(compute_dtype=jnp.float32, **SP_TP_MODEL)
    mesh = make_mesh3(4, pipeline_parallel=2, model_parallel=2)
    tx = JO.make_optimizer("sgd", LR, total_steps=STEPS)
    step = jtd.build_sp_tp_lm_train_step(cfg, tx, mesh, host, donate=False)
    p = jtp.shard_params(host, mesh)
    o = jtp.shard_params(jax.device_get(tx.init(host)), mesh)
    g = jdp.replicate(jnp.zeros((), jnp.int32), mesh)
    want_losses = []
    for t in batches:
        x = jax.device_put(jnp.asarray(t), NamedSharding(mesh, P("data", "pipe")))
        p, o, g, m = step(p, o, g, x, jax.random.PRNGKey(0))
        want_losses.append(float(m["loss"]))
    ranks = _results(four_ranks)
    for r in ranks:
        np.testing.assert_allclose(r["sp_tp/losses"], want_losses, atol=1e-5, rtol=0)
    model = ttp.TpTransformerLM(TT.TransformerConfig(**SP_TP_MODEL), device="cpu")
    prefix = "sp_tp/param/"
    model.load_state_dict({k[len(prefix):]: torch.from_numpy(ranks[0][k])
                           for k in ranks[0].files if k.startswith(prefix)})
    got, want = _flat(tp_params_to_jax(model)), _flat(jax.device_get(p))
    assert got.keys() == want.keys()
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-5 * scale, rtol=0, err_msg=k)
