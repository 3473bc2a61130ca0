"""The port's tensor parallelism against the JAX package's, on the CPU.

  * the partition rules split the same leaves the JAX ``tp_param_specs``
    splits, bias leaves included;
  * the weight bridge round-trips the ``TpTransformerLM`` tree;
  * in a world of one, ``TpTransformerLM`` logits, loss and gradients equal
    the JAX model's under ``shard_map`` on a one-device mesh (f32; logits
    1e-4, loss 1e-5, gradients 2e-4 of the largest, as
    tests/test_torch_transformer.py holds the plain model);
  * four gloo processes (data 2 x model 2, a FileStore rendezvous) take the
    same three Adam steps as ``build_tp_lm_train_step`` on a 4-device mesh:
    losses within 1e-4, the tolerance of test_train_steps_match_jax.
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
from jax.sharding import PartitionSpec as P

from distributed_tensorflow_tpu.models import transformer as JT
from distributed_tensorflow_tpu.parallel import data_parallel as jdp
from distributed_tensorflow_tpu.parallel import tensor_parallel as jtp
from distributed_tensorflow_tpu.parallel.mesh import make_mesh
from distributed_tensorflow_tpu.train import optimizers as JO
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import tp_params_from_jax, tp_params_to_jax
from distributed_tensorflow_tpu_torch.parallel import tensor_parallel as ttp

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

B, S = 4, 32
SHAPE = dict(vocab_size=32, d_model=32, num_heads=4, num_layers=2, d_ff=64, max_seq_len=S)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _configs(**kw):
    kw = dict(SHAPE, **kw)
    return (JT.TransformerConfig(compute_dtype=jnp.float32, **kw),
            TT.TransformerConfig(compute_dtype=torch.float32, **kw))


def _tokens(seed=0, batch=B):
    rng = np.random.default_rng(seed)
    return rng.integers(0, SHAPE["vocab_size"], (batch, S)).astype(np.int32)


def _torch_dim(spec: P, ndim: int):
    """The torch dimension a JAX spec splits: a flax kernel (in, out) is a
    Linear weight (out, in)."""
    axes = [i for i, a in enumerate(spec) if a is not None]
    if not axes:
        return None
    (axis,) = axes
    return ndim - 1 - axis if ndim == 2 else axis


@pytest.mark.parametrize("use_bias,position", [(True, "learned"), (False, "rope")])
def test_rules_split_what_the_jax_specs_split(use_bias, position):
    jcfg, _ = _configs(use_bias=use_bias, position=position, num_kv_heads=2)
    tree = jtp.init_tp_params(jcfg, seed=0)
    specs = jtp.tp_param_specs(tree)
    state = tp_params_from_jax(tree)
    got = ttp.tp_param_specs(state)
    want = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, P)
    ):
        keys = [p.key for p in path]
        name = ".".join(keys[:-1] + [{"kernel": "weight", "scale": "weight",
                                      "embedding": "weight"}.get(keys[-1], keys[-1])])
        want[name] = _torch_dim(spec, state[name].dim())
    assert got == want
    if use_bias:
        assert got["block_0.proj_bias"] is None and got["block_0.q.bias"] == 0


@pytest.mark.parametrize("use_bias", [False, True])
def test_tp_params_round_trip_through_the_bridge(use_bias):
    jcfg, tcfg = _configs(use_bias=use_bias)
    tree = jtp.init_tp_params(jcfg, seed=1)
    model = ttp.TpTransformerLM(tcfg, device="cpu")
    model.load_state_dict(tp_params_from_jax(tree))
    jax.tree_util.tree_map(np.testing.assert_array_equal, tp_params_to_jax(model), tree)


def _jax_tp_loss_and_grads(jcfg, params, tokens):
    model = jtp.TpTransformerLM(jcfg)

    def f(p, t):
        def loss_fn(p):
            logits = model.apply({"params": p}, t)
            return JT.next_token_loss(logits, t), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return loss, logits, grads

    fn = jax.jit(jax.shard_map(f, mesh=make_mesh(num_devices=1), in_specs=(P(), P()),
                               out_specs=(P(), P(), P()), check_vma=False))
    return fn(params, jnp.asarray(tokens))


@pytest.mark.parametrize("attention,position,kv", [
    ("flash", "learned", 4),
    ("flash", "rope", 2),
    ("dense", "learned", 2),
    ("dense", "rope", 4),
])
def test_world_of_one_matches_jax(attention, position, kv):
    jcfg, tcfg = _configs(attention=attention, position=position, num_kv_heads=kv)
    # The port draws the weights (no JAX init to compile); both packages
    # start from them.
    tree = tp_params_to_jax(ttp.TpTransformerLM(tcfg, seed=2, device="cpu"))
    tokens = _tokens(seed=2)
    want_loss, want_logits, want_grads = _jax_tp_loss_and_grads(jcfg, tree, tokens)

    model = ttp.TpTransformerLM(tcfg, device="cpu")
    model.load_state_dict(tp_params_from_jax(tree))
    t = torch.from_numpy(tokens)
    logits = model(t)
    loss = TT.next_token_loss(logits, t)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), atol=1e-5, rtol=0)
    got = dict(jax.tree_util.tree_leaves_with_path(tp_params_to_jax(model, grads=True)))
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(want_grads))
    assert set(got) == {p for p, _ in want}
    scale = max(float(np.abs(w).max()) for _, w in want)
    for path, w in want:
        np.testing.assert_allclose(got[path], w, atol=2e-4 * scale, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


# One rank of the gloo run: imports the port and torch only.
_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import tp_params_from_jax
from distributed_tensorflow_tpu_torch.parallel import tensor_parallel as ttp
from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh
from distributed_tensorflow_tpu_torch.train.optimizers import make_optimizer

rank, tmp = int(sys.argv[1]), sys.argv[2]
spec = json.load(open(f"{tmp}/spec.json"))
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=4)
mesh = make_mesh(model_parallel=2)
cfg = TT.TransformerConfig(compute_dtype=torch.float32, **spec["cfg"])
flat = np.load(f"{tmp}/params.npz")
tree = {}
for key in flat.files:
    *mods, leaf = key.split("/")
    node = tree
    for m in mods:
        node = node.setdefault(m, {})
    node[leaf] = flat[key]
model = ttp.TpTransformerLM(cfg, mesh, device="cpu")
model.load_state_dict(ttp.shard_params(tp_params_from_jax(tree), mesh))
opt = make_optimizer("adam", model.parameters(), spec["lr"], total_steps=spec["steps"])
step = ttp.build_tp_lm_train_step(model, opt, mesh)
batches = np.load(f"{tmp}/batches.npy")
per = batches.shape[1] // mesh.data_size
rows = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
losses = [float(step(torch.from_numpy(t[rows]))["loss"]) for t in batches]
whole = ttp.gather_params(model.state_dict(), mesh)
np.savez(f"{tmp}/gathered_{rank}.npz", **{k: v.numpy() for k, v in whole.items()})
json.dump({"losses": losses, "mesh": [mesh.data_rank, mesh.model_rank]},
          open(f"{tmp}/rank_{rank}.json", "w"))
dist.destroy_process_group()
"""


GLOO_STEPS, GLOO_LR = 3, 1e-2


@pytest.fixture(scope="module", autouse=True)
def gloo_ranks(tmp_path_factory):
    """The four gloo ranks of test_gloo_data2_model2_steps_match_jax, started
    when the file starts so that they run beside its other tests. The port
    draws the weights (no JAX init to compile); both packages start from
    them."""
    tmp_path = tmp_path_factory.mktemp("tp_gloo")
    _, tcfg = _configs(attention="dense", position="rope", num_kv_heads=2)
    tree = tp_params_to_jax(ttp.TpTransformerLM(tcfg, seed=3, device="cpu"))
    batches = np.stack([_tokens(seed=10 + i) for i in range(GLOO_STEPS)])
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    np.savez(tmp_path / "params.npz", **flat)
    np.save(tmp_path / "batches.npy", batches)
    cfg = dict(SHAPE, attention="flash", position="rope", num_kv_heads=2)
    (tmp_path / "spec.json").write_text(json.dumps({"cfg": cfg, "lr": GLOO_LR,
                                                    "steps": GLOO_STEPS}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    env["OMP_NUM_THREADS"] = "1"  # tiny shapes: one thread per rank keeps the host free
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(tmp_path)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(4)]
    yield tree, batches, tmp_path, procs
    for proc in procs:
        proc.kill()
        proc.communicate()


def test_gloo_data2_model2_steps_match_jax(gloo_ranks):
    # The JAX step runs its dense reference attention; test_world_of_one_
    # matches_jax[flash-*] holds the port's tp flash against the JAX kernels.
    tree, batches, tmp_path, procs = gloo_ranks
    steps, lr = GLOO_STEPS, GLOO_LR
    jcfg, _ = _configs(attention="dense", position="rope", num_kv_heads=2)
    # The JAX reference runs while the ranks do.
    mesh = make_mesh(num_devices=4, model_parallel=2)
    tx = JO.make_optimizer("adam", lr, total_steps=steps)
    jstep = jtp.build_tp_lm_train_step(jcfg, tx, mesh, tree, donate=False)
    p = jtp.shard_params(tree, mesh)
    o = jtp.shard_params(jax.device_get(tx.init(tree)), mesh)
    g = jdp.replicate(jnp.zeros((), jnp.int32), mesh)
    want = []
    for t in batches:
        x = jdp.shard_global_batch({"x": jnp.asarray(t)}, mesh)["x"]
        p, o, g, m = jstep(p, o, g, x, jax.random.PRNGKey(0))
        want.append(float(m["loss"]))
    for proc in procs:
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out
    results = [json.loads((tmp_path / f"rank_{r}.json").read_text()) for r in range(4)]
    assert [r["mesh"] for r in results] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    for r in results:
        np.testing.assert_allclose(r["losses"], want, atol=1e-4, rtol=0)
    assert want[-1] != want[0]  # the weights moved
    # The data replicas stay in step: every rank gathers the same model.
    first = np.load(tmp_path / "gathered_0.npz")
    for r in (1, 2, 3):
        other = np.load(tmp_path / f"gathered_{r}.npz")
        assert set(other.files) == set(first.files)
        for k in first.files:
            np.testing.assert_array_equal(other[k], first[k], err_msg=f"rank {r}: {k}")
