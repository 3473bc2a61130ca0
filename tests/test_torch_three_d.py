"""The port's 3D parallelism (data x pipe x model) against the JAX
package's, on the CPU.

  * ``three_d_param_specs`` splits the leaves the JAX ``three_d_param_specs``
    splits over 'model', bias leaves included, and ``init_3d_params`` is the
    tp model's weights regrouped into stages;
  * on a (1, 1, 1) mesh, ``build_3d_lm_train_step`` takes the JAX step's
    three Adam steps (bias-free, f32): losses within 1e-4, parameters within
    2e-4 of the largest;
  * four gloo processes (data 1 x pipe 2 x model 2, a FileStore rendezvous)
    take the JAX step's three SGD steps (with bias: the k-projection bias's
    true gradient is zero, and Adam would turn its float noise into
    full-size updates; tests/test_three_d.py) on a (1, 2, 2) mesh: losses
    within 1e-4, parameters within 1e-5, the mesh layout JAX's, and the
    replicated leaves bitwise equal across each pipe group.

The JAX steps run their dense reference attention; the port runs flash
through its plain kernel versions.
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

from distributed_tensorflow_tpu.parallel import data_parallel as jdp
from distributed_tensorflow_tpu.parallel import three_d as jtd
from distributed_tensorflow_tpu.parallel.mesh import make_mesh3
from distributed_tensorflow_tpu.models import transformer as JT
from distributed_tensorflow_tpu.train import optimizers as JO
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import (
    three_d_params_from_jax,
    three_d_params_to_jax,
    tp_params_from_jax,
    tp_params_to_jax,
)
from distributed_tensorflow_tpu_torch.parallel import pipeline_parallel as tpp
from distributed_tensorflow_tpu_torch.parallel import tensor_parallel as ttp
from distributed_tensorflow_tpu_torch.parallel import three_d as ttd
from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_tpu_torch.train.optimizers import make_optimizer

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

B, S, STEPS = 4, 16, 3
SHAPE = dict(vocab_size=32, d_model=32, num_heads=4, num_layers=2, d_ff=64, max_seq_len=S,
             position="rope", num_kv_heads=2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _configs(**kw):
    kw = dict(SHAPE, **kw)
    return (JT.TransformerConfig(compute_dtype=jnp.float32, **{**kw, "attention": "dense"}),
            TT.TransformerConfig(compute_dtype=torch.float32, **{**kw, "attention": "flash"}))


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(6)
    return np.stack([rng.integers(0, SHAPE["vocab_size"], (B, S)).astype(np.int32)
                     for _ in range(STEPS)])


def _host(tcfg, num_stages):
    """The JAX ``init_3d_params`` layout (tp blocks stacked into stages,
    nested numpy dicts) of the tp model the port draws from seed 0: both
    packages then start from these weights."""
    return tpp.stack_stage_params(tp_params_to_jax(ttp.TpTransformerLM(tcfg, device="cpu")),
                                  num_stages)


def _jax_3d_run(jcfg, host, batches, pipe, model, optimizer, lr):
    """The JAX 3d step on a (1, pipe, model) mesh from ``host``: its losses
    and final parameters."""
    mesh = make_mesh3(pipe * model, pipeline_parallel=pipe, model_parallel=model)
    tx = JO.make_optimizer(optimizer, lr, total_steps=STEPS)
    step = jtd.build_3d_lm_train_step(jcfg, tx, mesh, host, num_microbatches=2, donate=False)
    p = jtd.shard_3d_params(host, mesh)
    o = jtd.shard_3d_params(jax.device_get(tx.init(host)), mesh)
    g = jdp.replicate(jnp.zeros((), jnp.int32), mesh)
    losses = []
    for t in batches:
        x = jdp.shard_global_batch({"x": jnp.asarray(t)}, mesh, spec=P("data", None))["x"]
        p, o, g, m = step(p, o, g, x, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return np.array(losses), jax.device_get(p)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _torch_name(keys):
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(keys[-1], keys[-1])
    return ".".join([*keys[:-1], leaf])


@pytest.mark.parametrize("use_bias", [True, False])
def test_specs_split_what_the_jax_specs_split(use_bias):
    _, tcfg = _configs(use_bias=use_bias)
    specs = jtd.three_d_param_specs(_host(tcfg, 2))
    per = SHAPE["num_layers"] // 2
    for stage in range(2):
        state = ttd.init_3d_params(tcfg, stage, 2, seed=0)
        # init_3d_params is the tp model's weights (seed 0) regrouped into stages.
        want_state = tpp.stage_state_dict(ttp.init_tp_params(tcfg, 0), stage, 2)
        assert state.keys() == want_state.keys()
        assert all(torch.equal(state[k], want_state[k]) for k in state)
        got, want = ttd.three_d_param_specs(state), {}
        for path, spec in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda x: isinstance(x, P)
        ):
            keys = [k.key for k in path]
            names = [_torch_name(keys)]
            if keys[0] == "stages":  # (stage, layer, *the layer's dims)
                assert spec[:2] == ("pipe", None)
                names = [_torch_name(["blocks", str(i), *keys[1:]]) for i in range(per)]
                spec = P(*spec[2:])
            axes = [i for i, a in enumerate(spec) if a == "model"]
            for name in names:
                ndim = state[name].dim()  # a flax kernel (in, out) is a weight (out, in)
                want[name] = None if not axes else (ndim - 1 - axes[0] if ndim == 2 else axes[0])
        assert got == want
    if use_bias:
        assert got["blocks.0.q.bias"] == 0 and got["blocks.0.proj_bias"] is None


def test_world_of_one_matches_jax(batches):
    jcfg, tcfg = _configs(use_bias=False)
    host = _host(tcfg, 1)
    want_losses, want = _jax_3d_run(jcfg, host, batches, 1, 1, "adam", 1e-2)
    model = ttd.ThreeDLM(tcfg, device="cpu", state=three_d_params_from_jax(host, 0, Mesh()))
    opt = make_optimizer("adam", model.parameters(), 1e-2, total_steps=STEPS)
    step = ttd.build_3d_lm_train_step(model, opt, num_microbatches=2)
    losses = [float(step(torch.from_numpy(t))["loss"]) for t in batches]
    np.testing.assert_allclose(losses, want_losses, atol=1e-4, rtol=0)
    assert want_losses[-1] != want_losses[0]  # the weights moved
    got = _leaves(three_d_params_to_jax([model]))
    assert set(got) == set(_leaves(want))
    scale = max(float(np.abs(w).max()) for w in _leaves(want).values())
    for path, w in _leaves(want).items():
        np.testing.assert_allclose(got[path], w, atol=2e-4 * scale, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_3d_step_needs_tp_blocks():
    _, tcfg = _configs()
    model = tpp.PipelineLM(tcfg, device="cpu")
    with pytest.raises(TypeError, match="TpBlocks"):
        ttd.build_3d_lm_train_step(model, make_optimizer("sgd", model.parameters(), 0.1, 1))


# One rank of the gloo run: imports the port and torch only.
_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import three_d_params_from_jax
from distributed_tensorflow_tpu_torch.parallel import tensor_parallel as ttp
from distributed_tensorflow_tpu_torch.parallel import three_d as ttd
from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh3
from distributed_tensorflow_tpu_torch.train.optimizers import make_optimizer

rank, tmp = int(sys.argv[1]), sys.argv[2]
spec = json.load(open(f"{tmp}/spec.json"))
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=4)
mesh = make_mesh3(pipeline_parallel=2, model_parallel=2)
cfg = TT.TransformerConfig(compute_dtype=torch.float32, **spec["cfg"])
flat = np.load(f"{tmp}/params.npz")
tree = {}
for key in flat.files:
    *mods, leaf = key.split("/")
    node = tree
    for m in mods:
        node = node.setdefault(m, {})
    node[leaf] = flat[key]
model = ttd.ThreeDLM(cfg, mesh, device="cpu",
                     state=three_d_params_from_jax(tree, mesh.pipe_rank, mesh))
opt = make_optimizer("sgd", model.parameters(), spec["lr"], total_steps=spec["steps"])
step = ttd.build_3d_lm_train_step(model, opt, num_microbatches=2)
losses = [float(step(torch.from_numpy(t))["loss"]) for t in np.load(f"{tmp}/batches.npy")]
np.savez(f"{tmp}/state_{rank}.npz", **{k: v.numpy() for k, v in model.state_dict().items()})
whole = ttp.gather_params(model.state_dict(), mesh)
np.savez(f"{tmp}/gathered_{rank}.npz", **{k: v.numpy() for k, v in whole.items()})
json.dump({"losses": losses,
           "mesh": [mesh.data_rank, mesh.pipe_rank, mesh.model_rank, list(mesh.pipe_ranks)]},
          open(f"{tmp}/rank_{rank}.json", "w"))
dist.destroy_process_group()
"""


LR_SGD = 0.1


@pytest.fixture(scope="module", autouse=True)
def gloo_ranks(batches, tmp_path_factory):
    """The four gloo ranks of test_gloo_data1_pipe2_model2_matches_jax,
    started when the file starts so that they run beside its other tests."""
    tmp = tmp_path_factory.mktemp("three_d_gloo")
    _, tcfg = _configs(use_bias=True)
    host = _host(tcfg, 2)
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(host)}
    np.savez(tmp / "params.npz", **flat)
    np.save(tmp / "batches.npy", batches)
    cfg = dict(SHAPE, use_bias=True, attention="flash")
    (tmp / "spec.json").write_text(json.dumps({"cfg": cfg, "lr": LR_SGD, "steps": STEPS}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    env["OMP_NUM_THREADS"] = "1"  # tiny shapes: one thread per rank keeps the host free
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(tmp)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(4)]
    yield host, tmp, procs
    for proc in procs:
        proc.kill()
        proc.communicate()


def test_gloo_data1_pipe2_model2_matches_jax(batches, gloo_ranks):
    host, tmp, procs = gloo_ranks
    jcfg, _ = _configs(use_bias=True)
    want, final = _jax_3d_run(jcfg, host, batches, 2, 2, "sgd", LR_SGD)
    for proc in procs:
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out
    results = [json.loads((tmp / f"rank_{r}.json").read_text()) for r in range(4)]
    # JAX's (data, pipe, model) layout: rank r at (r // 4, (r // 2) % 2, r % 2).
    assert [r["mesh"] for r in results] == [[0, 0, 0, [0, 2]], [0, 0, 1, [1, 3]],
                                            [0, 1, 0, [0, 2]], [0, 1, 1, [1, 3]]]
    for r in results:
        np.testing.assert_allclose(r["losses"], want, atol=1e-4, rtol=0)
    assert want[-1] != want[0]  # the weights moved
    # The whole model after the last step: stage 0 from rank 0, stage 1 from rank 2.
    stages = [{k: torch.from_numpy(v) for k, v in np.load(tmp / f"gathered_{r}.npz").items()}
              for r in (0, 2)]
    got = tpp.unstage_state_dicts(stages)
    ref = tp_params_from_jax(jtd.unstack_stage_params(final))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)
    # Embeddings, ln_f and the head: the same bits on every stage of a pipe group.
    states = [np.load(tmp / f"state_{r}.npz") for r in range(4)]
    replicated = [k for k in states[0].files if not k.startswith("blocks.")]
    assert replicated
    for a, b in ((0, 2), (1, 3)):
        for k in replicated:
            np.testing.assert_array_equal(states[b][k], states[a][k], err_msg=f"{a}/{b} {k}")
