"""The port's pipeline parallelism against the JAX package's, on the CPU.

  * the stage stacking equals the JAX ``stack_stage_params`` leaf for leaf
    and round-trips, as do the state-dict stage split and the weight bridge;
  * in a world of one, ``build_pp_lm_train_step`` with 1, 2 and 4
    microbatches takes the JAX step's three Adam steps (bias-free, f32):
    losses within 1e-4, parameters within 2e-4 of the largest; the same with
    ``remat`` on (against the same JAX step);
  * two gloo processes (2 stages, 2 microbatches, a FileStore rendezvous)
    take the JAX step's three steps on a 2-device mesh: losses within 1e-4,
    and the replicated leaves bitwise equal on both stages;
  * ``remat`` on the dp and tp steps equals the step without it.

The JAX steps run their dense reference attention (tests/test_torch_
attention.py holds the port's flash against the JAX kernels in interpret
mode); the port runs flash through its plain kernel versions.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import transformer as JT
from distributed_tensorflow_tpu.parallel import data_parallel as jdp
from distributed_tensorflow_tpu.parallel import pipeline_parallel as jpp
from distributed_tensorflow_tpu.parallel.mesh import make_mesh
from distributed_tensorflow_tpu.train import optimizers as JO
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import (
    pp_params_from_jax,
    pp_params_to_jax,
    transformer_params_from_jax,
    transformer_params_to_jax,
)
from distributed_tensorflow_tpu_torch.parallel import pipeline_parallel as tpp
from distributed_tensorflow_tpu_torch.parallel import tensor_parallel as ttp
from distributed_tensorflow_tpu_torch.parallel.data_parallel import build_lm_train_step
from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_tpu_torch.train.optimizers import make_optimizer

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

B, S, STEPS, LR = 4, 16, 3, 1e-2
SHAPE = dict(vocab_size=32, d_model=32, num_heads=4, num_layers=4, d_ff=64, max_seq_len=S,
             use_bias=False)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _configs(**kw):
    kw = dict(SHAPE, **kw)
    return (JT.TransformerConfig(compute_dtype=jnp.float32, **{**kw, "attention": "dense"}),
            TT.TransformerConfig(compute_dtype=torch.float32, **{**kw, "attention": "flash"}))


@pytest.fixture(scope="module")
def plain():
    """A plain ``TransformerLM`` flax tree (nested numpy dicts), drawn by the
    port (seed 0): both packages then start from these weights."""
    _, tcfg = _configs()
    return transformer_params_to_jax(TT.TransformerLM(tcfg, seed=0, device="cpu"))


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(3)
    return np.stack([rng.integers(0, SHAPE["vocab_size"], (B, S)).astype(np.int32)
                     for _ in range(STEPS)])


def _jax_pp_run(plain, batches, num_stages, num_microbatches):
    """The JAX pp step on a ``num_stages``-device mesh: its losses and the
    final stacked parameters."""
    jcfg, _ = _configs()
    stacked = jpp.stack_stage_params(plain, num_stages)
    mesh = make_mesh(num_devices=num_stages, model_parallel=num_stages)
    tx = JO.make_optimizer("adam", LR, total_steps=STEPS)
    step = jpp.build_pp_lm_train_step(jcfg, tx, mesh, stacked, num_microbatches, donate=False)
    p = jpp.shard_pp_params(stacked, mesh)
    o = jpp.shard_pp_params(jax.device_get(tx.init(stacked)), mesh)
    g = jdp.replicate(jnp.zeros((), jnp.int32), mesh)
    losses = []
    for t in batches:
        x = jdp.shard_global_batch({"x": jnp.asarray(t)}, mesh)["x"]
        p, o, g, m = step(p, o, g, x, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return np.array(losses), jax.device_get(p)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def test_stage_stacking_matches_jax_and_round_trips(plain):
    for num_stages in (1, 2, 4):
        want = jpp.stack_stage_params(plain, num_stages)
        got = tpp.stack_stage_params(plain, num_stages)
        assert set(_leaves(got)) == set(_leaves(want))
        for path, w in _leaves(want).items():
            np.testing.assert_array_equal(_leaves(got)[path], w)
        back = tpp.unstack_stage_params(got)
        jax.tree_util.tree_map(np.testing.assert_array_equal, back, plain)
        # The state-dict form: every stage's share, and back to the whole model.
        whole = transformer_params_from_jax(plain)
        stages = [tpp.stage_state_dict(whole, s, num_stages) for s in range(num_stages)]
        assert all(len([k for k in st if k.startswith("blocks.")]) ==
                   len([k for k in whole if k.startswith("block_")]) // num_stages
                   for st in stages)
        merged = tpp.unstage_state_dicts(stages)
        assert merged.keys() == whole.keys()
        assert all(torch.equal(merged[k], whole[k]) for k in whole)
        # The bridge: each stage's module from the stacked tree, and back.
        _, tcfg = _configs()
        models = []
        for s in range(num_stages):
            mesh = Mesh(pipe_size=num_stages, pipe_rank=s)
            models.append(tpp.PipelineLM(tcfg, mesh, device="cpu",
                                         state=pp_params_from_jax(want, s)))
        jax.tree_util.tree_map(np.testing.assert_array_equal, pp_params_to_jax(models), want)


def test_stage_draws_the_plain_model_from_its_seed():
    """Every stage keeps its layers of ``TransformerLM(cfg, seed)``."""
    _, tcfg = _configs()
    whole = TT.TransformerLM(tcfg, seed=4, device="cpu").state_dict()
    for s in range(2):
        got = tpp.PipelineLM(tcfg, Mesh(pipe_size=2, pipe_rank=s), seed=4,
                             device="cpu").state_dict()
        want = tpp.stage_state_dict(whole, s, 2)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)


def _port_pp_run(plain, batches, num_microbatches, remat=False):
    _, tcfg = _configs(remat=remat)
    model = tpp.PipelineLM(tcfg, device="cpu", state=pp_params_from_jax(
        tpp.stack_stage_params(plain, 1), 0))
    opt = make_optimizer("adam", model.parameters(), LR, total_steps=STEPS)
    step = tpp.build_pp_lm_train_step(model, opt, num_microbatches=num_microbatches)
    losses = [float(step(torch.from_numpy(t))["loss"]) for t in batches]
    return np.array(losses), pp_params_to_jax([model])


@pytest.fixture(scope="module")
def jax_pp(plain, batches):
    """:func:`_jax_pp_run` by (stages, microbatches), each run once."""
    return functools.cache(lambda stages, m: _jax_pp_run(plain, batches, stages, m))


@pytest.mark.parametrize("num_microbatches,remat", [(1, False), (2, False), (4, False),
                                                    (2, True)])
def test_world_of_one_matches_jax(plain, batches, jax_pp, num_microbatches, remat):
    """Under remat the port recomputes each layer on backward: its step
    is held against the same JAX step (remat changes no number)."""
    want_losses, want = jax_pp(1, num_microbatches)
    losses, got = _port_pp_run(plain, batches, num_microbatches, remat)
    np.testing.assert_allclose(losses, want_losses, atol=1e-4, rtol=0)
    assert want_losses[-1] != want_losses[0]  # the weights moved
    scale = max(float(np.abs(w).max()) for w in _leaves(want).values())
    assert set(_leaves(got)) == set(_leaves(want))
    for path, w in _leaves(want).items():
        np.testing.assert_allclose(_leaves(got)[path], w, atol=2e-4 * scale, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_microbatches_must_divide_the_local_batch():
    _, tcfg = _configs()
    model = tpp.PipelineLM(tcfg, device="cpu")
    step = tpp.build_pp_lm_train_step(
        model, make_optimizer("sgd", model.parameters(), LR, total_steps=1), num_microbatches=3)
    with pytest.raises(ValueError, match="not divisible into 3 microbatches"):
        step(torch.zeros((B, S), dtype=torch.int64))


@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_remat_step_equals_the_plain_step(mode):
    """``remat`` recomputes each block on backward: the same losses and the
    same parameters after three Adam steps, in a world of one."""
    rng = np.random.default_rng(5)
    tokens = [torch.from_numpy(rng.integers(0, SHAPE["vocab_size"], (B, S))) for _ in range(3)]
    out = []
    for remat in (False, True):
        _, tcfg = _configs(remat=remat, position="rope", num_kv_heads=2)
        if mode == "dp":
            model = TT.TransformerLM(tcfg, seed=1, device="cpu")
            build = build_lm_train_step
        else:
            model = ttp.TpTransformerLM(tcfg, seed=1, device="cpu")
            build = ttp.build_tp_lm_train_step
        step = build(model, make_optimizer("adam", model.parameters(), LR, total_steps=3))
        out.append(([float(step(t)["loss"]) for t in tokens], model.state_dict()))
    (plain_losses, plain_state), (remat_losses, remat_state) = out
    assert remat_losses == plain_losses
    assert all(torch.equal(remat_state[k], plain_state[k]) for k in plain_state)


# One rank of the gloo run: imports the port and torch only.
_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import pp_params_from_jax, pp_params_to_jax
from distributed_tensorflow_tpu_torch.parallel import pipeline_parallel as tpp
from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh3
from distributed_tensorflow_tpu_torch.train.optimizers import make_optimizer

rank, tmp = int(sys.argv[1]), sys.argv[2]
spec = json.load(open(f"{tmp}/spec.json"))
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=2)
mesh = make_mesh3(pipeline_parallel=2)
cfg = TT.TransformerConfig(compute_dtype=torch.float32, **spec["cfg"])
flat = np.load(f"{tmp}/params.npz")
tree = {}
for key in flat.files:
    *mods, leaf = key.split("/")
    node = tree
    for m in mods:
        node = node.setdefault(m, {})
    node[leaf] = flat[key]
model = tpp.PipelineLM(cfg, mesh, device="cpu", state=pp_params_from_jax(tree, mesh.pipe_rank))
opt = make_optimizer("adam", model.parameters(), spec["lr"], total_steps=spec["steps"])
step = tpp.build_pp_lm_train_step(model, opt, num_microbatches=2)
losses = [float(step(torch.from_numpy(t))["loss"]) for t in np.load(f"{tmp}/batches.npy")]
np.savez(f"{tmp}/state_{rank}.npz", **{k: v.numpy() for k, v in model.state_dict().items()})
json.dump({"losses": losses, "stage": mesh.pipe_rank, "peers": list(mesh.pipe_ranks)},
          open(f"{tmp}/rank_{rank}.json", "w"))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module", autouse=True)
def gloo_ranks(plain, batches, tmp_path_factory):
    """The two gloo ranks of test_gloo_two_stages_match_jax, started when
    the file starts so that they run beside its other tests."""
    tmp = tmp_path_factory.mktemp("pp_gloo")
    stacked = tpp.stack_stage_params(plain, 2)
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(stacked)}
    np.savez(tmp / "params.npz", **flat)
    np.save(tmp / "batches.npy", batches)
    cfg = dict(SHAPE, attention="flash")
    (tmp / "spec.json").write_text(json.dumps({"cfg": cfg, "lr": LR, "steps": STEPS}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    env["OMP_NUM_THREADS"] = "1"  # tiny shapes: one thread per rank keeps the host free
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(tmp)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    yield tmp, procs
    for proc in procs:
        proc.kill()
        proc.communicate()


def test_gloo_two_stages_match_jax(plain, batches, gloo_ranks):
    tmp, procs = gloo_ranks
    want, _ = _jax_pp_run(plain, batches, 2, 2)
    for proc in procs:
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out
    results = [json.loads((tmp / f"rank_{r}.json").read_text()) for r in range(2)]
    assert [(r["stage"], r["peers"]) for r in results] == [(0, [0, 1]), (1, [0, 1])]
    for r in results:  # the loss reaches every stage, the chief (stage 0) too
        np.testing.assert_allclose(r["losses"], want, atol=1e-4, rtol=0)
    assert want[-1] != want[0]  # the weights moved
    # Embeddings, ln_f and the head: the same bits on both stages.
    states = [np.load(tmp / f"state_{r}.npz") for r in range(2)]
    replicated = [k for k in states[0].files if not k.startswith("blocks.")]
    assert replicated and set(replicated) == {k for k in states[1].files
                                              if not k.startswith("blocks.")}
    for k in replicated:
        np.testing.assert_array_equal(states[1][k], states[0][k], err_msg=k)
