"""The port's data parallelism over a process group against the JAX
package's, on the CPU.

  * two gloo processes (a FileStore rendezvous) take the same three Adam
    steps of the packed ``TransformerLM`` (flash attention through its plain
    path, rope, 4 query heads on 2 kv heads) as the JAX ``build_lm_train_step``
    on a two-device mesh: losses within 1e-4, the tolerance of
    tests/test_torch_tensor_parallel.py;
  * both ranks end bitwise equal, ``check_cross_process_consistency``
    returns True, and a weight perturbed on one rank makes it raise on both;
  * ``param_fingerprint`` and ``tree_bytes`` of weights carried across
    equal the JAX package's;
  * the one-device step reduces nothing (no process group is needed).
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

from distributed_tensorflow_tpu.models import transformer as JT
from distributed_tensorflow_tpu.parallel import consistency as jcons
from distributed_tensorflow_tpu.parallel import data_parallel as jdp
from distributed_tensorflow_tpu.parallel.mesh import make_mesh
from distributed_tensorflow_tpu.train import optimizers as JO
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import transformer_params_from_jax
from distributed_tensorflow_tpu_torch.parallel import consistency as tcons
from distributed_tensorflow_tpu_torch.parallel.data_parallel import build_lm_train_step
from distributed_tensorflow_tpu_torch.train.optimizers import make_optimizer

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

B, S, STEPS, LR = 4, 32, 3, 1e-2
SHAPE = dict(vocab_size=32, d_model=32, num_heads=4, num_kv_heads=2, num_layers=2, d_ff=64,
             max_seq_len=S, attention="flash", position="rope")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_params(seed=3):
    # The JAX steps run their dense reference attention: the port's flash
    # is held against the JAX kernels in tests/test_torch_attention.py.
    cfg = JT.TransformerConfig(compute_dtype=jnp.float32, **{**SHAPE, "attention": "dense"})
    params = JT.TransformerLM(cfg).init(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, 8), jnp.int32))["params"]
    return cfg, jax.device_get(params)


def _torch_model(params):
    model = TT.TransformerLM(TT.TransformerConfig(compute_dtype=torch.float32, **SHAPE),
                             device="cpu")
    model.load_state_dict(transformer_params_from_jax(params))
    return model


# One rank of the gloo run: imports the port and torch only.
_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from distributed_tensorflow_tpu_torch.models import transformer as TT
from distributed_tensorflow_tpu_torch.models.convert import transformer_params_from_jax
from distributed_tensorflow_tpu_torch.parallel import consistency
from distributed_tensorflow_tpu_torch.parallel.data_parallel import build_lm_train_step
from distributed_tensorflow_tpu_torch.train.optimizers import make_optimizer

rank, tmp = int(sys.argv[1]), sys.argv[2]
spec = json.load(open(f"{tmp}/spec.json"))
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=2)
flat = np.load(f"{tmp}/params.npz")
tree = {}
for key in flat.files:
    *mods, leaf = key.split("/")
    node = tree
    for m in mods:
        node = node.setdefault(m, {})
    node[leaf] = flat[key]
model = TT.TransformerLM(TT.TransformerConfig(compute_dtype=torch.float32, **spec["cfg"]),
                         device="cpu")
model.load_state_dict(transformer_params_from_jax(tree))
opt = make_optimizer("adam", model.parameters(), spec["lr"], total_steps=spec["steps"])
step = build_lm_train_step(model, opt, group=dist.group.WORLD)
batches = np.load(f"{tmp}/batches.npy")
per = batches.shape[1] // 2
rows = slice(rank * per, (rank + 1) * per)
losses = [float(step(torch.from_numpy(t[rows]))["loss"]) for t in batches]
np.savez(f"{tmp}/params_{rank}.npz", **{k: v.numpy() for k, v in model.state_dict().items()})
consistent = consistency.check_cross_process_consistency(model)
with torch.no_grad():  # one rank's weight moves: the check must catch it on both
    if rank == 1:
        next(model.parameters()).view(-1)[0] += 1e-3
try:
    consistency.check_cross_process_consistency(model)
    caught = None
except RuntimeError as e:
    caught = str(e)
json.dump({"losses": losses, "consistent": consistent, "caught": caught,
           "fingerprint": consistency.param_fingerprint(model)},
          open(f"{tmp}/rank_{rank}.json", "w"))
dist.destroy_process_group()
"""


def test_gloo_two_ranks_match_jax_dp_step(tmp_path):
    jcfg, params = _jax_params()
    rng = np.random.default_rng(7)
    batches = rng.integers(0, SHAPE["vocab_size"], (STEPS, B, S)).astype(np.int32)
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(tmp_path / "params.npz", **flat)
    np.save(tmp_path / "batches.npy", batches)
    (tmp_path / "spec.json").write_text(json.dumps({"cfg": SHAPE, "lr": LR, "steps": STEPS}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    env["OMP_NUM_THREADS"] = "1"  # tiny shapes: one thread per rank keeps the host free
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(tmp_path)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    # The JAX reference runs while the ranks do.
    mesh = make_mesh(num_devices=2)
    tx = JO.make_optimizer("adam", LR, total_steps=STEPS)
    jstep = jdp.build_lm_train_step(jcfg, tx, mesh)
    p, o = jdp.replicate(params, mesh), jdp.replicate(tx.init(params), mesh)
    n = jnp.zeros((), jnp.int32)
    want = []
    for t in batches:
        p, o, n, m = jstep(p, o, n, jdp.shard_global_batch({"x": jnp.asarray(t)}, mesh)["x"],
                           jax.random.PRNGKey(0))
        want.append(float(m["loss"]))
    for proc in procs:
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out
    results = [json.loads((tmp_path / f"rank_{r}.json").read_text()) for r in range(2)]
    for r in results:
        np.testing.assert_allclose(r["losses"], want, atol=1e-4, rtol=0)
        assert r["consistent"] is True
        assert r["caught"] is not None and "parameter divergence" in r["caught"]
    assert results[0]["losses"] == results[1]["losses"]
    assert want[-1] != want[0]  # the weights moved
    assert results[0]["fingerprint"] != results[1]["fingerprint"]  # after the perturbation
    # The replicas stayed in step: bitwise equal parameters before the perturbation.
    first, second = np.load(tmp_path / "params_0.npz"), np.load(tmp_path / "params_1.npz")
    assert set(first.files) == set(second.files)
    for k in first.files:
        np.testing.assert_array_equal(second[k], first[k], err_msg=k)


def test_fingerprint_and_bytes_match_jax():
    """The same weights give the same fingerprint and byte count in both
    packages; one changed element changes the fingerprint."""
    _, params = _jax_params(seed=5)
    model = _torch_model(params)
    assert tcons.param_fingerprint(model) == jcons.param_fingerprint(params)
    assert tcons.param_fingerprint(model) == tcons.param_fingerprint(
        jax.tree_util.tree_map(np.asarray, params))
    assert tcons.tree_bytes(model) == jcons.tree_bytes(params)
    with torch.no_grad():
        next(model.parameters()).view(-1)[0] += 1.0
    assert tcons.param_fingerprint(model) != jcons.param_fingerprint(params)


def test_world_of_one_is_trivially_consistent():
    _, params = _jax_params()
    assert tcons.check_cross_process_consistency(_torch_model(params)) is True


def test_one_device_step_reduces_nothing(monkeypatch):
    """Without a group the step is the one-device step: no collective is
    called, and two steps train."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "all_reduce", lambda *a, **k: pytest.fail("all_reduce called"))
    _, params = _jax_params()
    model = _torch_model(params)
    step = build_lm_train_step(model, make_optimizer("adam", model.parameters(), LR, 2))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 32, (2, S)).astype(np.int64))
    losses = [float(step(tokens)["loss"]) for _ in range(2)]
    assert losses[1] < losses[0]
