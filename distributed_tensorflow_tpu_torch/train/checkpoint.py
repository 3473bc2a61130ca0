"""Checkpoints and inference bundles.

Counterpart of ``distributed_tensorflow_tpu/train/checkpoint.py``:

* the committed-step format ``dtt.sharded.v1`` of its ``_ShardStore``.
  Under ``<dir>/<step>/`` each rank K writes ``shard_p<K>.npz`` (every leaf
  or block it owns, as a flat uint8 view) and ``manifest_p<K>.json`` (each
  entry's ``key``, ``path`` as ``jax.tree_util.keystr`` writes it,
  ``tokens``, ``shape``, ``dtype`` and ``index``: None for a whole leaf,
  else the block's ``[start, stop)`` per dimension in the whole leaf); the
  chief writes ``COMMIT.json`` last, through an atomic rename, once every
  rank's write has succeeded. A step without it is invisible. Either
  package reads what the other writes (:func:`read_step`,
  :func:`list_committed_steps`, :func:`write_committed_step`);
* :class:`CheckpointManager`: the timed save gate (``--save_secs``),
  keep-N retention, and the restore of the newest readable step, walking
  back past steps that cannot be read;
* inference bundles: an 8-byte little-endian header length, a JSON header
  ``{"format": "dtf_tpu.params.v1", ...}``, then the params as flax's
  msgpack state dict (``utils/msgpack_state.py``).

The trainer's state tree (:func:`train_state`) is::

    params                         the model's parameters under their flax
                                   tree paths (models/convert.py: Dense
                                   kernels (in, out)), so that the JAX
                                   package's read_step gives the params
                                   tree its own models load
    opt_state/state/<name>/<key>   the torch optimizer's state of parameter
                                   <name> (its state-dict name): ``step``,
                                   ``exp_avg``, ``exp_avg_sq`` for Adam and
                                   AdamW, ``momentum_buffer`` for SGD with
                                   momentum (plain SGD keeps none)
    opt_state/schedule_count       the LambdaLR count (``last_epoch``)
    global_step                    int32

Under tensor parallelism a leaf that the model ranks slice
(``parallel/tensor_parallel.py::tp_param_specs``: parameters and their
moments) is written in blocks, each model rank of the first data row its
own, with its bounds in the whole leaf; whole leaves are the chief's to
write. A restore reads the whole tree and splits it again
(``shard_params``), so a run may resume at another split.

Saves are synchronous: the training loop waits for the bytes to reach the
disk (``stall_seconds`` counts that time). The JAX package's snapshot
thread, and its single-process Orbax format, are not ported; this package
writes ``dtt.sharded.v1`` in every mode, which the JAX package's
CheckpointManager also restores.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zipfile
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.parallel.pipeline_parallel import unstack_stage_params
from distributed_tensorflow_tpu_torch.utils import faults, msgpack_state
from distributed_tensorflow_tpu_torch.utils.logging import get_logger
from distributed_tensorflow_tpu_torch.utils.retry import retry_call

log = get_logger(__name__)

FORMAT = "dtt.sharded.v1"
BUNDLE_FORMAT = "dtf_tpu.params.v1"
# I/O retry envelope: transient filesystem errors get a couple of quick
# retries; a torn or corrupt step falls through to the walk-back.
_IO_ATTEMPTS = 3
_IO_BASE_DELAY = 0.1
_IO_MAX_DELAY = 2.0


@dataclass(frozen=True)
class Shard:
    """A leaf's block that this rank writes: ``value`` (a tensor or array)
    and ``index``, its ``[start, stop)`` per dimension in the whole leaf."""

    value: Any
    index: list


# ---------------------------------------------------------------------------
# Trees.
# ---------------------------------------------------------------------------


def _flatten(tree: Any, prefix: tuple = ()) -> Iterator[tuple[list, Any]]:
    """``(tokens, leaf)`` in the JAX package's order: dict keys sorted,
    sequences by index, None an empty subtree. Tokens are ``{"k": key}`` or
    ``{"i": index}``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + ({"k": str(k)},))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + ({"i": i},))
    elif tree is not None:
        yield list(prefix), tree


def _keystr(tokens: list) -> str:
    """``jax.tree_util.keystr`` of a key path: ``['params']['ln_f'][0]``."""
    return "".join(f"[{t['k']!r}]" if "k" in t else f"[{t['i']}]" for t in tokens)


def _set_path(tree: dict, path: tuple, value: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _host(value: Any) -> np.ndarray:
    """A leaf's value as a C-ordered numpy array on the host (a function
    that builds it is called first)."""
    if callable(value):
        value = value()
    if isinstance(value, torch.Tensor):
        return value.detach().contiguous().cpu().numpy()
    return np.ascontiguousarray(value) if np.ndim(value) else np.asarray(value)


def _assemble_full(elist, load) -> np.ndarray:
    """A whole array from its blocks; the whole extent of each dimension
    is the largest stop over the blocks."""
    _, e0 = elist[0]
    shape = [max(e["index"][d][1] for _, e in elist) for d in range(len(e0["index"]))]
    value = np.empty(shape, np.dtype(e0["dtype"]))
    for p, e in elist:
        value[tuple(slice(lo, hi) for lo, hi in e["index"])] = load(p, e)
    return value


def _assemble_raw(by_path, load) -> Any:
    """The template-free tree: dicts and lists rebuilt from the tokens."""
    out: Any = {}
    for elist in by_path.values():
        full = [pe for pe in elist if pe[1]["index"] is None]
        value = load(*full[0]) if full else _assemble_full(elist, load)
        node = out
        toks = elist[0][1]["tokens"]
        for i, t in enumerate(toks):
            last = i == len(toks) - 1
            if "k" in t:
                if last:
                    node[t["k"]] = value
                else:
                    node = node.setdefault(t["k"], [] if "i" in toks[i + 1] else {})
            else:
                idx = t["i"]
                while len(node) <= idx:
                    node.append(None)
                if last:
                    node[idx] = value
                else:
                    if node[idx] is None:
                        node[idx] = [] if "i" in toks[i + 1] else {}
                    node = node[idx]
    return out


class _Spec:
    """A template leaf that gives only a shape."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def _match_template(step: int, tree: Any, template: Any, tokens: tuple = ()) -> Any:
    """``tree``'s leaves in ``template``'s structure; raises ``OSError``
    naming a leaf the step lacks or holds at another shape."""
    if isinstance(template, dict):
        return {k: _match_template(step, tree, v, tokens + ({"k": str(k)},))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_match_template(step, tree, v, tokens + ({"i": i},))
                              for i, v in enumerate(template))
    if template is None:
        return None
    node = tree
    for t in tokens:
        try:
            node = node[t["k"] if "k" in t else t["i"]]
        except (KeyError, IndexError, TypeError):
            raise OSError(f"checkpoint step {step} is missing leaf {_keystr(list(tokens))}") from None
    if tuple(np.shape(template)) != tuple(np.shape(node)):
        raise OSError(f"checkpoint step {step}: shape mismatch for {_keystr(list(tokens))}: "
                      f"saved {np.shape(node)}, template {tuple(np.shape(template))}")
    return node


# ---------------------------------------------------------------------------
# The committed-step store.
# ---------------------------------------------------------------------------


class ShardStore:
    """One rank's view of the per-rank shard files and commit markers under
    ``directory``. ``rank`` and ``world_size`` are arguments, so one
    process can write every rank's files (tests)."""

    COMMIT = "COMMIT.json"

    def __init__(self, directory: str, rank: int = 0, world_size: int = 1):
        self.directory = directory
        self.rank, self.world_size = rank, world_size

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    @staticmethod
    def is_committed(step_dir: str) -> bool:
        return os.path.exists(os.path.join(step_dir, ShardStore.COMMIT))

    def write_local(self, step: int, units: list[tuple[list, Any, list | None]]) -> int:
        """Write this rank's shard file and manifest for ``step`` (atomic
        renames, no coordination): ``units`` are ``(tokens, value, index)``.
        Each value reaches the host just before its bytes are written.
        Returns the bytes of array data written."""
        d = self.step_dir(step)
        os.makedirs(d, exist_ok=True)
        shard_path = os.path.join(d, f"shard_p{self.rank}.npz")
        entries, nbytes = [], 0
        tmp = shard_path + ".tmp"
        # np.savez's layout (stored, zip64 members named <key>.npy), one
        # array at a time.
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
            for i, (tokens, value, index) in enumerate(units):
                arr = _host(value)
                key = f"a{i}"
                with zf.open(f"{key}.npy", "w", force_zip64=True) as fid:
                    np.lib.format.write_array(fid, arr.reshape(-1).view(np.uint8),
                                              allow_pickle=False)
                entries.append({"key": key, "path": _keystr(tokens), "tokens": tokens,
                                "shape": list(arr.shape), "dtype": str(arr.dtype),
                                "index": None if index is None else
                                [[int(lo), int(hi)] for lo, hi in index]})
                nbytes += arr.nbytes
        os.replace(tmp, shard_path)
        man = {"format": FORMAT, "process": self.rank, "process_count": self.world_size,
               "entries": entries}
        man_path = os.path.join(d, f"manifest_p{self.rank}.json")
        with open(man_path + ".tmp", "w") as fh:
            json.dump(man, fh)
        os.replace(man_path + ".tmp", man_path)
        return nbytes

    def write_tree(self, step: int, tree: Any) -> int:
        """:meth:`write_local` of what this rank owns in ``tree``: every
        :class:`Shard` it holds, and, on rank 0, every whole leaf."""
        units = []
        for tokens, leaf in _flatten(tree):
            if isinstance(leaf, Shard):
                units.append((tokens, leaf.value, leaf.index))
            elif self.rank == 0:
                units.append((tokens, leaf, None))
        return self.write_local(step, units)

    def commit(self, step: int) -> None:
        tmp = os.path.join(self.step_dir(step), self.COMMIT + ".tmp")
        with open(tmp, "w") as fh:
            json.dump({"step": step, "process_count": self.world_size}, fh)
        os.replace(tmp, os.path.join(self.step_dir(step), self.COMMIT))

    def committed_steps(self) -> list[int]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names
                      if n.isdigit() and self.is_committed(os.path.join(self.directory, n)))

    def retain(self, max_to_keep: int) -> None:
        """Keep the newest ``max_to_keep`` committed steps (the chief's job)."""
        if max_to_keep is None or max_to_keep <= 0:
            return
        for step in self.committed_steps()[:-max_to_keep]:
            shutil.rmtree(self.step_dir(step), ignore_errors=True)

    def abandon(self, step: int) -> None:
        d = self.step_dir(step)
        if os.path.isdir(d) and not self.is_committed(d):
            shutil.rmtree(d, ignore_errors=True)

    def read(self, step: int) -> Any:
        """The committed step's whole tree (plain dicts and lists, numpy
        leaves; blocks reassembled)."""
        d = self.step_dir(step)
        with open(os.path.join(d, self.COMMIT)) as fh:
            nproc = int(json.load(fh)["process_count"])
        by_path: dict[str, list] = {}
        for p in range(nproc):
            with open(os.path.join(d, f"manifest_p{p}.json")) as fh:
                for e in json.load(fh)["entries"]:
                    by_path.setdefault(e["path"], []).append((p, e))
        npz_cache: dict[int, Any] = {}

        def load(p: int, entry: dict) -> np.ndarray:
            if p not in npz_cache:
                npz_cache[p] = np.load(os.path.join(d, f"shard_p{p}.npz"))
            raw = npz_cache[p][entry["key"]]
            return raw.view(np.dtype(entry["dtype"])).reshape(entry["shape"])

        try:
            return _assemble_raw(by_path, load)
        finally:
            for npz in npz_cache.values():
                npz.close()


def list_committed_steps(directory: str) -> list[int]:
    """Committed steps under ``directory``, ascending: a step counts once
    its ``COMMIT.json`` exists, so a torn or uncommitted step is invisible."""
    return ShardStore(directory).committed_steps()


def read_step(directory: str, step: int, template: Any | None = None) -> Any:
    """Read one committed step: with ``template=None`` the whole tree as
    plain dicts and lists with numpy leaves (blocks stitched back to whole
    arrays); with a template, its leaves in the template's structure.
    Raises ``OSError`` for a step that is not committed, a committed step
    whose files are missing or torn, and a leaf the template names that the
    step lacks or holds at another shape."""
    store = ShardStore(directory)
    if not store.is_committed(store.step_dir(step)):
        raise OSError(f"checkpoint step {step} in {directory} is not committed "
                      f"(no {ShardStore.COMMIT})")
    try:
        tree = store.read(step)
    except (OSError, ValueError, KeyError, json.JSONDecodeError, zipfile.BadZipFile) as e:
        raise OSError(f"checkpoint step {step} in {directory} is committed but unreadable: "
                      f"{type(e).__name__}: {e}") from e
    return tree if template is None else _match_template(step, tree, template)


def write_committed_step(directory: str, step: int, tree: Any) -> str:
    """Publish ``tree`` (nested dicts/lists of tensors or arrays) as one
    committed step from this process: shard, manifest, then the commit
    marker, each by atomic rename. Returns the step's directory."""
    store = ShardStore(directory)
    store.write_tree(step, tree)
    faults.maybe_fail("ckpt_publish", f"step {step}")
    store.commit(step)
    return store.step_dir(step)


# ---------------------------------------------------------------------------
# The manager.
# ---------------------------------------------------------------------------


def _collective_device() -> torch.device:
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


class CheckpointManager:
    """Timed autosave (``save_interval_secs``), keep-N retention and
    restore of the newest readable step, over the process group when one
    with more than one rank is initialised (every rank writes what it
    owns; the chief commits). Saves are synchronous; ``stall_seconds``
    sums the time the caller spent in them, and ``last_save_seconds``,
    ``last_save_bytes`` (this rank's) and ``last_restore_seconds`` time
    the last of each."""

    def __init__(self, directory: str, save_interval_secs: float = 600.0,
                 max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_interval_secs = save_interval_secs
        self.max_to_keep = max_to_keep
        multi = dist.is_initialized() and dist.get_world_size() > 1
        self.rank = dist.get_rank() if multi else 0
        self.world_size = dist.get_world_size() if multi else 1
        self._store = ShardStore(self.directory, self.rank, self.world_size)
        self._last_save = time.time()
        self.stall_seconds = 0.0
        self.last_save_seconds = self.last_restore_seconds = 0.0
        self.last_save_bytes = 0

    # -- gate ----------------------------------------------------------------

    def should_save(self, force: bool = False) -> bool:
        """The timed gate, side-effect free."""
        return force or time.time() - self._last_save >= self.save_interval_secs

    def mark_saved(self) -> None:
        self._last_save = time.time()

    def maybe_save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save if ``save_interval_secs`` have passed since the last save,
        or if forced."""
        if not self.should_save(force):
            return False
        self.save(step, state)
        self.mark_saved()
        return True

    # -- save ----------------------------------------------------------------

    def save(self, step: int, state: Any | Callable[[], Any]) -> bool:
        """Write and commit ``state`` (a tree, or a function that returns
        one) at ``step`` on every rank of the group. Leaves are the chief's
        to write; a :class:`Shard` is written by the rank that holds it.
        A step already committed is left as it is. Raises when a rank's
        write failed (the step is abandoned everywhere)."""
        t0 = time.perf_counter()
        try:
            if step in self.all_steps():
                return True
            tree = state() if callable(state) else state
            error = None
            try:
                self.last_save_bytes = retry_call(
                    lambda: self._store.write_tree(step, tree), attempts=_IO_ATTEMPTS,
                    base_delay=_IO_BASE_DELAY, max_delay=_IO_MAX_DELAY,
                    description=f"checkpoint save step {step}")
                faults.maybe_fail("ckpt_publish", f"step {step}")
            except Exception as e:  # noqa: BLE001 — every rank must reach the gather
                error = e
            failed = self._gather_failures(error is not None)
            if failed:
                if self.rank == 0:
                    self._store.abandon(step)
                raise OSError(f"checkpoint step {step} abandoned: rank(s) {failed} failed to "
                              f"write it") from error
            if self.rank == 0:
                self._store.commit(step)
                self._store.retain(self.max_to_keep)
            if self.world_size > 1:
                dist.barrier()  # the commit is visible before any rank goes on
            return True
        finally:
            self.last_save_seconds = time.perf_counter() - t0
            self.stall_seconds += self.last_save_seconds

    def _gather_failures(self, failed: bool) -> list[int]:
        """The ranks whose write failed (an all-gather over the group)."""
        if self.world_size == 1:
            return [0] if failed else []
        mine = torch.tensor([int(failed)], device=_collective_device())
        parts = [torch.empty_like(mine) for _ in range(self.world_size)]
        dist.all_gather(parts, mine)
        return [r for r, t in enumerate(parts) if int(t.item())]

    # -- introspection -------------------------------------------------------

    def all_steps(self) -> list[int]:
        return self._store.committed_steps()

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- restore -------------------------------------------------------------

    def restore_latest(self):
        """``(step, tree)`` of the newest readable committed step, its tree
        whole (:func:`read_step`), or None. A step that cannot be read (torn
        files, a bad disk) is skipped with a warning and the next older one
        tried, as the JAX package does; with none readable, None."""
        t0 = time.perf_counter()
        skipped: list[int] = []
        try:
            for step in sorted(self.all_steps(), reverse=True):
                def _read(step=step):
                    faults.maybe_fail("ckpt_restore", f"step {step}")
                    return read_step(self.directory, step)

                try:
                    tree = retry_call(_read, attempts=2, base_delay=_IO_BASE_DELAY,
                                      max_delay=_IO_MAX_DELAY,
                                      description=f"checkpoint restore step {step}")
                except Exception as e:  # noqa: BLE001 — the walk-back, as in the JAX package
                    log.warning("checkpoint step %d unreadable (%s: %s) — walking back", step,
                                type(e).__name__, e)
                    skipped.append(step)
                    continue
                if skipped:
                    log.warning("restored step %d after skipping corrupt/partial checkpoint "
                                "step(s) %s", step, skipped)
                return step, tree
            if skipped:
                log.error("no readable checkpoint (skipped %s) — starting fresh", skipped)
            return None
        finally:
            self.last_restore_seconds = time.perf_counter() - t0


def coordinated_maybe_save(mngr: CheckpointManager, step: int, state: Any, is_chief: bool,
                           force: bool = False, at_boundary: bool = True) -> bool:
    """The trainer's save gate. In a world of one the chief saves when the
    timer has run out (or ``force``). Over a group the chief's decision is
    broadcast at eval boundaries (and forced saves), so every rank enters
    the save together; each writes what it owns and the chief commits once
    all have succeeded."""
    if mngr.world_size == 1:
        return mngr.maybe_save(step, state, force=force) if is_chief else False
    if not (at_boundary or force):
        return False
    want = torch.tensor([int(mngr.should_save(force))], device=_collective_device())
    dist.broadcast(want, src=0)
    if not int(want.item()):
        return False
    mngr.save(step, state)
    mngr.mark_saved()
    return True


# ---------------------------------------------------------------------------
# The trainer's state.
# ---------------------------------------------------------------------------


def _state_keys(optimizer: torch.optim.Optimizer) -> tuple[str, ...]:
    if "betas" in optimizer.defaults:  # Adam, AdamW
        return ("exp_avg", "exp_avg_sq", "step")
    return ("momentum_buffer",) if optimizer.defaults.get("momentum") else ()


def _specs(model: torch.nn.Module, mesh) -> dict[str, int | None]:
    """The dims a model rank slices, by parameter name: tensor-parallel
    blocks' split over more than one model rank (tp, 3d, sp_tp), else none
    (dp, pp, sp, or a model group of one: whole parameters)."""
    from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
        TpBlock,
        tp_param_specs,
    )

    if mesh is None or mesh.model_size == 1:
        return {}
    if not any(isinstance(m, TpBlock) for m in model.modules()):
        return {}
    return tp_param_specs(model.state_dict())


def _stage(model: torch.nn.Module):
    """(stage, stages, layers a stage) of a pipeline stage's model, else None."""
    from distributed_tensorflow_tpu_torch.parallel.pipeline_parallel import PipelineLM

    if not isinstance(model, PipelineLM):
        return None
    return model.mesh.pipe_rank, model.mesh.pipe_size, len(model.blocks)


def _model_coords(mesh):
    return (0, 0, 0, 1) if mesh is None else (
        mesh.data_rank, mesh.pipe_rank, mesh.model_rank, mesh.model_size)


def _owned(t: torch.Tensor, dim: int | None, mesh, transposed: bool = False):
    """``t`` whole, or this rank's block of it as a :class:`Shard` (None
    when a rank of another data row, or another seq shard under ``sp_tp``,
    writes that block)."""
    if dim is None:
        return t.t() if transposed else t
    data_rank, pipe_rank, model_rank, _ = _model_coords(mesh)
    if data_rank != 0 or pipe_rank != 0:
        return None
    n = t.shape[dim]
    index = [[0, s] for s in t.shape]
    index[dim] = [model_rank * n, (model_rank + 1) * n]
    if transposed:
        return Shard(t.t(), index[::-1])
    return Shard(t, index)


def _stacked(layers: list, dim: int | None, stage, mesh, transposed: bool = False):
    """A pipeline stage's layers of one leaf as its block of the stacked leaf
    (S, L/S, ...): a :class:`Shard` at ``[stage, stage + 1)`` on the stage
    dim, the model rank's slice on ``dim`` (torch's orientation, of one
    layer), written by the first data row's ranks, a whole-width leaf by
    its model rank 0; else None. The stack is built when it is written."""
    data_rank, _, model_rank, _ = _model_coords(mesh)
    if data_rank != 0 or (dim is None and model_rank != 0):
        return None
    s, _, per = stage
    one = layers[0].t() if transposed else layers[0]
    index = [[s, s + 1], [0, per]] + [[0, n] for n in one.shape]
    if dim is not None:
        at = 2 + (one.dim() - 1 - dim if transposed else dim)
        n = index[at][1]
        index[at] = [model_rank * n, (model_rank + 1) * n]
    value = lambda: torch.stack([t.t() if transposed else t for t in layers])[None]  # noqa: E731
    return Shard(value, index)


def _layer_name(name: str):
    """(layer, rest) of a stage's ``blocks.<i>.<rest>`` name, else None."""
    head, _, rest = name.partition(".")
    if head != "blocks":
        return None
    i, _, rest = rest.partition(".")
    return int(i), rest


def train_state(model: torch.nn.Module, opt, global_step: int, mesh=None) -> dict:
    """The state tree this rank writes (module docstring): the model's
    parameters under flax paths, ``opt`` (a ``train.optimizers.Optimizer``)
    by parameter name, the schedule's count and ``global_step``. ``mesh``
    (``parallel.mesh.Mesh``) places the rank: tensor-parallel slices are
    written by the first data row (and the first seq shard), and a
    pipeline stage's layers (``PipelineLM``, ``ThreeDLM``) go into the
    stage-stacked ``stages`` leaves, each stage's block written by the rank
    that holds it."""
    from distributed_tensorflow_tpu_torch.models.convert import flax_param_paths

    specs, stage = _specs(model, mesh), _stage(model)
    named = dict(model.named_parameters())
    params: dict = {}
    layers: dict = {}  # stacked leaf -> (parameter names in layer order, transposed)
    for name, (path, transposed) in flax_param_paths(model).items():
        if stage is not None and _layer_name(name) is not None:
            names, _ = layers.setdefault(("stages", *path[2:]), ([], transposed))
            names.append(name)
            continue
        _set_path(params, path, _owned(named[name], specs.get(name), mesh, transposed))
    for path, (names, transposed) in layers.items():
        _set_path(params, path, _stacked([named[n] for n in names], specs.get(names[0]), stage,
                                         mesh, transposed))
    name_of = {id(p): n for n, p in named.items()}
    moments: dict = {}
    stacked: dict = {}  # "stages.<rest>" -> {key: (values in layer order, dim)}
    for p, st in opt.optimizer.state.items():
        name = name_of[id(p)]
        layer = None if stage is None else _layer_name(name)
        for key, v in st.items():
            if v is None:
                continue
            sliced = torch.is_tensor(v) and v.dim() > 0
            if layer is not None:
                entry = stacked.setdefault(f"stages.{layer[1]}", {}).setdefault(key, {})
                entry[layer[0]] = (v, specs.get(name) if sliced else None)
            else:
                moments.setdefault(name, {})[key] = (
                    _owned(v, specs.get(name), mesh) if sliced else v)
    for name, keys in stacked.items():
        for key, by_layer in keys.items():
            values = [by_layer[i][0] for i in sorted(by_layer)]
            moments.setdefault(name, {})[key] = _stacked(
                [torch.as_tensor(v) for v in values], by_layer[0][1], stage, mesh)
    return {
        "params": params,
        "opt_state": {"state": moments,
                      "schedule_count": np.int64(opt.scheduler.last_epoch)},
        "global_step": np.int32(global_step),
    }


def _unstack_saved(step: int, tree: dict) -> dict:
    """A saved tree with its ``stages`` leaves (params) and ``stages.<rest>``
    entries (optimizer state) split into per-layer ``block_<g>`` ones, the
    plain model's layout: one restore path for every split."""
    params = tree.get("params", {})
    if isinstance(params, dict) and "stages" in params:
        params = unstack_stage_params(params)
    state = dict(tree.get("opt_state", {}).get("state", {}))
    for name in [n for n in state if n.startswith("stages.")]:
        rest = name[len("stages."):]
        for key, arr in state.pop(name).items():
            arr = np.asarray(arr)
            if arr.ndim < 2:
                raise OSError(f"checkpoint step {step}: stacked optimizer state {name}/{key} "
                              f"has shape {arr.shape}")
            flat = arr.reshape(arr.shape[0] * arr.shape[1], *arr.shape[2:])
            for g in range(flat.shape[0]):
                state.setdefault(f"block_{g}.{rest}", {})[key] = flat[g]
    opt_state = dict(tree.get("opt_state", {}), state=state)
    return dict(tree, params=params, opt_state=opt_state)


def restore_train_state(step: int, tree: dict, model: torch.nn.Module, opt,
                        mesh=None) -> int:
    """Load a step's whole tree (:meth:`CheckpointManager.restore_latest`)
    into ``model`` and ``opt``, split for this rank when ``mesh`` slices
    them; returns the global step. A pipeline stage (``PipelineLM``,
    ``ThreeDLM``) takes its own layers of the whole model, so a run may
    resume at another stage count or model split (and a pipeline's step
    restores into the plain model, and back). Raises ``OSError`` naming a
    leaf the model or optimizer needs that the step lacks or holds at
    another shape: a directory of another model never trains on
    silently."""
    from distributed_tensorflow_tpu_torch.models.convert import flax_param_paths

    specs, stage = _specs(model, mesh), _stage(model)
    named = dict(model.named_parameters())
    optimizer, keys = opt.optimizer, _state_keys(opt.optimizer)
    tree = _unstack_saved(step, tree)

    def whole_name(name):
        """The plain model's name of this model's parameter ``name``."""
        layer = None if stage is None else _layer_name(name)
        if layer is None:
            return name
        return f"block_{stage[0] * stage[2] + layer[0]}.{layer[1]}"

    def whole(name):
        shape = list(named[name].shape)
        if specs.get(name) is not None:
            shape[specs[name]] *= mesh.model_size
        return shape

    def local(name, arr, transposed=False):
        """This rank's block of a saved leaf on its parameter's device,
        in torch's orientation (transposed there, not on the host)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        dim = specs.get(name)
        if dim is not None:
            at = t.dim() - 1 - dim if transposed else dim  # the saved orientation's dim
            n = t.shape[at] // mesh.model_size
            t = t.narrow(at, mesh.model_rank * n, n)
        t = t.to(named[name].device)
        return (t.t() if transposed else t).contiguous()

    paths = {name: ((whole_name(name).split(".")[0], *path[2:]) if whole_name(name) != name
                    else path, transposed)
             for name, (path, transposed) in flax_param_paths(model).items()}
    template: dict = {"params": {}, "opt_state": {"state": {}, "schedule_count": _Spec(())},
                      "global_step": _Spec(())}
    for name, (path, transposed) in paths.items():
        _set_path(template["params"], path, _Spec(whole(name)[::-1] if transposed else whole(name)))
        if keys:
            template["opt_state"]["state"][whole_name(name)] = {
                k: _Spec(() if k == "step" else whole(name)) for k in keys}
    got = _match_template(step, tree, template)

    with torch.no_grad():  # leaf by leaf: one leaf's copy at a time on the card
        for name, (path, transposed) in paths.items():
            node = got["params"]
            for k in path:
                node = node[k]
            named[name].copy_(local(name, node, transposed))

    name_of = {id(p): n for n, p in named.items()}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    state = {}
    for i, p in enumerate(params):
        saved = got["opt_state"]["state"].get(whole_name(name_of[id(p)]))
        if saved:
            state[i] = {k: torch.from_numpy(np.array(v)) if k == "step"
                        else local(name_of[id(p)], v) for k, v in saved.items()}
    optimizer.load_state_dict({"state": state,
                               "param_groups": optimizer.state_dict()["param_groups"]})
    count = int(got["opt_state"]["schedule_count"])
    sched = opt.scheduler
    lrs = [base * lam(count) for base, lam in zip(sched.base_lrs, sched.lr_lambdas)]
    for group, lr in zip(optimizer.param_groups, lrs):
        group["lr"] = lr
    sched.last_epoch, sched._last_lr = count, lrs
    return int(got["global_step"])


# ---------------------------------------------------------------------------
# Inference bundles.
# ---------------------------------------------------------------------------


def export_inference_bundle(path: str, params: Any, metadata: dict | None = None) -> int:
    """Write ``params`` (a tree of numpy arrays, e.g.
    ``models/convert.py::transformer_params_to_jax(model)``) as a bundle
    with ``metadata`` in its header. Returns the bundle's bytes."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    header = json.dumps({"format": BUNDLE_FORMAT, **(metadata or {})}).encode()
    with open(path, "wb") as fh:
        fh.write(len(header).to_bytes(8, "little"))
        fh.write(header)
        return 8 + len(header) + msgpack_state.dump(params, fh)


def load_inference_bundle(path: str):
    """``(params state dict, metadata)`` of a bundle; the arrays are views
    of one buffer read from the file."""
    with open(path, "rb") as fh:
        hlen = int.from_bytes(fh.read(8), "little")
        metadata = json.loads(fh.read(hlen).decode())
        blob = bytearray(os.fstat(fh.fileno()).st_size - 8 - hlen)
        if fh.readinto(blob) != len(blob):
            raise OSError(f"truncated bundle {path}")
    return msgpack_state.loads(blob), metadata


def lm_config_from_meta(meta: dict, fallback_shapes: dict | None = None,
                        dtype: torch.dtype = torch.float32):
    """The ``TransformerConfig`` a bundle's metadata describes (its
    ``config``, else ``fallback_shapes``), computing in ``dtype``: shapes,
    GQA, window, rope, and the quantization and KV formats."""
    from distributed_tensorflow_tpu_torch.models.transformer import TransformerConfig

    fb = fallback_shapes or {}
    shape_meta = meta.get("config") or {}

    def dim(name, default):
        return int(shape_meta.get(name, fb.get(name, default)))

    return TransformerConfig(
        vocab_size=dim("vocab_size", 256),
        d_model=dim("d_model", 128),
        num_heads=dim("num_heads", 4),
        num_kv_heads=dim("num_kv_heads", 0) or None,  # 0/absent: multi-head
        attention_window=dim("attention_window", 0) or None,
        use_bias=bool(dim("use_bias", 1)),  # absent: biased, as bundles before the key
        position="rope" if dim("rope", 0) else "learned",
        rope_theta=float(shape_meta.get("rope_theta", fb.get("rope_theta", 10000.0))),
        num_layers=dim("num_layers", 4),
        d_ff=dim("d_ff", 512),
        max_seq_len=dim("max_seq_len", 128),
        weight_dtype=shape_meta.get("weight_dtype") or fb.get("weight_dtype") or None,
        quant_group_size=dim("quant_group_size", 0),
        kv_cache_dtype=shape_meta.get("kv_cache_dtype") or fb.get("kv_cache_dtype") or None,
        compute_dtype=dtype,
    )


def load_lm_bundle(path: str, fallback_shapes: dict | None = None,
                   device: torch.device | str = "cuda"):
    """Restore a TransformerLM bundle: ``(cfg, model, metadata)``, the model
    on ``device`` (the card unless the CPU is asked for) computing in its
    dtype (``utils/device.py::compute_dtype``) with dense attention, as the
    JAX package's loader builds it. The config comes from the bundle's
    metadata, else ``fallback_shapes`` (CLI flags); pp bundles are
    unstacked. A quantized bundle (``cli/quantize_lm.py`` or the JAX
    package's ``tools/quantize_lm.py``) gives a model of ``QuantDense``
    layers holding its leaves as stored, and its ``kv_cache_dtype`` the
    config's KV format. Raises ValueError for tp/ep/3d/sp_tp bundles
    (another parameter factorization)."""
    from distributed_tensorflow_tpu_torch.models.convert import (
        model_from_tree,
        transformer_params_from_jax,
    )
    from distributed_tensorflow_tpu_torch.models.transformer import TransformerLM
    from distributed_tensorflow_tpu_torch.utils.device import compute_dtype, resolve_device

    device = resolve_device(device)
    state, meta = load_inference_bundle(path)
    if meta.get("parallelism") in ("tp", "ep", "3d", "sp_tp"):
        raise ValueError(
            f"{meta['parallelism']} bundles use a different param "
            "factorization (separate q/k/v for tp/3d/sp_tp, expert-stacked "
            "MoE MLPs for ep) that the plain decoder cannot load — retrain "
            "with dp/fsdp/sp/pp"
        )
    if "stages" in state:
        state = unstack_stage_params(state)
    cfg = lm_config_from_meta(meta, fallback_shapes, compute_dtype(device))
    if cfg.weight_dtype:
        return cfg, model_from_tree(cfg, state, device), meta
    model = TransformerLM(cfg, device=device)
    model.load_state_dict(transformer_params_from_jax(state))
    return cfg, model, meta
