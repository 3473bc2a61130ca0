"""Cross-process consistency of replicated parameters.

Counterpart of ``distributed_tensorflow_tpu/parallel/consistency.py``'s
``param_fingerprint``, ``check_cross_process_consistency`` and
``tree_bytes``. After a data-parallel run every rank must hold bitwise-equal
parameters; the check all-gathers a digest of each rank's weights and raises
on a mismatch.

The fingerprint hashes the JAX-named parameter tree that
``models/convert.py::transformer_params_to_jax`` gives (f32 numpy leaves,
flax kernels transposed back to (in, out)), walked as JAX walks a dict tree —
keys in sorted order, each leaf's path written as ``jax.tree_util.keystr``
writes it (``['block_0']['attn']['kernel']``) — then its dtype and shape,
then its bytes. So the same weights give the same fingerprint in both
packages. (The JAX module's ``hlo_collective_bytes`` parses XLA's HLO text
and has no eager counterpart.)
"""

from __future__ import annotations

import hashlib
from typing import Any, Iterator

import numpy as np
import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.models.convert import transformer_params_to_jax


def _tree(params: Any) -> dict:
    """A module's JAX-named tree; a tree (nested dicts) passes through."""
    return transformer_params_to_jax(params) if isinstance(params, torch.nn.Module) else params


def _leaves(tree: dict, path: str = "") -> Iterator[tuple[str, np.ndarray]]:
    for key in sorted(tree):
        sub, at = tree[key], f"{path}[{key!r}]"
        if isinstance(sub, dict):
            yield from _leaves(sub, at)
        else:
            yield at, np.asarray(sub)


def tree_bytes(params: Any) -> int:
    """Bytes of every leaf of the tree (or of a module's JAX-named tree)."""
    return sum(arr.size * arr.dtype.itemsize for _, arr in _leaves(_tree(params)))


def param_fingerprint(params: Any) -> str:
    """sha256 hex digest over each leaf's path, dtype and shape, and exact
    bytes, of a module (through its JAX-named tree) or of a tree."""
    h = hashlib.sha256()
    for path, arr in _leaves(_tree(params)):
        h.update(path.encode())
        h.update(str(arr.dtype).encode() + str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def check_cross_process_consistency(model: torch.nn.Module, group=None) -> bool:
    """Whether every rank of ``group`` (default: the whole world) holds
    bitwise-equal parameters: the first 8 bytes of each rank's
    :func:`param_fingerprint`, all-gathered on the model's device. Raises on
    a mismatch; a world of one (or no process group) is trivially
    consistent."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return True
    digest = np.frombuffer(bytes.fromhex(param_fingerprint(model)[:16]), dtype=np.uint32)
    device = next(model.parameters()).device
    mine = torch.tensor(digest.astype(np.int64), device=device)
    gathered = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(gathered, mine, group=group)
    values = torch.stack(gathered).cpu()
    if not bool((values == values[0]).all()):
        raise RuntimeError(
            f"parameter divergence across processes: digests {values.ravel().tolist()}"
        )
    return True
