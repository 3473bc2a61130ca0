"""Weight bridge between the JAX package's flax parameter trees and this
package's state dicts: ``TransformerLM`` and (whole, unsplit)
``TpTransformerLM``.

The flax tree arrives as nested dicts of numpy arrays (``jax.device_get``
of the params) and leaves as the same; nothing here imports JAX. Mapping:
``Dense.kernel (in, out)`` ↔ ``Linear.weight (out, in)``, ``Dense.bias`` ↔
``bias``, ``LayerNorm.scale/bias`` ↔ ``weight/bias``, ``Embed.embedding`` ↔
``Embedding.weight`` unchanged; a parameter a module declares itself (the
tensor-parallel block's ``proj_bias`` and ``mlp_out_bias``) keeps its name.
The fused qkv projection keeps its ``[q | k | v]`` column order on both
sides.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_FLAX_TO_TORCH_LEAF = {
    "kernel": "weight",
    "bias": "bias",
    "scale": "weight",
    "embedding": "weight",
}


def _flatten(tree: dict, prefix: tuple = ()):
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _flatten(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def transformer_params_from_jax(params_np: dict) -> dict[str, torch.Tensor]:
    """flax param tree (nested numpy dicts) → a state dict for the model;
    load it with ``model.load_state_dict(sd)``, whose strict key check
    reports a tree that does not match the model."""
    sd = {}
    for path, leaf in _flatten(params_np):
        *mods, leaf_name = path
        arr = np.asarray(leaf, dtype=np.float32)
        if leaf_name == "kernel":
            arr = arr.T
        sd[".".join(mods + [_FLAX_TO_TORCH_LEAF.get(leaf_name, leaf_name)])] = torch.tensor(arr)
    return sd


def _flax_leaf(mod: nn.Module, leaf: str) -> str:
    if isinstance(mod, nn.LayerNorm):
        return "scale" if leaf == "weight" else "bias"
    if isinstance(mod, nn.Embedding):
        return "embedding"
    if isinstance(mod, nn.Linear):
        return "kernel" if leaf == "weight" else "bias"
    return leaf


def transformer_params_to_jax(module: nn.Module, grads: bool = False) -> dict:
    """The model → flax param tree (nested numpy dicts). With ``grads`` the
    leaves are the parameters' ``.grad`` instead — the tree ``jax.grad``
    returns, for comparing gradients."""
    tree: dict = {}
    for mod_name, mod in module.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            t = p.grad if grads else p
            arr = t.detach().float().cpu().numpy()
            flax_leaf = _flax_leaf(mod, leaf)
            if flax_leaf == "kernel":
                arr = arr.T
            node = tree
            for m in mod_name.split(".") if mod_name else ():
                node = node.setdefault(m, {})
            node[flax_leaf] = np.ascontiguousarray(arr)
    return tree


# The TpTransformerLM tree (JAX init_tp_params: whole shapes, separate
# q/k/v, block-level proj_bias/mlp_out_bias) goes through the same bridge;
# split the result with parallel/tensor_parallel.shard_params.
tp_params_from_jax = transformer_params_from_jax
tp_params_to_jax = transformer_params_to_jax
