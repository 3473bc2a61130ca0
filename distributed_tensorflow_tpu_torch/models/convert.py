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
        t = torch.tensor(np.asarray(leaf, dtype=np.float32))
        if leaf_name == "kernel":
            t = t.t().contiguous()  # torch's transposing copy: numpy's is single-threaded
        sd[".".join(mods + [_FLAX_TO_TORCH_LEAF.get(leaf_name, leaf_name)])] = t
    return sd


def _flax_leaf(mod: nn.Module, leaf: str) -> str:
    if isinstance(mod, nn.LayerNorm):
        return "scale" if leaf == "weight" else "bias"
    if isinstance(mod, nn.Embedding):
        return "embedding"
    if isinstance(mod, nn.Linear):
        return "kernel" if leaf == "weight" else "bias"
    return leaf


def flax_param_paths(module: nn.Module) -> dict[str, tuple[tuple[str, ...], bool]]:
    """``{state-dict name: (flax tree path, transposed)}`` for every
    parameter of the model, in ``named_parameters`` order; ``transposed``
    marks a Dense kernel, stored (in, out) in the flax tree."""
    out = {}
    for mod_name, mod in module.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            flax_leaf = _flax_leaf(mod, leaf)
            path = (*(mod_name.split(".") if mod_name else ()), flax_leaf)
            out[f"{mod_name}.{leaf}" if mod_name else leaf] = (path, flax_leaf == "kernel")
    return out


def transformer_params_to_jax(module: nn.Module, grads: bool = False) -> dict:
    """The model → flax param tree (nested numpy dicts). With ``grads`` the
    leaves are the parameters' ``.grad`` instead — the tree ``jax.grad``
    returns, for comparing gradients."""
    tree: dict = {}
    params = dict(module.named_parameters())
    for name, (path, transposed) in flax_param_paths(module).items():
        t = (params[name].grad if grads else params[name]).detach().float()
        if transposed:
            t = t.t()  # transposed where the tensor lives (on the card, before the copy)
        node = tree
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = t.contiguous().cpu().numpy()
    return tree


# The TpTransformerLM tree (JAX init_tp_params: whole shapes, separate
# q/k/v, block-level proj_bias/mlp_out_bias) goes through the same bridge;
# split the result with parallel/tensor_parallel.shard_params.
tp_params_from_jax = transformer_params_from_jax
tp_params_to_jax = transformer_params_to_jax
