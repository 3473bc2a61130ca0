"""Weight bridge between the JAX package's flax ``TransformerLM`` parameter
tree and this package's ``TransformerLM`` state dict.

The flax tree arrives as nested dicts of numpy arrays (``jax.device_get``
of the params) and leaves as the same; nothing here imports JAX. Mapping:
``Dense.kernel (in, out)`` ↔ ``Linear.weight (out, in)``, ``Dense.bias`` ↔
``bias``, ``LayerNorm.scale/bias`` ↔ ``weight/bias``, ``Embed.embedding`` ↔
``Embedding.weight`` unchanged. The fused qkv projection keeps its
``[q | k | v]`` column order on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

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
    """flax param tree (nested numpy dicts) → a state dict for
    ``TransformerLM``; load it with ``model.load_state_dict(sd)``, whose
    strict key check reports a tree that does not match the model."""
    sd = {}
    for path, leaf in _flatten(params_np):
        *mods, leaf_name = path
        arr = np.asarray(leaf, dtype=np.float32)
        if leaf_name == "kernel":
            arr = arr.T
        sd[".".join(mods + [_FLAX_TO_TORCH_LEAF[leaf_name]])] = torch.tensor(arr)
    return sd


def transformer_params_to_jax(module: torch.nn.Module, grads: bool = False) -> dict:
    """``TransformerLM`` → flax param tree (nested numpy dicts). With
    ``grads`` the leaves are the parameters' ``.grad`` instead — the tree
    ``jax.grad`` returns, for comparing gradients."""
    tree: dict = {}
    for name, p in module.named_parameters():
        *mods, leaf = name.split(".")
        t = p.grad if grads else p
        arr = t.detach().float().cpu().numpy()
        if mods[-1].startswith("ln"):
            flax_leaf = "scale" if leaf == "weight" else "bias"
        elif mods[-1].endswith("embed"):
            flax_leaf = "embedding"
        else:
            flax_leaf = "kernel" if leaf == "weight" else "bias"
            if flax_leaf == "kernel":
                arr = arr.T
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[flax_leaf] = np.ascontiguousarray(arr)
    return tree
