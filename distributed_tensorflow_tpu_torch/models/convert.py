"""Weight bridge between the JAX package's flax parameter trees and this
package's state dicts: ``TransformerLM``, (whole, unsplit)
``TpTransformerLM``, and the pipeline stages (``PipelineLM``, ``ThreeDLM``)
against the JAX stage-stacked trees.

The flax tree arrives as nested dicts of numpy arrays (``jax.device_get``
of the params) and leaves as the same; nothing here imports JAX. Mapping:
``Dense.kernel (in, out)`` ↔ ``Linear.weight (out, in)``, ``Dense.bias`` ↔
``bias``, ``LayerNorm.scale/bias`` ↔ ``weight/bias``, ``Embed.embedding`` ↔
``Embedding.weight`` unchanged; a parameter a module declares itself (the
tensor-parallel block's ``proj_bias`` and ``mlp_out_bias``) keeps its name.
The fused qkv projection keeps its ``[q | k | v]`` column order on both
sides. A weight-quantized layer (``models/quant.py::QuantDense``) keeps the
flax leaves as they are (``kernel_q`` int8/uint8, ``scale``/``gscale`` f32,
in flax's layout), bit for bit both ways; a leaf the tree holds in bf16
(``utils/msgpack_state.Bfloat16Bits``) becomes a torch bf16 tensor and back.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_tpu_torch.parallel.pipeline_parallel import (
    stack_stage_params,
    stage_state_dict,
    unstack_stage_params,
)
from distributed_tensorflow_tpu_torch.models.quant import QuantDense
from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import shard_params
from distributed_tensorflow_tpu_torch.utils.msgpack_state import Bfloat16Bits

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


def _leaf_tensor(leaf) -> torch.Tensor:
    """A tree leaf as a torch tensor: bf16 bits → bf16, integer codes as they
    are, other floats → f32."""
    if isinstance(leaf, Bfloat16Bits):
        return torch.from_numpy(np.array(leaf.view(np.int16))).view(torch.bfloat16)
    arr = np.asarray(leaf)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.from_numpy(np.array(arr))
    return torch.tensor(np.asarray(arr, dtype=np.float32))


def transformer_params_from_jax(params_np: dict) -> dict[str, torch.Tensor]:
    """flax param tree (nested numpy dicts) → a state dict for the model;
    load it with ``model.load_state_dict(sd)``, whose strict key check
    reports a tree that does not match the model (or with
    :func:`load_flax_params`, which keeps a quantized tree's dtypes)."""
    sd = {}
    quant_mods = {path[:-1] for path, _ in _flatten(params_np) if path[-1] == "kernel_q"}
    for path, leaf in _flatten(params_np):
        *mods, leaf_name = path
        t = _leaf_tensor(leaf)
        if leaf_name == "kernel":
            t = t.t().contiguous()  # torch's transposing copy: numpy's is single-threaded
        if path[:-1] not in quant_mods:  # QuantDense leaves keep their flax names
            leaf_name = _FLAX_TO_TORCH_LEAF.get(leaf_name, leaf_name)
        sd[".".join(mods + [leaf_name])] = t
    return sd


def load_flax_params(model: nn.Module, params_np: dict) -> nn.Module:
    """Load a flax tree into ``model`` on the model's device, each parameter
    taking the tree's dtype (a quantized tree's int codes, f32 scales and
    bf16 high-precision leaves stay as stored). Strict on the keys."""
    dev = next(model.parameters()).device
    sd = {k: v.to(dev) for k, v in transformer_params_from_jax(params_np).items()}
    model.load_state_dict(sd, assign=True)
    return model


def model_from_tree(cfg, params_np: dict, device: torch.device | str = "cuda") -> nn.Module:
    """A ``TransformerLM`` of ``cfg`` on ``device`` holding a flax tree
    (quantized or not) in the tree's dtypes."""
    from distributed_tensorflow_tpu_torch.models.transformer import TransformerLM

    return load_flax_params(TransformerLM(cfg, device=device), params_np)


def _flax_leaf(mod: nn.Module, leaf: str) -> str:
    if isinstance(mod, nn.LayerNorm):
        return "scale" if leaf == "weight" else "bias"
    if isinstance(mod, nn.Embedding):
        return "embedding"
    if isinstance(mod, nn.Linear):
        return "kernel" if leaf == "weight" else "bias"
    return leaf  # QuantDense and a module's own parameters keep their names


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
        t = (params[name].grad if grads else params[name]).detach()
        if t.is_floating_point() and t.dtype != torch.bfloat16:
            t = t.float()
        if transposed:
            t = t.t()  # transposed where the tensor lives (on the card, before the copy)
        node = tree
        for m in path[:-1]:
            node = node.setdefault(m, {})
        if t.dtype == torch.bfloat16:
            leaf = t.contiguous().view(torch.int16).cpu().numpy().view(np.uint16).view(Bfloat16Bits)
        else:
            leaf = t.contiguous().cpu().numpy()
        node[path[-1]] = leaf
    return tree


# The TpTransformerLM tree (JAX init_tp_params: whole shapes, separate
# q/k/v, block-level proj_bias/mlp_out_bias) goes through the same bridge;
# split the result with parallel/tensor_parallel.shard_params.
tp_params_from_jax = transformer_params_from_jax
tp_params_to_jax = transformer_params_to_jax


def pp_params_from_jax(stacked: dict, stage: int) -> dict[str, torch.Tensor]:
    """A JAX ``stack_stage_params`` tree (nested numpy dicts; leaves of the
    layers (S, L/S, ...)) → stage ``stage``'s ``PipelineLM`` state dict."""
    num_stages = next(_flatten(stacked["stages"]))[1].shape[0]
    plain = unstack_stage_params(stacked)
    return stage_state_dict(transformer_params_from_jax(plain), stage, num_stages)


def pp_params_to_jax(stages: list[nn.Module]) -> dict:
    """Every stage's module (``PipelineLM``, or an unsplit ``ThreeDLM``), in
    stage order → the JAX stage-stacked tree (nested numpy dicts)."""
    trees = [transformer_params_to_jax(m) for m in stages]
    plain = {k: v for k, v in trees[0].items() if k != "blocks"}
    per = len(trees[0]["blocks"])
    for s, tree in enumerate(trees):
        for i, block in tree["blocks"].items():
            plain[f"block_{s * per + int(i)}"] = block
    return stack_stage_params(plain, len(stages))


def three_d_params_from_jax(stacked: dict, stage: int, mesh) -> dict[str, torch.Tensor]:
    """The JAX ``init_3d_params`` tree (stacked tp blocks, whole widths) →
    this rank's ``ThreeDLM`` state dict: stage ``stage``, sliced for
    ``mesh.model_rank``."""
    return shard_params(pp_params_from_jax(stacked, stage), mesh)


# Whole-width 3d stages go back through the same bridge (gather a stage split
# over a model group first: parallel/tensor_parallel.gather_params).
three_d_params_to_jax = pp_params_to_jax
