"""Weight-only quantization for the serving ``TransformerLM``.

Counterpart of ``distributed_tensorflow_tpu/models/quant.py``. Only the four
per-block matmul projections quantize (``qkv``/``proj``/``mlp_in``/
``mlp_out``); embeddings, LayerNorms, ``lm_head`` and biases stay high
precision.

* **int8, symmetric per output channel.** ``W ≈ Q · s`` with ``Q`` int8
  ``(in, out)`` and ``s`` f32 ``(out,)``. The scale factors out of the
  contraction exactly, so :class:`QuantDense` multiplies by ``Q`` cast to
  the compute dtype and scales the f32 result.
* **int4, group-wise along the input axis.** Groups of ``group_size`` input
  rows share one f32 scale (``gscale`` ``(in/group_size, out)``); two values
  pack per uint8 byte along the input axis, row ``2k`` in the low nibble,
  biased by +8 (no ``torch.int4``). A group scale does not factor out of the
  contraction, so the layer unpacks and dequantizes in f32, then casts.

The tree functions work on flax trees of numpy arrays with the JAX
package's leaf names (``kernel_q``, ``scale``, ``gscale``), so a quantized
tree is bit for bit the JAX package's and its bundles load in either
package. ``round(w / scale)`` rounds half to even in f32 in both. Leaves
kept in bf16 are ``utils/msgpack_state.Bfloat16Bits`` (numpy has no
bfloat16).

Plain torch has no weight-only GEMM: each call materializes a
compute-dtype copy of the quantized weight (no kernel of the port runs
here; a GEMM with the dequant in its operand load is future work).
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_tpu_torch.utils.msgpack_state import (
    Bfloat16Bits,
    bf16_bits,
    bf16_to_f32,
)

__all__ = [
    "QUANT_KERNEL_RE",
    "QuantDense",
    "dequantize_int4",
    "dequantize_int8",
    "dequantize_lm_params",
    "kv_cache_bytes_per_token",
    "pack_int4",
    "quantize_int4_groupwise",
    "quantize_int8_channelwise",
    "quantize_lm_params",
    "tree_bytes",
    "unpack_int4",
    "validate_weight_quant",
]

# The per-block matmul kernels that quantize; everything else stays high
# precision.
QUANT_KERNEL_RE = re.compile(r"(?:^|/)(?:qkv|proj|mlp_in|mlp_out)/kernel$")

_MODES = ("int8", "int4")


def validate_weight_quant(weight_dtype, group_size: int, d_model: int, d_ff: int,
                          tp: int = 1) -> None:
    """Config-time validation with the JAX package's messages."""
    if weight_dtype in ("", None):
        if group_size:
            raise ValueError(
                f"quant_group_size={group_size} set but weight_dtype is "
                "unset — group size only applies to int4 weight "
                "quantization. Set weight_dtype='int4' or drop the group "
                "size."
            )
        return
    if weight_dtype not in _MODES:
        raise ValueError(f"weight_dtype must be None, 'int8' or 'int4', got {weight_dtype!r}")
    if weight_dtype == "int8":
        if group_size:
            raise ValueError(
                f"quant_group_size={group_size} set with weight_dtype="
                "'int8' — int8 is strictly per-output-channel (the scale "
                "factors out of the contraction exactly, so grouping buys "
                "nothing). Set quant_group_size=0, or use weight_dtype="
                "'int4' for group-wise quantization."
            )
        return
    if group_size <= 0:
        raise ValueError(
            "weight_dtype='int4' requires quant_group_size > 0 (e.g. 32/"
            "64/128): 16 levels per-channel loses too much precision, so "
            "int4 is group-wise along the reduction axis by construction."
        )
    if group_size % 2:
        raise ValueError(
            f"quant_group_size={group_size} must be even: two int4 values "
            "pack per uint8 byte along the input axis, and a packed pair "
            "must not straddle a group boundary."
        )
    for dim_name, dim in (("d_model", d_model), ("d_ff", d_ff)):
        if dim % group_size:
            divisors = [g for g in range(2, dim + 1, 2) if dim % g == 0]
            raise ValueError(
                f"quant_group_size={group_size} does not divide "
                f"{dim_name}={dim} — int4 groups tile the matmul input "
                f"axes (d_model and d_ff) exactly. Pick a group size "
                f"dividing both, e.g. one of {divisors[:8]}."
            )
        if tp > 1 and dim % (group_size * tp):
            raise ValueError(
                f"int4 under tp={tp} needs {dim_name}={dim} divisible by "
                f"quant_group_size*tp={group_size * tp}: the row-parallel "
                f"kernels shard their input axis across 'model', and each "
                f"device's shard must hold whole scale groups. Shrink the "
                f"group size or the mesh."
            )


def pack_int4(q: np.ndarray) -> np.ndarray:
    """``(in, out)`` ints in [-8, 7] → ``(in/2, out)`` uint8: row ``2k`` in
    the low nibble, ``2k+1`` in the high one, each biased by +8."""
    if q.shape[0] % 2:
        raise ValueError(f"int4 pack needs an even input dim, got {q.shape}")
    s = (np.asarray(q) + 8).astype(np.uint8)
    return s[0::2] | (s[1::2] << 4)


def unpack_int4(packed):
    """Inverse of :func:`pack_int4`: ``(in/2, out)`` → ``(in, out)`` ints in
    [-8, 7] (int32 for numpy, uint8 codes less 8 as int16 for torch). A
    packed array that went through a float cast is cast back to uint8
    first: every code ≤ 255 is exact in bf16/f32."""
    if isinstance(packed, torch.Tensor):
        p = packed.to(torch.uint8)
        both = torch.stack([p & 0xF, p >> 4], dim=1).reshape(p.shape[0] * 2, p.shape[1])
        return both.to(torch.int16) - 8
    p = np.asarray(packed).astype(np.uint8)
    lo = (p & 0xF).astype(np.int32) - 8
    hi = (p >> 4).astype(np.int32) - 8
    return np.stack([lo, hi], axis=1).reshape(p.shape[0] * 2, p.shape[1])


def _f32(w) -> np.ndarray:
    return bf16_to_f32(w) if isinstance(w, Bfloat16Bits) else np.asarray(w, np.float32)


def quantize_int8_channelwise(w):
    """``(in, out)`` float kernel → ``(int8 (in, out), f32 scale (out,))``,
    symmetric absmax per output channel."""
    wf = _f32(w)
    amax = np.max(np.abs(wf), axis=0)
    scale = np.maximum(amax, np.float32(1e-8)) / np.float32(127.0)
    q = np.clip(np.round(wf / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_int4_groupwise(w, group_size: int):
    """``(in, out)`` float kernel → ``(packed uint8 (in/2, out), f32 gscale
    (in/group_size, out))``, symmetric absmax per (input group, output
    channel)."""
    in_f, out = w.shape
    if group_size <= 0 or in_f % group_size or group_size % 2:
        raise ValueError(
            f"group_size {group_size} must be positive, even, and divide "
            f"the input dim {in_f}"
        )
    wg = _f32(w).reshape(in_f // group_size, group_size, out)
    amax = np.max(np.abs(wg), axis=1)
    gscale = np.maximum(amax, np.float32(1e-8)) / np.float32(7.0)
    q = np.clip(np.round(wg / gscale[:, None, :]), -8, 7).astype(np.int32)
    return pack_int4(q.reshape(in_f, out)), gscale.astype(np.float32)


def dequantize_int8(q, scale) -> np.ndarray:
    return np.asarray(q).astype(np.float32) * np.asarray(scale, np.float32)[None, :]


def dequantize_int4(packed, gscale, group_size: int) -> np.ndarray:
    w = unpack_int4(packed)
    in_f, out = w.shape
    wg = w.reshape(in_f // group_size, group_size, out).astype(np.float32)
    return (wg * np.asarray(gscale, np.float32)[:, None, :]).reshape(in_f, out)


class QuantDense(nn.Module):
    """Weight-only-quantized drop-in for the four matmul ``Dense`` layers,
    with the flax leaves in their flax layout:

    * int8: ``kernel_q`` int8 ``(in, out)`` and ``scale`` f32 ``(out,)``;
    * int4: ``kernel_q`` uint8 ``(in/2, out)`` and ``gscale`` f32
      ``(in/group_size, out)``;
    * ``bias`` ``(out,)`` when ``bias``.

    The parameters start as zeros and unit scales: the layer exists to be
    loaded (``models/convert.py::load_flax_params``), not trained. A
    loaded leaf keeps its stored dtype (the bias may be bf16); the product
    runs in ``compute_dtype``, the bias is added in it."""

    def __init__(self, in_features, out_features, mode, group_size, bias, compute_dtype):
        super().__init__()
        if mode not in _MODES:
            raise ValueError(f"QuantDense mode must be int8/int4, got {mode!r}")
        self.in_features, self.out_features = in_features, out_features
        self.mode, self.group_size, self.compute_dtype = mode, group_size, compute_dtype
        frozen = lambda t: nn.Parameter(t, requires_grad=False)
        if mode == "int8":
            self.kernel_q = frozen(torch.zeros(in_features, out_features, dtype=torch.int8))
            self.scale = frozen(torch.ones(out_features))
        else:
            if group_size <= 0 or in_features % group_size:
                raise ValueError(f"int4 QuantDense needs group_size dividing the input "
                                 f"dim: {group_size} vs {in_features}")
            self.kernel_q = frozen(torch.zeros(in_features // 2, out_features, dtype=torch.uint8))
            self.gscale = frozen(torch.ones(in_features // group_size, out_features))
        self.bias = frozen(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        dt = self.compute_dtype
        if self.mode == "int8":
            y = torch.matmul(x.to(dt), self.kernel_q.to(dt))
            y = (y.float() * self.scale.float()).to(dt)
        else:
            gs, out = self.group_size, self.out_features
            w = unpack_int4(self.kernel_q).view(-1, gs, out).float() * self.gscale.float()[:, None]
            y = torch.matmul(x.to(dt), w.view(self.in_features, out).to(dt))
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def _flatten(tree: dict, prefix: tuple = ()):
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _flatten(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _is_float(leaf) -> bool:
    return isinstance(leaf, Bfloat16Bits) or np.issubdtype(np.asarray(leaf).dtype, np.floating)


def _cast(leaf, dtype):
    """A float leaf in ``dtype``: ``"bfloat16"`` (bits) or a numpy dtype."""
    if dtype in ("bfloat16", torch.bfloat16):
        return leaf if isinstance(leaf, Bfloat16Bits) else bf16_bits(leaf)
    return _f32(leaf).astype(dtype)


def quantize_lm_params(params: dict, mode: str, group_size: int = 0, hp_dtype="bfloat16"):
    """Quantize a ``TransformerLM`` flax tree (nested numpy dicts) for
    serving under ``TransformerConfig(weight_dtype=mode,
    quant_group_size=group_size)``: the four matmul kernels a block become
    ``kernel_q`` + ``scale`` (int8) or ``kernel_q`` + ``gscale`` (int4),
    every other float leaf is cast to ``hp_dtype`` (``"bfloat16"``, a numpy
    float dtype, or None to keep it)."""
    if mode not in _MODES:
        raise ValueError(f"mode must be int8/int4, got {mode!r}")
    if mode == "int4" and group_size <= 0:
        raise ValueError("int4 quantization requires group_size > 0")
    out = {}
    for path, leaf in _flatten(params):
        if QUANT_KERNEL_RE.search("/".join(path)):
            if mode == "int8":
                q, s = quantize_int8_channelwise(leaf)
                out[path[:-1] + ("kernel_q",)] = q
                out[path[:-1] + ("scale",)] = s
            else:
                q, s = quantize_int4_groupwise(leaf, group_size)
                out[path[:-1] + ("kernel_q",)] = q
                out[path[:-1] + ("gscale",)] = s
        elif hp_dtype is not None and _is_float(leaf):
            out[path] = _cast(leaf, hp_dtype)
        else:
            out[path] = leaf
    return _unflatten(out)


def dequantize_lm_params(qparams: dict, mode: str, group_size: int = 0, dtype=np.float32):
    """Inverse of :func:`quantize_lm_params` up to rounding: plain ``kernel``
    leaves rebuilt and every float leaf cast to ``dtype``, so the tree loads
    into an unquantized ``TransformerLM`` (the quality floors' reference)."""
    flat = dict(_flatten(qparams))
    out = {}
    for path, leaf in flat.items():
        if path[-1] == "kernel_q":
            if mode == "int8":
                w = dequantize_int8(leaf, flat[path[:-1] + ("scale",)])
            else:
                w = dequantize_int4(leaf, flat[path[:-1] + ("gscale",)], group_size)
            out[path[:-1] + ("kernel",)] = _cast(w, dtype)
        elif path[-1] in ("scale", "gscale") and path[:-1] + ("kernel_q",) in flat:
            continue  # folded into the rebuilt kernel (a LayerNorm scale passes below)
        elif _is_float(leaf):
            out[path] = _cast(leaf, dtype)
        else:
            out[path] = leaf
    return _unflatten(out)


def tree_bytes(params: dict) -> int:
    """Stored bytes of a flax tree of arrays, int codes and scales included."""
    return int(sum(np.asarray(leaf).nbytes for _, leaf in _flatten(params)))


def kv_cache_bytes_per_token(cfg) -> int:
    """KV-cache bytes per token position across all layers in the format
    ``cfg.kv_cache_dtype`` selects: k + v rows of ``kv_heads * head_dim``
    elements a layer, plus one f32 scale per (kv head, row kind) at int8."""
    dh = cfg.d_model // cfg.num_heads
    kv = cfg.kv_heads
    if getattr(cfg, "kv_cache_dtype", None) == "int8":
        per_layer = 2 * kv * dh * 1 + 2 * kv * 4
    else:
        per_layer = 2 * kv * dh * torch.empty((), dtype=cfg.compute_dtype).element_size()
    return int(cfg.num_layers * per_layer)
