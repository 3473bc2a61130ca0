"""Model-FLOPs accounting and the card's peak rates — the MFU denominator.

``transformer_train_flops`` is the JAX package's accounting
(``distributed_tensorflow_tpu/utils/flops.py``): matmul work of one
optimizer step (fwd + bwd = 3x fwd), causal attention at its half-triangle
(or banded, under a window) cost, no recompute. The peaks are NVIDIA's data
sheet numbers for the dense bf16 tensor-core rate and the memory rate at
the card's full power limit.
"""

from __future__ import annotations

import torch

# (device-name substring, bf16 dense FLOP/s, memory bytes/s), checked in order.
_CARDS = (
    ("H100 PCIe", 756e12, 2.0e12),
    ("H100", 989e12, 3.35e12),  # SXM (HBM3)
)


def _card(device) -> tuple[float, float] | None:
    device = torch.device(device) if device is not None else None
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda")
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for sub, flops, bw in _CARDS:
        if sub in name:
            return flops, bw
    return None


def chip_peak_flops(device=None) -> float | None:
    """Peak bf16 FLOP/s of the CUDA ``device`` (default: the current card),
    or None on the CPU or an unknown card — callers then report MFU as
    null rather than invent a denominator."""
    card = _card(device)
    return None if card is None else card[0]


def chip_hbm_bandwidth(device=None) -> float | None:
    """Peak device-memory bytes/s of the CUDA ``device``, or None."""
    card = _card(device)
    return None if card is None else card[1]


def transformer_train_flops(cfg, batch_size: int, seq_len: int | None = None,
                            causal: bool = True) -> int:
    """Model matmul FLOPs for ONE optimizer step (fwd + bwd) of
    ``TransformerLM(cfg)`` on ``(batch_size, seq_len)`` tokens: per layer
    4·d² for q,k,v,o (k/v narrowed under GQA) + 2·d·d_ff, plus the logits
    projection, at 2·tokens FLOPs per parameter; attention 4·B·S²·d per
    layer, halved for causal or counted over the band under a window."""
    s = int(cfg.max_seq_len if seq_len is None else seq_len)
    b = int(batch_size)
    d = int(cfg.d_model)
    tokens = b * s
    kv_width = (d // cfg.num_heads) * int(cfg.kv_heads)
    n_matmul = (
        cfg.num_layers * (2 * d * d + 2 * d * kv_width + 2 * d * cfg.d_ff)
        + d * cfg.vocab_size
    )
    dense = 2 * tokens * n_matmul
    window = getattr(cfg, "attention_window", None)
    if causal and window is not None and window < s:
        pairs = window * (window + 1) // 2 + (s - window) * window
        attn = 4 * b * pairs * d * cfg.num_layers
    else:
        attn = 4 * b * s * s * d * cfg.num_layers
        if causal:
            attn //= 2
    return 3 * (dense + attn)
