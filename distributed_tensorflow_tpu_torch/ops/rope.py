"""Rotary position embeddings, split-half (GPT-NeoX) layout.

Counterpart of ``distributed_tensorflow_tpu/ops/rope.py``: the head vector's
first half pairs with its second half, rotated by ``pos · θ^(-i/half)``.
Angles and the rotation arithmetic run in f32 whatever the operand dtype,
and the result is cast back to it.
"""

from __future__ import annotations

import torch

__all__ = ["rope_cos_sin", "rope_tables", "apply_rope"]


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """f32 ``cos, sin`` of shape ``positions.shape + (head_dim // 2,)``."""
    if head_dim % 2:
        raise ValueError(f"rope requires an even head_dim, got {head_dim}")
    half = head_dim // 2
    inv_freq = theta ** (
        -torch.arange(half, dtype=torch.float32, device=positions.device) / half
    )
    ang = positions.to(torch.float32)[..., None] * inv_freq
    # cos and sin of the f32 angles are taken in f64 and rounded to f32:
    # torch's vectorised f32 cos on AVX-512 CPUs was seen to return some
    # processes' tables off by up to 1.5e-4.
    ang = ang.to(torch.float64)
    return torch.cos(ang).to(torch.float32), torch.sin(ang).to(torch.float32)


def rope_tables(head_dim: int, seq_len: int, theta: float = 10000.0,
                positions: torch.Tensor | None = None, start: int = 0,
                device: torch.device | str = "cpu"):
    """Explicit ``positions`` (B, S) → (B, S, half) tables; None →
    ``start + arange(seq_len)`` → (1, S, half), broadcasting over batch."""
    if positions is None:
        pos = start + torch.arange(seq_len, dtype=torch.int32, device=device)
        cos, sin = rope_cos_sin(pos, head_dim, theta)
        return cos[None], sin[None]
    return rope_cos_sin(positions, head_dim, theta)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., S, n_heads, head_dim) by ``cos``/``sin``
    (..., S, head_dim//2), broadcast over the heads axis. Returns x's dtype;
    arithmetic in f32."""
    half = x.shape[-1] // 2
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    c = cos.to(torch.float32)[..., None, :]
    s = sin.to(torch.float32)[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
