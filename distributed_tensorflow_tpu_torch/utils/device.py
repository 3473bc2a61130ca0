"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device present, asking for ``cuda`` raises instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """``"cuda"``/``"cuda:N"`` → that card (raises when torch sees none);
    ``"cpu"`` → the CPU. Anything else raises."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass --device cpu (device='cpu') "
                "to run on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {name!r} (use 'cuda' or 'cpu')")


def compute_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, f32 on the CPU — the JAX trainer's rule of bf16
    only on its accelerator. Parameters stay f32 either way."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
