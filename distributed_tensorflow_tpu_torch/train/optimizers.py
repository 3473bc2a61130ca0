"""Optimizer + learning-rate-schedule factory on ``torch.optim``.

Counterpart of ``distributed_tensorflow_tpu/train/optimizers.py`` (optax):
the same optimizer and schedule names with the same update rules — adam and
adamw (weight decay 1e-4, decoupled), sgd, and sgd with momentum 0.9 — the
same schedule formulas, and optional global-norm clipping, applied the way
optax applies them (the k-th update uses the schedule's value at k).
"""

from __future__ import annotations

import math

import torch

OPTIMIZERS = ("adam", "adamw", "sgd", "momentum")
SCHEDULES = ("constant", "cosine", "warmup_cosine", "linear")


def _linear(init: float, end: float, steps: int):
    def f(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return f


def _cosine(init: float, steps: int, alpha: float):
    def f(count: int) -> float:
        c = min(count, steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / steps)) + alpha)

    return f


def make_schedule(name: str, learning_rate: float, total_steps: int,
                  warmup_steps: int = 0, final_scale: float = 0.0):
    """``schedule(count) -> learning rate``, the optax schedule of the same
    name. ``final_scale`` is the end rate as a fraction of the peak."""
    if name == "constant":
        return lambda count: learning_rate
    if name == "cosine":
        return _cosine(learning_rate, max(total_steps, 1), final_scale)
    if name == "warmup_cosine":
        warm = max(warmup_steps, 1)
        decay = max(total_steps, warmup_steps + 1)
        up = _linear(0.0, learning_rate, warm)
        down = _cosine(learning_rate, decay - warm, final_scale)
        return lambda count: up(count) if count < warm else down(count - warm)
    if name == "linear":
        return _linear(learning_rate, learning_rate * final_scale, max(total_steps, 1))
    raise ValueError(f"unknown schedule {name!r} (choices: {SCHEDULES})")


class Optimizer:
    """A ``torch.optim`` optimizer, its ``LambdaLR`` schedule and optional
    global-norm clipping, stepped together: :meth:`step` clips the
    gradients, applies one update and advances the schedule."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 scheduler: torch.optim.lr_scheduler.LambdaLR, grad_clip_norm: float = 0.0):
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.grad_clip_norm = grad_clip_norm

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(
                [p for grp in self.optimizer.param_groups for p in grp["params"]],
                self.grad_clip_norm,
            )
        self.optimizer.step()
        self.scheduler.step()


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: gradients scaled by
    min(1, max_norm / global_norm), with no host synchronisation."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    )
    coef = torch.clamp(max_norm / norm, max=1.0)
    for g in grads:
        g.mul_(coef.to(g.dtype))


def make_optimizer(name: str, params, learning_rate: float, total_steps: int,
                   schedule: str = "constant", warmup_steps: int = 0,
                   weight_decay: float = 1e-4, momentum: float = 0.9,
                   grad_clip_norm: float = 0.0) -> Optimizer:
    """Build the train-step optimizer over ``params``."""
    params = list(params)
    # On the card, one fused kernel per update instead of several full
    # passes over the parameters (the same update rule).
    fused = bool(params) and params[0].is_cuda
    if name == "adam":
        opt = torch.optim.Adam(params, lr=learning_rate, eps=1e-8, fused=fused)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=learning_rate, eps=1e-8, weight_decay=weight_decay,
                                fused=fused)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=learning_rate, fused=fused)
    elif name == "momentum":
        opt = torch.optim.SGD(params, lr=learning_rate, momentum=momentum, fused=fused)
    else:
        raise ValueError(f"unknown optimizer {name!r} (choices: {OPTIMIZERS})")
    sched = make_schedule(schedule, learning_rate, total_steps, warmup_steps)
    factor = (lambda count: sched(count) / learning_rate) if learning_rate else (lambda c: 0.0)
    return Optimizer(opt, torch.optim.lr_scheduler.LambdaLR(opt, factor), grad_clip_norm)
