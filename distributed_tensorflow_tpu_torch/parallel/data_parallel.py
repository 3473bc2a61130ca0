"""LM train step.

Counterpart of ``build_lm_train_step`` in
``distributed_tensorflow_tpu/parallel/data_parallel.py``. This slice runs on
one device; gradient averaging across GPUs (``torch.distributed``) comes
with multi-GPU data parallelism in a later slice.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.models.transformer import next_token_loss


def build_lm_train_step(model: torch.nn.Module, opt):
    """``step(tokens) -> {"loss"}``: one optimizer step of next-token
    cross-entropy on ``tokens`` (B, S) on the model's device. ``opt`` is a
    ``train.optimizers.Optimizer``. The loss comes back as a device scalar:
    the step never waits for the device."""

    def step(tokens: torch.Tensor) -> dict[str, torch.Tensor]:
        opt.zero_grad()
        loss = next_token_loss(model(tokens), tokens)
        loss.backward()
        opt.step()
        return {"loss": loss.detach()}

    return step
