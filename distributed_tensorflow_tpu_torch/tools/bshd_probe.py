"""BSHD-native flash forward probe (K10): does reading q, k and v through
(B, S, H·dh) strides cost anything against contiguous (B, H, S, dh)?

Counterpart of the JAX package's ``tools/bshd_probe.py``, whose
``bshd_forward`` indexes the activation (B, S, H·dh) directly with the
shipped forward body. Here the kernel is the shipped forward (at bf16
``csrc/flash_fwd_sm90.cu``, by ``ops.attention.forward_kernel``), handed
(B, S, H, dh) head views of the flat operands
with no copy (K7's route), counted under ``KERNEL_LAUNCHES
["probe_bshd_fwd"]``; CPU tensors take the plain version. The head count is
an argument instead of a module global.

    python -m distributed_tensorflow_tpu_torch.tools.bshd_probe

prints one JSON record per reading at B 12, H 16, S 2048, dh 128 (bf16,
causal, q = k = v = x, x = 0.1·normal from a numpy seed): the difference
of the BSHD forward against K3 on a contiguous BHSD copy — 0, since both
run one kernel instance on different strides — then both forwards' ms in
turns (bshd, bhsd, bhsd, bshd), and last the launch counts. It raises
without a card.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.ops import attention as A
from distributed_tensorflow_tpu_torch.utils.device import resolve_device
from distributed_tensorflow_tpu_torch.utils.flops import chip_peak_flops
from distributed_tensorflow_tpu_torch.utils.timer import cuda_ms

B, H, S, DH = 12, 16, 2048, 128
ITERS = 20


def _views(q, k, v, num_heads):
    for t in (q, k, v):
        if t.dim() != 3 or t.shape[-1] % num_heads:
            raise ValueError(f"operands must be (B, S, {num_heads}·dh), got {tuple(t.shape)}")
    d = q.shape[-1] // num_heads
    return [A._heads(t, d) for t in (q, k, v)]


def _flat(out, lse):
    b, h, s = lse.shape
    return A._unheads(out), lse.reshape(b * h, s, 1)


def bshd_forward_reference(q, k, v, num_heads: int):
    """Plain version of K10: the plain flash forward on head views."""
    return _flat(*A.flash_forward_reference(*_views(q, k, v, num_heads), True))


def bshd_forward(q, k, v, num_heads: int):
    """Causal flash forward of q, k, v (B, S, H·dh), scale 1/√dh, as the JAX
    function fixes them. Returns out (B, S, H·dh) and lse (B·H, S, 1) f32,
    the JAX function's shapes: K10 for CUDA tensors, the plain version for
    CPU ones."""
    if A._on(q) == "cuda":
        views = _views(q, k, v, num_heads)
        return _flat(*A.flash_forward_kernel(*views, True, counter="probe_bshd_fwd"))
    return bshd_forward_reference(q, k, v, num_heads)


def _emit(**record) -> None:
    print(json.dumps(record), flush=True)


def main() -> None:
    device = resolve_device("cuda")
    peak = chip_peak_flops(device)
    rng = np.random.default_rng(0)
    x = (0.1 * torch.from_numpy(rng.standard_normal((B, S, H * DH), dtype=np.float32))).to(
        device=device, dtype=torch.bfloat16)
    xh = A._heads(x, DH).contiguous()  # (B, H, S, dh)
    ref, ref_lse = A.flash_forward_kernel(xh, xh, xh, True)
    got, lse = bshd_forward(x, x, x, H)
    got_h = A._heads(got, DH)
    err = (got_h.float() - ref.float()).abs().max().item()
    equal = bool(torch.equal(got_h, ref) and torch.equal(lse.reshape(B, H, S), ref_lse))
    _emit(probe="bshd", max_abs_diff_bshd_vs_bhsd=err, bitwise_equal=equal)
    if not equal:
        raise RuntimeError(f"BSHD and BHSD forwards differ: max |diff| = {err:.2e}")
    del ref, ref_lse, got, lse, got_h
    flops = 2 * B * H * S * S * DH  # the causal half of 4·B·H·S²·dh
    runs = {
        "bshd": lambda: bshd_forward(x, x, x, H),
        "bhsd": lambda: A.flash_forward_kernel(xh, xh, xh, True),
    }
    for name in ("bshd", "bhsd", "bhsd", "bshd"):
        ms = cuda_ms(runs[name], ITERS)
        tflops = flops / ms / 1e9
        _emit(probe="bshd", layout=name, ms=ms, tflops=tflops,
              pct_peak=None if peak is None else 100 * tflops * 1e12 / peak)
    _emit(probe="bshd", device=torch.cuda.get_device_name(device),
          launches={key: A.KERNEL_LAUNCHES[key] for key in ("bhsd_fwd", "probe_bshd_fwd")})


if __name__ == "__main__":
    main()
