"""Software-pipelining probe for the flash forward (K9): does overlapping
the softmax of kv tile n with the tensor-core product of tile n + 1 make
the forward faster on this card?

Counterpart of the JAX package's ``tools/pipeline_probe.py``. Its
``pipe_flash_forward`` becomes, for CUDA tensors, a kernel that issues
Q·K_{n+1}ᵀ before the softmax of tile n and keeps K one tile ahead of V —
``csrc/flash_fwd_pipe_sm90.cu`` in bf16, the shipped warpgroup forward's
skeleton with only that issue order changed, and ``csrc/flash_fwd_pipe.cu``
in f32 (``ops.attention.pipe_forward_kernel``), at head_dim 64, 128 and 256
(any other head_dim up to 256 zero-padded to the next; above 256, where the
order is not built, the call runs the shipped forward at that head dim) —
and :func:`pipe_flash_forward_reference` for CPU ones. Like the JAX
function it takes any head dim. The TPU's ``block_q``/``block_kv`` are left
out, because the CUDA kernels fix their own tiles, and so is the unused
``out_dtype``: out is in q's dtype.

    python -m distributed_tensorflow_tpu_torch.tools.pipeline_probe

prints one JSON record per reading at the probe's two shapes (bf16,
causal): the parity of K9 against the shipped forward K3 (at bf16
``csrc/flash_fwd_sm90.cu``, by ``ops.attention.forward_kernel``, which
issues S_n with P_{n-1}·V_{n-1} and runs the softmax of S_n under the
latter), then ms, TFLOP/s over ``2·b·h·s²·d`` and the share of the card's
peak for "current" (K3) and "pipelined" (K9), timed in turns (current,
pipelined, pipelined, current), then the verdict — the mean pipelined over
the mean current time, so which issue order wins on this card and by how
much — and last the launch counts. It raises without a card.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.ops import attention as A
from distributed_tensorflow_tpu_torch.utils.device import resolve_device
from distributed_tensorflow_tpu_torch.utils.flops import chip_peak_flops
from distributed_tensorflow_tpu_torch.utils.timer import cuda_ms

# The probe's shapes (B, H, S, D): the bench flagship's attention call and
# the 8k bench shape.
SHAPES = {"flagship_2k": (12, 16, 2048, 128), "8k_d128": (1, 8, 8192, 128)}
PARITY_TOL = 1e-2  # max |K9 - K3|, the JAX probe's limit
ITERS = 20


def _check_heads(q, k, v) -> None:
    A._bhsd_dims(q, k, v)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"k and v must carry q's {q.shape[1]} heads, got {k.shape[1]}")


def pipe_flash_forward_reference(q, k, v, causal: bool = True, scale: float | None = None):
    """Plain version of K9: the plain flash forward (q scale-folded and
    rounded, dense masked softmax in f32). Returns out (B, H, Sq, D)."""
    _check_heads(q, k, v)
    return A.flash_forward_reference(q, k, v, causal, None, scale)[0]


def pipe_flash_forward_kernel(q, k, v, causal: bool = True, scale: float | None = None):
    """Launch K9 on q's stream (``flash_fwd_pipe_sm90.cu`` in bf16,
    ``flash_fwd_pipe.cu`` in f32; above head_dim 256 the shipped forward's
    source). Returns ``out`` (B,
    H, Sq, D) in q's layout and ``lse`` (B, H, Sq) f32 — the kernel writes
    lse, as the TPU kernel does, so the timed work matches."""
    _check_heads(q, k, v)
    b, h, sq, skv, _ = A._check_bhsd_kernel_operands(q, k, v, causal, None)
    q, k, v = (A._kernel_layout(t) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    A._launch_pipe_forward(q, k, v, out, lse, causal, skv - sq, scale)
    return out, lse


def pipe_flash_forward(q, k, v, causal: bool = True, scale: float | None = None):
    """Flash forward of q (B, H, Sq, D) against k, v (B, H, Skv, D), causal
    masking end-aligned: K9 for CUDA tensors (counted under
    ``KERNEL_LAUNCHES["pipe_fwd"]``), the plain version for CPU ones.
    Returns out (B, H, Sq, D)."""
    if A._on(q) == "cuda":
        return pipe_flash_forward_kernel(q, k, v, causal, scale)[0]
    return pipe_flash_forward_reference(q, k, v, causal, scale)


def _emit(**record) -> None:
    print(json.dumps(record), flush=True)


def main() -> None:
    device = resolve_device("cuda")
    peak = chip_peak_flops(device)
    for tag, (b, h, s, d) in SHAPES.items():
        rng = np.random.default_rng(0)
        q, k, v = (
            torch.from_numpy(rng.standard_normal((b, h, s, d), dtype=np.float32))
            .to(device=device, dtype=torch.bfloat16)
            for _ in range(3)
        )
        ref = A.flash_forward_kernel(q, k, v, True)[0]
        got = pipe_flash_forward(q, k, v, True)
        err = (got.float() - ref.float()).abs().max().item()
        _emit(probe="pipeline", shape=tag, max_abs_diff_vs_current=err,
              bitwise_equal=bool(torch.equal(got, ref)), tol=PARITY_TOL)
        if not err < PARITY_TOL:
            raise RuntimeError(f"[{tag}] max |pipelined - current| = {err:.2e}")
        del ref, got
        flops = 2 * b * h * s * s * d  # the causal half of 4·b·h·s²·d
        runs = {
            "current": lambda: A.flash_forward_kernel(q, k, v, True),
            "pipelined": lambda: pipe_flash_forward(q, k, v, True),
        }
        times = {"current": [], "pipelined": []}
        for name in ("current", "pipelined", "pipelined", "current"):
            ms = cuda_ms(runs[name], ITERS)
            times[name].append(ms)
            tflops = flops / ms / 1e9
            _emit(probe="pipeline", shape=tag, kernel=name, ms=ms, tflops=tflops,
                  pct_peak=None if peak is None else 100 * tflops * 1e12 / peak)
        ratio = sum(times["pipelined"]) / sum(times["current"])
        _emit(probe="pipeline", shape=tag, pipelined_over_current=ratio,
              verdict="the probe's order (S_{n+1} before softmax_n) is "
                      + ("faster" if ratio < 1 else "slower")
                      + f" than K3's by {abs(1 - ratio):.1%}")
        del q, k, v
    _emit(probe="pipeline", device=torch.cuda.get_device_name(device),
          launches={key: A.KERNEL_LAUNCHES[key] for key in ("bhsd_fwd", "pipe_fwd")})


if __name__ == "__main__":
    main()
