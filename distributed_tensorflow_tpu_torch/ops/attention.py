"""Attention ops: the dense reference and flash attention — on the packed
qkv projection and on (B, H, S, D) operands — with hand-written CUDA kernels
for Hopper.

Counterpart of ``distributed_tensorflow_tpu/ops/attention.py``. Semantics
are the JAX package's:

  * causal masking is **end-aligned** — query ``i`` attends keys
    ``<= i + (Skv - Sq)`` — and a ``window`` (causal only) keeps keys in
    ``[p - window + 1, p]`` (the Mistral convention);
  * the packed flash path takes the fused projection ``qkv`` (B, S,
    (H + 2·KV)·dh), columns ``[q | k | v]`` with heads contiguous inside
    each section; under GQA each group of H/KV query heads reads its shared
    kv head's columns;
  * rope tables (1|B, S, dh/2) rotate q and k (split-half, f32 arithmetic,
    rounded to the operand dtype) before the softmax scale is folded into q
    and rounded again — the FlashAttention-2 convention the Pallas kernels
    use;
  * the BHSD flash path (:func:`flash_attention`) takes q (B, H, Sq, D) and
    k, v (B, H, Skv, D) already rotated and with kv heads repeated, as the
    tensor-parallel block hands them over.

Two implementations of each flash path: the CUDA kernels ``csrc/
flash_fwd.cu`` / ``csrc/flash_bwd.cu`` — one pair on strided (B, H, S, D)
operands, as the Pallas ``_flash_kernel`` / ``_flash_bwd_fused_kernel`` are
one pair behind ``_flash_forward_qkv`` / ``_flash_backward_qkv`` and
``_flash_forward`` / ``_flash_backward_fused``; the packed path hands them
head views of qkv — and their plain PyTorch versions (``*_reference``). A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises — there is no fallback between them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from distributed_tensorflow_tpu_torch.ops import _build
from distributed_tensorflow_tpu_torch.ops.rope import apply_rope, rope_tables

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free

# Launches of each kernel since the counts were last zeroed; a wrapper adds
# one exactly where it launches, so a run can show it went through them.
KERNEL_LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0, "bhsd_fwd": 0, "bhsd_bwd": 0}

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_KERNEL_HEAD_DIMS = (64, 128)


def _scale(head_dim: int, scale: float | None) -> float:
    return (1.0 / math.sqrt(head_dim)) if scale is None else float(scale)


def _mask(sq: int, skv: int, causal: bool, window: int | None, device,
          q_pos_offset: int | None = None):
    """(sq, skv) bool, True = attend; None when nothing is masked. Query row
    i sits at position i + q_pos_offset (default skv - sq: end-aligned)."""
    if not causal:
        return None
    offset = skv - sq if q_pos_offset is None else q_pos_offset
    q_pos = torch.arange(sq, device=device)[:, None] + offset
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _check_window(causal: bool, window: int | None) -> None:
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal=True and window >= 1")


def dense_attention(q, k, v, causal: bool = False, scale: float | None = None,
                    window: int | None = None):
    """O(S²)-memory reference: softmax(q·kᵀ·s [+ mask]) · v.

    q: (B, H, Sq, D); k, v: (B, H, Skv, D). Returns (B, H, Sq, D) in q's
    dtype. Logits and softmax in f32; the weights round to q's dtype before
    the value product, which accumulates in f32."""
    _check_window(causal, window)
    s = _scale(q.shape[-1], scale)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * s
    mask = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    if mask is not None:
        # Fully-masked rows (possible when sq > skv) output 0.
        weights = weights * mask.any(dim=-1)[:, None]
    weights = weights.to(q.dtype).float()
    return torch.einsum("bhqk,bhkd->bhqd", weights, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# Packed-qkv flash self-attention: shapes, plain versions.
# ---------------------------------------------------------------------------


def _qkv_dims(qkv: torch.Tensor, h: int, kv: int) -> tuple[int, int, int, int]:
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, S, (H + 2*KV)*head_dim), got {tuple(qkv.shape)}")
    b, sq, width = qkv.shape
    if kv < 1 or h % kv:
        raise ValueError(f"num_heads {h} must be a positive multiple of num_kv_heads {kv}")
    if width % (h + 2 * kv):
        raise ValueError(
            f"packed qkv width {width} is not (num_heads + 2*num_kv_heads) "
            f"= {h + 2 * kv} head columns"
        )
    return b, sq, width, width // (h + 2 * kv)


def rope_operands(qkv, head_dim, rope_cos=None, rope_sin=None, rope_theta=None):
    """Resolve the rope inputs to f32 ``(cos, sin)`` tables (1|B, S, dh/2),
    or ``(None, None)``. ``rope_theta`` (contiguous positions) builds the
    tables once with :func:`ops.rope.rope_tables` — the JAX package's table
    fallback for its in-kernel "iota" mode. Tables may arrive bf16 (the
    model rounds them under bf16 compute); the rotation runs in f32."""
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("rope_cos and rope_sin must be passed together")
    b, sq = qkv.shape[:2]
    if rope_theta is not None:
        if rope_cos is not None:
            raise ValueError(
                "pass either rope_theta (contiguous positions) or "
                "rope_cos/rope_sin (explicit positions), not both"
            )
        return rope_tables(head_dim, sq, rope_theta, device=qkv.device)
    if rope_cos is None:
        return None, None
    expect_tail = (sq, head_dim // 2)
    for name, t in (("rope_cos", rope_cos), ("rope_sin", rope_sin)):
        if t.dim() != 3 or t.shape[0] not in (1, b) or tuple(t.shape[1:]) != expect_tail:
            raise ValueError(
                f"{name} must be (1|{b}, {sq}, {head_dim // 2}), got {tuple(t.shape)}"
            )
    return rope_cos.float(), rope_sin.float()


def _plain_scores(qkv, h, kv, cos, sin, s, causal, window):
    """The plain versions' shared front: (B, H, S, D) f32 views of the
    rotated, scale-folded q and of k, v with kv heads repeated to H —
    rounded exactly as the kernels round them — and the masked f32 logits."""
    b, sq, _, d = _qkv_dims(qkv, h, kv)
    q, k, v = qkv.split([h * d, kv * d, kv * d], dim=-1)
    q = q.reshape(b, sq, h, d)
    k = k.reshape(b, sq, kv, d)
    v = v.reshape(b, sq, kv, d)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q = (q.float() * s).to(qkv.dtype)
    heads = lambda t: t.float().transpose(1, 2)  # (B, S, n, D) -> (B, n, S, D)
    qh = heads(q)
    kh = heads(k).repeat_interleave(h // kv, dim=1)
    vh = heads(v).repeat_interleave(h // kv, dim=1)
    logits = qh @ kh.transpose(-1, -2)
    mask = _mask(sq, sq, causal, window, qkv.device)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    return qh, kh, vh, logits


def flash_forward_qkv_reference(qkv, num_heads, num_kv_heads=None, causal=False,
                                window=None, rope_cos=None, rope_sin=None,
                                rope_theta=None, scale=None):
    """Plain version of the forward kernel: unpack, rotate, fold the scale,
    repeat kv, dense masked softmax in f32. Returns ``out`` (B, S, H·dh) in
    qkv's dtype and ``lse`` (B, H, S) f32, the row logsumexp."""
    h = num_heads
    kv = h if num_kv_heads is None else num_kv_heads
    _check_window(causal, window)
    b, sq, _, d = _qkv_dims(qkv, h, kv)
    cos, sin = rope_operands(qkv, d, rope_cos, rope_sin, rope_theta)
    _, _, vh, logits = _plain_scores(qkv, h, kv, cos, sin, _scale(d, scale), causal, window)
    lse = torch.logsumexp(logits, dim=-1)
    out = torch.exp(logits - lse[..., None]) @ vh
    return out.transpose(1, 2).reshape(b, sq, h * d).to(qkv.dtype), lse


def flash_backward_qkv_reference(qkv, out, lse, g, num_heads, num_kv_heads=None,
                                 causal=False, window=None, rope_cos=None,
                                 rope_sin=None, rope_theta=None, scale=None):
    """Plain version of the backward kernel, the explicit formula in f32:
    p from the saved lse, delta = rowsum(dO∘O), dv = pᵀ·dO,
    dS = p∘(dO·vᵀ − delta), dq = s·dS·k, dk = dSᵀ·(q·s); dq and dk rotate
    back by the inverse rope; GQA sums each group's kv grads into its
    shared kv head. Returns dqkv shaped and typed like qkv."""
    h = num_heads
    kv = h if num_kv_heads is None else num_kv_heads
    _check_window(causal, window)
    b, sq, _, d = _qkv_dims(qkv, h, kv)
    s = _scale(d, scale)
    cos, sin = rope_operands(qkv, d, rope_cos, rope_sin, rope_theta)
    qh, kh, vh, logits = _plain_scores(qkv, h, kv, cos, sin, s, causal, window)
    heads = lambda t: t.float().reshape(b, sq, h, d).transpose(1, 2)
    g4, o4 = heads(g), heads(out)
    p = torch.exp(logits - lse[..., None])
    dv = p.transpose(-1, -2) @ g4
    delta = (g4 * o4).sum(dim=-1, keepdim=True)
    ds = p * (g4 @ vh.transpose(-1, -2) - delta)
    dk = ds.transpose(-1, -2) @ qh
    dq = s * (ds @ kh)

    def rows(t, n):
        # (B, H, S, D) per-q-head grads -> (B, S, n, D), group-summed to n heads.
        t = t.reshape(b, n, h // n, sq, d).sum(dim=2)
        return t.transpose(1, 2)

    dq, dk, dv = rows(dq, h), rows(dk, kv), rows(dv, kv)
    if cos is not None:
        dq = apply_rope(dq, cos, -sin)
        dk = apply_rope(dk, cos, -sin)
    return torch.cat(
        [dq.reshape(b, sq, h * d), dk.reshape(b, sq, kv * d), dv.reshape(b, sq, kv * d)],
        dim=-1,
    ).to(qkv.dtype)


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers.
# ---------------------------------------------------------------------------

_FWD_ARGTYPES = (
    [ctypes.c_void_p] * 8  # q, k, v, out, lse, cos, sin, strides
    + [ctypes.c_int] * 10  # B, H, KV, Sq, Skv, D, is_bf16, causal, window, q_pos_offset
    + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]  # table stride, scale, stream
)
_BWD_ARGTYPES = (
    # q, k, v, out, dout, lse, cos, sin, dq, dk, dv, dq_acc, delta, strides
    [ctypes.c_void_p] * 14
    + [ctypes.c_int] * 10
    + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
)


def _kernel_fn(name: str, argtypes):
    fn = getattr(_build.load(name), f"dtt_{name}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {status}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _table_stride(cos) -> int:
    return 0 if cos is None or cos.shape[0] == 1 else cos.shape[1] * cos.shape[2]


def _strides(*tensors) -> ctypes.Array:
    """The (b, h, s) element strides of each 4-D operand, as the kernels'
    host array."""
    vals = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch_forward(counter, q, k, v, out, lse, causal, window, q_pos_offset, scale,
                    cos=None, sin=None) -> None:
    """Launch ``csrc/flash_fwd.cu`` on q's stream: q, out (B, H, Sq, D) and
    k, v (B, KV, Skv, D) views with a contiguous last dimension, lse (B, H,
    Sq) f32; rope tables only for self-attention at offset 0. The launch
    counts under ``KERNEL_LAUNCHES[counter]``."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    strides = _strides(q, k, v, out)
    fn = _kernel_fn("flash_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), _ptr(cos), _ptr(sin),
            ctypes.addressof(strides), b, h, kv, sq, skv, d, int(q.dtype == torch.bfloat16),
            int(causal), window or 0, q_pos_offset, _table_stride(cos), _scale(d, scale),
            stream,
        )
        KERNEL_LAUNCHES[counter] += 1
    _check_status(counter, status)


def _launch_backward(counter, q, k, v, out, g, lse, dq, dk, dv, causal, window,
                     q_pos_offset, scale, cos=None, sin=None) -> None:
    """Launch ``csrc/flash_bwd.cu`` on q's stream — a delta pre-pass, the
    kv-tile kernel (dk/dv in registers, GQA group sums included, dq by f32
    atomics into a scratch allocated here) and the dq rotate-back/cast pass —
    writing dq, dk, dv through their strides."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    dq_acc = torch.empty(b, h, sq, d, dtype=torch.float32, device=q.device)
    delta = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, out, g, dq, dk, dv)
    fn = _kernel_fn("flash_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(g), _ptr(lse), _ptr(cos), _ptr(sin),
            _ptr(dq), _ptr(dk), _ptr(dv), _ptr(dq_acc), _ptr(delta), ctypes.addressof(strides),
            b, h, kv, sq, skv, d, int(q.dtype == torch.bfloat16), int(causal), window or 0,
            q_pos_offset, _table_stride(cos), _scale(d, scale), stream,
        )
        KERNEL_LAUNCHES[counter] += 1
    _check_status(counter, status)


def _check_kernel_operands(qkv, h, kv, causal, window, cos, sin, *others):
    b, sq, width, d = _qkv_dims(qkv, h, kv)
    _check_window(causal, window)
    if qkv.device.type != "cuda":
        raise ValueError(f"the flash kernels take CUDA tensors, got {qkv.device}")
    if qkv.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the flash kernels take bf16 or f32, got {qkv.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernels take head_dim 64 or 128, got {d}")
    for t in (qkv, *others, *(() if cos is None else (cos, sin))):
        if t.device != qkv.device:
            raise ValueError(f"operand on {t.device}, qkv on {qkv.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the flash kernels take contiguous, 16-byte aligned operands")
    if cos is not None and (cos.dtype != torch.float32 or sin.dtype != torch.float32):
        raise ValueError("rope tables reach the kernels as f32")
    return b, sq, width, d


def _heads(t: torch.Tensor, d: int) -> torch.Tensor:
    """The (B, n, S, d) view of the heads of a (B, S, n·d) tensor: no copy."""
    return t.unflatten(-1, (-1, d)).transpose(1, 2)


def _packed_heads(qkv: torch.Tensor, h: int, kv: int, d: int):
    """q, k, v as head views of qkv's column sections."""
    return tuple(_heads(t, d) for t in qkv.split([h * d, kv * d, kv * d], dim=-1))


def flash_forward_qkv_kernel(qkv, num_heads, num_kv_heads, causal, window,
                             cos, sin, scale):
    """Launch ``csrc/flash_fwd.cu`` on qkv's stream, reading q, k and v in
    place through head views of qkv. ``cos``/``sin`` are the f32 tables
    from :func:`rope_operands` or None. Returns ``out`` (B, S, H·dh) and
    ``lse`` (B, H, S) f32, like the plain version."""
    h, kv = num_heads, num_kv_heads
    b, sq, _, d = _check_kernel_operands(qkv, h, kv, causal, window, cos, sin)
    out = torch.empty(b, sq, h * d, dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=qkv.device)
    _launch_forward("flash_fwd", *_packed_heads(qkv, h, kv, d), _heads(out, d), lse,
                    causal, window, 0, scale, cos, sin)
    return out, lse


def flash_backward_qkv_kernel(qkv, out, lse, g, num_heads, num_kv_heads, causal,
                              window, cos, sin, scale):
    """Launch ``csrc/flash_bwd.cu`` on qkv's stream, writing dq, dk and dv
    through head views of one dqkv. Returns dqkv."""
    h, kv = num_heads, num_kv_heads
    b, sq, width, d = _check_kernel_operands(
        qkv, h, kv, causal, window, cos, sin, out, lse, g
    )
    if out.dtype != qkv.dtype or g.dtype != qkv.dtype or lse.dtype != torch.float32:
        raise ValueError("out and g must match qkv's dtype and lse must be f32")
    if tuple(out.shape) != (b, sq, h * d) or tuple(g.shape) != (b, sq, h * d) \
            or tuple(lse.shape) != (b, h, sq):
        raise ValueError("out/g must be (B, S, H*dh) and lse (B, H, S)")
    dqkv = torch.empty(b, sq, width, dtype=qkv.dtype, device=qkv.device)
    _launch_backward("flash_bwd", *_packed_heads(qkv, h, kv, d), _heads(out, d), _heads(g, d),
                     lse, *_packed_heads(dqkv, h, kv, d), causal, window, 0, scale, cos, sin)
    return dqkv


def _on(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, got {t.device}")
    return t.device.type


class FlashAttentionQKV(torch.autograd.Function):
    """Flash self-attention on packed qkv with a kernel in each direction:
    CUDA tensors go through ``csrc/flash_fwd.cu`` / ``csrc/flash_bwd.cu``,
    CPU tensors through the plain versions. The f32 rope tables are
    constants (integer positions) and get no gradient."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, h, kv, causal, window, scale):
        if _on(qkv) == "cuda":
            out, lse = flash_forward_qkv_kernel(qkv, h, kv, causal, window, cos, sin, scale)
        else:
            out, lse = flash_forward_qkv_reference(
                qkv, h, kv, causal, window, cos, sin, scale=scale
            )
        ctx.save_for_backward(qkv, out, lse, cos, sin)
        ctx.args = (h, kv, causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse, cos, sin = ctx.saved_tensors
        h, kv, causal, window, scale = ctx.args
        g = g.contiguous()
        if _on(qkv) == "cuda":
            dqkv = flash_backward_qkv_kernel(
                qkv, out, lse, g, h, kv, causal, window, cos, sin, scale
            )
        else:
            dqkv = flash_backward_qkv_reference(
                qkv, out, lse, g, h, kv, causal, window, cos, sin, scale=scale
            )
        return dqkv, None, None, None, None, None, None, None


def flash_attention_qkv(qkv, num_heads: int, num_kv_heads: int | None = None,
                        causal: bool = False, window: int | None = None,
                        rope_cos=None, rope_sin=None, rope_theta: float | None = None,
                        scale: float | None = None):
    """Flash SELF-attention on the packed projection ``qkv`` (B, S,
    (H + 2·KV)·head_dim), columns [q | k | v]. Returns (B, S, H·head_dim).
    Differentiable in ``qkv``. Rope: ``rope_cos``/``rope_sin`` tables
    (1|B, S, head_dim//2), f32 or bf16, or ``rope_theta`` for contiguous
    positions."""
    kv = num_heads if num_kv_heads is None else num_kv_heads
    _check_window(causal, window)
    _, _, _, d = _qkv_dims(qkv, num_heads, kv)
    cos, sin = rope_operands(qkv, d, rope_cos, rope_sin, rope_theta)
    if cos is not None:
        cos, sin = cos.contiguous(), sin.contiguous()
    return FlashAttentionQKV.apply(qkv.contiguous(), cos, sin, num_heads, kv,
                                   causal, window, scale)


# ---------------------------------------------------------------------------
# BHSD flash attention: q (B, H, Sq, D), k and v (B, H, Skv, D).
# ---------------------------------------------------------------------------


def _bhsd_dims(q, k, v) -> tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, head_dim)")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(
            f"k and v must be (B, H, Skv, head_dim) matching q {tuple(q.shape)}, "
            f"got {tuple(k.shape)} and {tuple(v.shape)}"
        )
    return b, h, sq, k.shape[2], d


def _plain_logits(q, k, causal, window, s, q_pos_offset):
    """The BHSD plain versions' shared front: q scale-folded and rounded to
    its dtype as the kernels fold it, as f32, and the masked f32 logits."""
    qs = (q.float() * s).to(q.dtype).float()
    logits = qs @ k.float().transpose(-1, -2)
    mask = _mask(q.shape[2], k.shape[2], causal, window, q.device, q_pos_offset)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    return qs, logits


def _probs(logits, lse):
    # A row that attended nothing has lse ~ NEG_INF, which is finite, so
    # exp(logit - lse) would be 1 on its masked logits: zero it, as the
    # Pallas kernels do.
    return torch.where(lse[..., None] <= NEG_INF / 2, 0.0, torch.exp(logits - lse[..., None]))


def flash_forward_reference(q, k, v, causal=False, window=None, scale=None,
                            q_pos_offset=None):
    """Plain version of the BHSD forward kernel: scale folded into q, dense
    masked softmax in f32. Returns ``out`` (B, H, Sq, D) in q's dtype — 0 on
    rows that attend nothing — and ``lse`` (B, H, Sq) f32, the row
    logsumexp (NEG_INF on such rows)."""
    _check_window(causal, window)
    _, _, _, _, d = _bhsd_dims(q, k, v)
    _, logits = _plain_logits(q, k, causal, window, _scale(d, scale), q_pos_offset)
    lse = torch.logsumexp(logits, dim=-1)
    out = _probs(logits, lse) @ v.float()
    return out.to(q.dtype), lse


def flash_backward_reference(q, k, v, out, lse, g, causal=False, window=None, scale=None,
                             q_pos_offset=None):
    """Plain version of the BHSD backward kernel, the explicit formula in
    f32: p from the saved lse (0 on rows that attended nothing), delta =
    rowsum(dO∘O), dv = pᵀ·dO, dS = p∘(dO·vᵀ − delta), dq = s·dS·k,
    dk = dSᵀ·(q·s). Returns ``dq, dk, dv`` typed like q, k, v."""
    _check_window(causal, window)
    _, _, _, _, d = _bhsd_dims(q, k, v)
    s = _scale(d, scale)
    qs, logits = _plain_logits(q, k, causal, window, s, q_pos_offset)
    p = _probs(logits, lse)
    g32 = g.float()
    dv = p.transpose(-1, -2) @ g32
    delta = (g32 * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (g32 @ v.float().transpose(-1, -2) - delta)
    dk = ds.transpose(-1, -2) @ qs
    dq = s * (ds @ k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the BHSD kernels can read it through its strides
    (contiguous last dimension, 16-byte aligned rows and start), else a
    contiguous copy."""
    elt = t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        (st * elt) % 16 == 0 for st in t.stride()[:3]
    ):
        return t
    return t.contiguous()


def _check_bhsd_kernel_operands(q, k, v, causal, window, *others):
    b, h, sq, skv, d = _bhsd_dims(q, k, v)
    _check_window(causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernels take CUDA tensors, got {q.device}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the flash kernels take bf16 or f32, got {q.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernels take head_dim 64 or 128, got {d}")
    for t in (k, v, *others):
        if t.device != q.device:
            raise ValueError(f"operand on {t.device}, q on {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share a dtype")
    if min(b, h, sq, skv) < 1:
        raise ValueError("the flash kernels take non-empty operands")
    return b, h, sq, skv, d


def _offset(sq: int, skv: int, q_pos_offset: int | None) -> int:
    return skv - sq if q_pos_offset is None else int(q_pos_offset)


def flash_forward_kernel(q, k, v, causal=False, window=None, scale=None, q_pos_offset=None):
    """Launch ``csrc/flash_fwd.cu`` on q's stream. Operands are read through
    their strides (a head-transposed view of a (B, S, H·D) projection needs
    no copy); ``out`` is allocated in q's layout. Returns ``out`` (B, H, Sq,
    D) and ``lse`` (B, H, Sq) f32, like the plain version."""
    b, h, sq, skv, d = _check_bhsd_kernel_operands(q, k, v, causal, window)
    q, k, v = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    _launch_forward("bhsd_fwd", q, k, v, out, lse, causal, window,
                    _offset(sq, skv, q_pos_offset), scale)
    return out, lse


def flash_backward_kernel(q, k, v, out, lse, g, causal=False, window=None, scale=None,
                          q_pos_offset=None):
    """Launch ``csrc/flash_bwd.cu`` on q's stream. ``q_pos_offset`` places q
    row 0 in the key sequence, so a call on a q segment gives that segment's
    dq and its share of dk/dv. Returns ``dq, dk, dv`` in the layouts of q,
    k, v."""
    b, h, sq, skv, d = _check_bhsd_kernel_operands(q, k, v, causal, window, out, lse, g)
    if out.dtype != q.dtype or g.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError("out and g must match q's dtype and lse must be f32")
    if out.shape != q.shape or g.shape != q.shape or tuple(lse.shape) != (b, h, sq):
        raise ValueError("out/g must be shaped like q and lse (B, H, Sq)")
    q, k, v, out, g = (_kernel_layout(t) for t in (q, k, v, out, g))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch_backward("bhsd_bwd", q, k, v, out, g, lse.contiguous(), dq, dk, dv, causal, window,
                     _offset(sq, skv, q_pos_offset), scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """BHSD flash attention with a kernel in each direction: CUDA tensors go
    through ``csrc/flash_fwd.cu`` / ``csrc/flash_bwd.cu``, CPU tensors through
    the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        if _on(q) == "cuda":
            out, lse = flash_forward_kernel(q, k, v, causal, window, scale)
        else:
            out, lse = flash_forward_reference(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        if _on(q) == "cuda":
            grads = flash_backward_kernel(q, k, v, out, lse, g, *ctx.args)
        else:
            grads = flash_backward_reference(q, k, v, out, lse, g, *ctx.args)
        return (*grads, None, None, None)


def flash_attention(q, k, v, causal: bool = False, scale: float | None = None,
                    window: int | None = None):
    """Flash attention on q (B, H, Sq, D) against k, v (B, H, Skv, D);
    returns (B, H, Sq, D), differentiable in q, k and v. Causal masking is
    end-aligned (query i attends keys <= i + Skv - Sq); ``window`` needs
    ``causal``. The JAX function's ``block_q``/``block_kv`` and
    ``interpret`` are TPU arguments and have no counterpart here."""
    _check_window(causal, window)
    _bhsd_dims(q, k, v)
    return FlashAttention.apply(q, k, v, causal, window, scale)
