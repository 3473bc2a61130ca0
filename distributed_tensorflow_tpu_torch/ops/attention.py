"""Attention ops: the dense reference and flash attention — on the packed
qkv projection, on (B, H, S, D) operands and on the (B, S, H, D) activation
layout — with hand-written CUDA kernels for Hopper.

Counterpart of ``distributed_tensorflow_tpu/ops/attention.py``. Semantics
are the JAX package's:

  * causal masking is **end-aligned** — query ``i`` attends keys
    ``<= i + (Skv - Sq)`` — and a ``window`` (causal only) keeps keys in
    ``[p - window + 1, p]`` (the Mistral convention);
  * the packed flash path takes the fused projection ``qkv`` (B, S,
    (H + 2·KV)·dh), columns ``[q | k | v]`` with heads contiguous inside
    each section; under GQA each group of H/KV query heads reads its shared
    kv head's columns;
  * rope tables (1|B, S, dh/2), indexed by position, rotate q and k
    (split-half, f32 arithmetic, rounded to the operand dtype) before the
    softmax scale is folded into q and rounded again — the FlashAttention-2
    convention the Pallas kernels use;
  * the BHSD flash path (:func:`flash_attention`) takes q (B, H, Sq, D) and
    k, v (B, H, Skv, D) already rotated, as the tensor-parallel block hands
    them over; :func:`flash_attention_bshd` the same on (B, S, H, D).

The backward follows the JAX package's dispatch: one fused call while its
whole-sequence dq scratch fits ``_fused_bwd_scratch_limit()`` (the TPU's
VMEM gate, kept so that a shape takes the same route on both), else the
fused call once per q segment (:func:`_fused_segment_rows`), else the
two-pass pair — a dq kernel and a dk/dv kernel. The packed path's long
branch runs the BSHD fused kernel on head views of qkv.

Kernels (``csrc/``): ``flash_fwd.cu`` — one forward on strided (B, H, S, D)
operands behind every layout (K1, K3, K7, and the BSHD probe's K10);
``flash_fwd_sm90.cu`` — the same forward as a warpgroup (wgmma) kernel, with
k rotated once per call under rope, which takes every bf16 call at head_dim
64, 128 or 256 (:func:`forward_kernel`); ``flash_bwd.cu`` — one fused
backward behind every layout (K2, K4, K8) and, with dq compiled out, the
two-pass dk/dv kernel (K6); ``flash_bwd_sm90.cu`` — the same fused
backward, K6 included, as a warpgroup kernel, which takes every bf16 call at
head_dim 64, 128 or 256 (:func:`backward_kernel`; at 256 its two
warpgroups split dK and dV by columns); ``flash_bwd_dq.cu`` — the two-pass
dq kernel (K5), and ``flash_bwd_dq_sm90.cu`` the same as a warpgroup kernel
for bf16 at head_dim 64, 128 or 256 (:func:`backward_dq_kernel`; at 256 its
two warpgroups split S and dP, then dq by columns); ``flash_fwd_pipe.cu`` —
the forward of the pipelining probe (K9, ``tools/pipeline_probe.py``), and
``flash_fwd_pipe_sm90.cu`` the same on the warpgroup forward's skeleton for
bf16 (:func:`pipe_forward_kernel`). So f32 and head_dim 32 run the
plain-design kernels (``flash_fwd.cu``, ``flash_bwd.cu``,
``flash_bwd_dq.cu``), every other bf16 call up to 256 a warpgroup kernel.
Head dims above 256 run the column-group family (``flash_fwd_dstream.cu``,
``flash_bwd_dstream.cu`` with or without dq, ``flash_bwd_dq_dstream.cu``;
bf16 on mma.sync and f32 on FMAs), which takes the head dim at run time: a
block owns 128 output columns and streams q·kᵀ over D in 64-column chunks,
and q and k reach it rotated (and q scale-folded) by a pass, as a rope pair
spans two column groups — except the bf16 forward at 384 and 512, which
``flash_fwd_cols_sm90.cu`` runs as a warpgroup kernel on the same pass
(two warpgroups a block split q·kᵀ's contraction and out's columns, so the
scores are computed once), and bf16 K6 at 384 and 512, which
``flash_bwd_cols_sm90.cu`` runs as a warpgroup kernel (two blocks a kv
tile, each computing the scores once for half of dK's and dV's columns),
and bf16 K5 at 384 and 512, which ``flash_bwd_dq_cols_sm90.cu`` runs as a
warpgroup kernel (a block a q tile computes the scores once, and its two
warpgroups split dq's columns). Each has a plain PyTorch version
(``*_reference``). The kernels are compiled for head_dim 32, 64, 128 and
256 (the pipelining kernels for 64, 128 and 256); any other head_dim up to
256 runs zero-padded to the next of those, and one above 256 to the next
multiple of 128 (:func:`pad_head_dim`). A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises — there is no fallback
between them.

A launch goes through a plan cached per call signature (:class:`_Plan`:
the source, its C function with argtypes set once, the strides array, the
constant arguments and, for packed qkv, the byte offsets of q, k and v), so
a call builds no head views and no ctypes array; the packed wrappers read
q, k and v at their offsets inside qkv.
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
# flash_*: the packed path (K1/K2); bhsd_*: BHSD (K3/K4); bshd_*: the BSHD
# layout and the packed long branch (K7/K8); bwd_dq/bwd_dkv: the two-pass
# pair (K5/K6); pipe_fwd: the pipelining probe's forward (K9);
# probe_bshd_fwd: the BSHD probe's forward (K10).
KERNEL_LAUNCHES = {
    "flash_fwd": 0, "flash_bwd": 0, "bhsd_fwd": 0, "bhsd_bwd": 0,
    "bshd_fwd": 0, "bshd_bwd": 0, "bwd_dq": 0, "bwd_dkv": 0,
    "pipe_fwd": 0, "probe_bshd_fwd": 0,
}
# The same launches by the kernel source (``csrc/<name>.cu``) they ran: a
# forward wrapper's launch runs flash_fwd or flash_fwd_sm90
# (:func:`forward_kernel`), a backward's flash_bwd or flash_bwd_sm90
# (:func:`backward_kernel`), K5's flash_bwd_dq or flash_bwd_dq_sm90
# (:func:`backward_dq_kernel`), K9's flash_fwd_pipe or flash_fwd_pipe_sm90
# (:func:`pipe_forward_kernel`; above head_dim 256 the forward's source);
# above head_dim 256 each direction runs its column-group source
# (*_dstream), except the bf16 forward, K6 and K5 at 384 and 512
# (flash_fwd_cols_sm90, flash_bwd_cols_sm90, flash_bwd_dq_cols_sm90).
SOURCE_LAUNCHES = {
    "flash_fwd": 0, "flash_fwd_sm90": 0, "flash_bwd": 0, "flash_bwd_sm90": 0,
    "flash_bwd_dq": 0, "flash_bwd_dq_sm90": 0, "flash_fwd_pipe": 0, "flash_fwd_pipe_sm90": 0,
    "flash_fwd_dstream": 0, "flash_bwd_dstream": 0, "flash_bwd_dq_dstream": 0,
    "flash_fwd_cols_sm90": 0, "flash_bwd_cols_sm90": 0, "flash_bwd_dq_cols_sm90": 0,
}

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# The head dims the kernels are compiled for; any other dh up to the last
# is zero-padded to the next one (:func:`pad_head_dim`). Above it the
# column-group kernels take any multiple of _DSTREAM_COLS at run time.
_KERNEL_HEAD_DIMS = (32, 64, 128, 256)
_DSTREAM_COLS = 128


def _scale(head_dim: int, scale: float | None) -> float:
    return (1.0 / math.sqrt(head_dim)) if scale is None else float(scale)


def _instance_dim(d: int) -> int:
    """The head dim a kernel runs head_dim ``d`` at: the smallest compiled
    instance that holds it, and above the last one the next multiple of
    128, which the column-group kernels take (320 -> 384, 512 -> 512)."""
    for n in _KERNEL_HEAD_DIMS:
        if d <= n:
            return n
    return -(-d // _DSTREAM_COLS) * _DSTREAM_COLS


def pad_head_dim(t: torch.Tensor, dp: int) -> torch.Tensor:
    """``t`` (..., d) zero-padded to (..., dp), contiguous. An even d is
    padded half by half, ``[x1 | 0 | x2 | 0]``, so that column i still
    pairs with column i + dp/2 under the kernels' split-half rope; an odd d
    (no rope) at the tail. ``t`` itself when d == dp."""
    d = t.shape[-1]
    if d == dp:
        return t
    if d % 2:
        return torch.nn.functional.pad(t, (0, dp - d))
    z = dp // 2 - d // 2
    return torch.cat([torch.nn.functional.pad(x, (0, z)) for x in t.split(d // 2, dim=-1)],
                     dim=-1)


def unpad_head_dim(t: torch.Tensor, d: int) -> torch.Tensor:
    """The real columns of a :func:`pad_head_dim` result: (..., dp) ->
    (..., d)."""
    dp = t.shape[-1]
    if d == dp:
        return t
    if d % 2:
        return t[..., :d]
    return torch.cat([t[..., :d // 2], t[..., dp // 2:dp // 2 + d // 2]], dim=-1)


def pad_rope_tables(cos, sin, dp: int):
    """Rope tables (1|B, S, d/2) widened to (1|B, S, dp/2) for operands
    padded by :func:`pad_head_dim`: the padded pairs rotate by angle 0 (cos
    1, sin 0). ``(None, None)`` passes through."""
    if cos is None:
        return None, None
    z = dp // 2 - cos.shape[-1]
    return (torch.nn.functional.pad(cos, (0, z), value=1.0).contiguous(),
            torch.nn.functional.pad(sin, (0, z)).contiguous())


def _offset(sq: int, skv: int, q_pos_offset: int | None) -> int:
    return skv - sq if q_pos_offset is None else int(q_pos_offset)


def _mask(sq: int, skv: int, causal: bool, window: int | None, device,
          q_pos_offset: int | None = None):
    """(sq, skv) bool, True = attend; None when nothing is masked. Query row
    i sits at position i + q_pos_offset (default skv - sq: end-aligned)."""
    if not causal:
        return None
    q_pos = torch.arange(sq, device=device)[:, None] + _offset(sq, skv, q_pos_offset)
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
# The backward's route gate: the JAX package's, so that a shape takes the
# same route on both. The gate is sized for the TPU kernel's VMEM dq
# scratch; the CUDA kernels have no such limit, but which counterpart runs
# follows it. Tiles stay the port's own.
# ---------------------------------------------------------------------------

# None = the JAX default under its default VMEM budget (2 MiB); tests (and
# callers wanting a fixed gate) may set a byte count here.
_FUSED_BWD_SCRATCH_LIMIT: int | None = None
_STAT_LANES = 128  # the TPU kernels' lane-padded statistic rows
_GATE_BLOCK = 1024  # the JAX functions' default block_q, which the gate fits


def _fused_bwd_scratch_limit() -> int:
    if _FUSED_BWD_SCRATCH_LIMIT is not None:
        return _FUSED_BWD_SCRATCH_LIMIT
    return 2 * 1024 * 1024


def _dq_scratch_bytes_per_row(d: int) -> int:
    # f32 dq row (lane dim padded to a multiple of 128) + f32 delta row.
    return -(-d // 128) * 128 * 4 + _STAT_LANES * 4


def _fit_block(requested: int, seq: int) -> int:
    """Largest block ≤ requested that divides seq and is a multiple of 8,
    else the whole sequence."""
    for b in range(min(requested, seq), 7, -1):
        if seq % b == 0 and b % 8 == 0:
            return b
    return seq


def _fused_segment_rows(sq: int, d: int, block_q: int) -> int | None:
    """Largest q-segment length whose f32 dq scratch fits the limit: a
    multiple of ``block_q`` that divides ``sq`` evenly. None when no such
    segmentation exists (the two-pass kernels run instead)."""
    max_rows = _fused_bwd_scratch_limit() // _dq_scratch_bytes_per_row(d)
    if block_q > max_rows:
        return None
    for n_seg in range(-(-sq // max_rows), sq + 1):  # smallest count first
        if sq % n_seg:
            continue
        seg = sq // n_seg
        if seg <= max_rows and seg % block_q == 0:
            return seg
    return None


def _segment_rows(sq: int, d: int) -> int | None:
    """The backward's route for ``sq`` query rows of head_dim ``d``: ``sq``
    (one fused call), a segment length (one fused call per q segment), or
    None (the two-pass pair)."""
    if sq * _dq_scratch_bytes_per_row(d) <= _fused_bwd_scratch_limit():
        return sq
    return _fused_segment_rows(sq, d, _fit_block(_GATE_BLOCK, sq))


# ---------------------------------------------------------------------------
# Plain versions of the kernels, on (B, H, S, D) views: k and v may carry
# fewer (kv) heads, each shared by a group of H/KV query heads, and rope
# tables rotate q rows at their positions (row + q_pos_offset) and k rows at
# theirs.
# ---------------------------------------------------------------------------


def _bhsd_dims(q, k, v) -> tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, head_dim)")
    b, h, sq, d = q.shape
    kv = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or kv < 1 or h % kv:
        raise ValueError(
            f"k and v must be (B, KV, Skv, head_dim) with KV dividing H, matching q "
            f"{tuple(q.shape)}, got {tuple(k.shape)} and {tuple(v.shape)}"
        )
    return b, h, sq, k.shape[2], d


def _rotate(t, cos, sin, start: int, inverse: bool = False):
    """``t`` (B, n, S, D) rotated by the tables' rows [start, start + S) —
    by the inverse rotation with ``inverse`` — in f32, returned in t's
    dtype; ``t`` itself without tables."""
    if cos is None:
        return t
    rows = slice(start, start + t.shape[2])
    sin = -sin if inverse else sin
    return apply_rope(t.transpose(1, 2), cos[:, rows], sin[:, rows]).transpose(1, 2)


def _plain_front(q, k, v, causal, window, s, off, cos, sin):
    """The plain versions' shared front, in f32: q rotated and
    scale-folded, k rotated, each rounded to its dtype as the kernels round
    them; k and v with their heads repeated to q's; the masked logits."""
    group = q.shape[1] // k.shape[1]
    q, k = _rotate(q, cos, sin, off), _rotate(k, cos, sin, 0)
    qs = (q.float() * s).to(q.dtype).float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = qs @ kf.transpose(-1, -2)
    mask = _mask(q.shape[2], k.shape[2], causal, window, q.device, off)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    return qs, kf, vf, logits


def _probs(logits, lse):
    # A row that attended nothing has lse ~ NEG_INF, which is finite, so
    # exp(logit - lse) would be 1 on its masked logits: zero it, as the
    # Pallas kernels do.
    return torch.where(lse[..., None] <= NEG_INF / 2, 0.0, torch.exp(logits - lse[..., None]))


def rotate_k_reference(k, cos, sin):
    """Plain version of the forward's rotate pass (``flash_fwd_rotate_k``):
    ``k`` (B, KV, Skv, D) with row r rotated by the tables' row r (f32,
    rounded to k's dtype), contiguous. The warpgroup forward rotates k once a
    call this way and q in its blocks: :func:`flash_forward_reference` on the
    rotated q and k without tables equals it with them, bit for bit."""
    return _rotate(k, cos, sin, 0).contiguous()


def flash_forward_reference(q, k, v, causal=False, window=None, scale=None,
                            q_pos_offset=None, cos=None, sin=None):
    """Plain version of the forward kernel: q rotated (rope tables, f32) and
    scale-folded, kv heads repeated, dense masked softmax in f32. Returns
    ``out`` (B, H, Sq, D) in q's dtype — 0 on rows that attend nothing — and
    ``lse`` (B, H, Sq) f32, the row logsumexp (NEG_INF on such rows)."""
    _check_window(causal, window)
    _, _, sq, skv, d = _bhsd_dims(q, k, v)
    _, _, vf, logits = _plain_front(q, k, v, causal, window, _scale(d, scale),
                                    _offset(sq, skv, q_pos_offset), cos, sin)
    lse = torch.logsumexp(logits, dim=-1)
    out = _probs(logits, lse) @ vf
    return out.to(q.dtype), lse


def _plain_backward(q, k, v, out, lse, g, causal, window, scale, q_pos_offset, cos, sin,
                    want_dq=True, want_dkv=True):
    """The explicit backward in f32: p from the saved lse (0 on rows that
    attended nothing), delta = rowsum(dO∘O), dv = pᵀ·dO, dS = p∘(dO·vᵀ −
    delta), dq = s·dS·k, dk = dSᵀ·(q·s); dk/dv summed over each kv head's
    query group, dq and dk rotated back by the inverse rope. Returns the
    asked-for grads, typed like q, k, v."""
    _check_window(causal, window)
    b, h, sq, skv, d = _bhsd_dims(q, k, v)
    kv, s, off = k.shape[1], _scale(d, scale), _offset(sq, skv, q_pos_offset)
    qs, kf, vf, logits = _plain_front(q, k, v, causal, window, s, off, cos, sin)
    p = _probs(logits, lse)
    g32 = g.float()
    delta = (g32 * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (g32 @ vf.transpose(-1, -2) - delta)
    grads = []
    if want_dq:
        grads.append(_rotate(s * (ds @ kf), cos, sin, off, inverse=True).to(q.dtype))
    if want_dkv:
        def group_sum(t):  # (B, H, Skv, D) per query head -> (B, KV, Skv, D)
            return t.reshape(b, kv, h // kv, skv, d).sum(dim=2)

        dk = _rotate(group_sum(ds.transpose(-1, -2) @ qs), cos, sin, 0, inverse=True)
        grads += [dk.to(k.dtype), group_sum(p.transpose(-1, -2) @ g32).to(v.dtype)]
    return grads


def flash_backward_reference(q, k, v, out, lse, g, causal=False, window=None, scale=None,
                             q_pos_offset=None, cos=None, sin=None):
    """Plain version of the fused backward kernel (K2/K4/K8). Returns
    ``dq, dk, dv`` typed like q, k, v."""
    return tuple(_plain_backward(q, k, v, out, lse, g, causal, window, scale, q_pos_offset,
                                 cos, sin))


def flash_backward_dq_reference(q, k, v, out, lse, g, causal=False, window=None, scale=None,
                                q_pos_offset=None, cos=None, sin=None):
    """Plain version of the two-pass dq kernel (K5). Returns ``dq``."""
    return _plain_backward(q, k, v, out, lse, g, causal, window, scale, q_pos_offset, cos, sin,
                           want_dkv=False)[0]


def flash_backward_dkv_reference(q, k, v, out, lse, g, causal=False, window=None, scale=None,
                                 q_pos_offset=None, cos=None, sin=None):
    """Plain version of the two-pass dk/dv kernel (K6). Returns ``dk, dv``."""
    return tuple(_plain_backward(q, k, v, out, lse, g, causal, window, scale, q_pos_offset,
                                 cos, sin, want_dq=False))


# ---------------------------------------------------------------------------
# Packed-qkv flash self-attention: shapes, plain versions.
# ---------------------------------------------------------------------------


def _qkv_dims(qkv: torch.Tensor, h: int, kv: int) -> tuple[int, int, int, int]:
    return _packed_dims(qkv.shape, h, kv)


def _packed_dims(shape, h: int, kv: int) -> tuple[int, int, int, int]:
    """B, S, width and head_dim of packed qkv of ``shape``."""
    if len(shape) != 3:
        raise ValueError(f"qkv must be (B, S, (H + 2*KV)*head_dim), got {tuple(shape)}")
    b, sq, width = shape
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


def _heads(t: torch.Tensor, d: int) -> torch.Tensor:
    """The (B, n, S, d) view of the heads of a (B, S, n·d) tensor: no copy."""
    return t.unflatten(-1, (-1, d)).transpose(1, 2)


def _packed_heads(qkv: torch.Tensor, h: int, kv: int, d: int):
    """q, k, v as head views of qkv's column sections."""
    return tuple(_heads(t, d) for t in qkv.split([h * d, kv * d, kv * d], dim=-1))


def _unheads(t: torch.Tensor) -> torch.Tensor:
    """(B, n, S, d) -> (B, S, n·d)."""
    return t.transpose(1, 2).flatten(2)


def flash_forward_qkv_reference(qkv, num_heads, num_kv_heads=None, causal=False,
                                window=None, rope_cos=None, rope_sin=None,
                                rope_theta=None, scale=None):
    """Plain version of the packed forward kernel: the plain forward on
    head views of qkv. Returns ``out`` (B, S, H·dh) in qkv's dtype and
    ``lse`` (B, H, S) f32, the row logsumexp."""
    h = num_heads
    kv = h if num_kv_heads is None else num_kv_heads
    _check_window(causal, window)
    _, _, _, d = _qkv_dims(qkv, h, kv)
    cos, sin = rope_operands(qkv, d, rope_cos, rope_sin, rope_theta)
    out, lse = flash_forward_reference(*_packed_heads(qkv, h, kv, d), causal, window, scale, 0,
                                       cos, sin)
    return _unheads(out), lse


def flash_backward_qkv_reference(qkv, out, lse, g, num_heads, num_kv_heads=None,
                                 causal=False, window=None, rope_cos=None,
                                 rope_sin=None, rope_theta=None, scale=None):
    """Plain version of the packed backward kernel: the plain fused backward
    on head views of qkv (dq and dk rotated back by the inverse rope, each
    GQA group's kv grads summed into its shared kv head). Returns dqkv
    shaped and typed like qkv."""
    h = num_heads
    kv = h if num_kv_heads is None else num_kv_heads
    _check_window(causal, window)
    _, _, _, d = _qkv_dims(qkv, h, kv)
    cos, sin = rope_operands(qkv, d, rope_cos, rope_sin, rope_theta)
    grads = flash_backward_reference(*_packed_heads(qkv, h, kv, d), _heads(out, d), lse,
                                     _heads(g, d), causal, window, scale, 0, cos, sin)
    return torch.cat([_unheads(t) for t in grads], dim=-1)


# ---------------------------------------------------------------------------
# The CUDA kernels' launches: one cached plan per call signature.
# ---------------------------------------------------------------------------

_FWD_ARGTYPES = (
    [ctypes.c_void_p] * 8  # q, k, v, out, lse, cos, sin, strides
    + [ctypes.c_int] * 10  # B, H, KV, Sq, Skv, D, is_bf16, causal, window, q_pos_offset
    + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]  # table stride, scale, stream
)
_FWD90_ARGTYPES = _FWD_ARGTYPES[:-1] + [ctypes.c_void_p, ctypes.c_void_p]  # + k_rot scratch
_PIPE_FWD_ARGTYPES = (
    [ctypes.c_void_p] * 6  # q, k, v, out, lse, strides
    + [ctypes.c_int] * 8  # B, H, Sq, Skv, D, is_bf16, causal, q_pos_offset
    + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
)
_BWD_ARGTYPES = (
    # q, k, v, out, dout, lse, cos, sin, dq, dk, dv, dq_acc, delta, strides
    [ctypes.c_void_p] * 14
    + [ctypes.c_int] * 10
    + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
)
_BWD_DQ_ARGTYPES = (
    # q, k, v, dout, lse, delta, cos, sin, dq, strides
    [ctypes.c_void_p] * 10
    + [ctypes.c_int] * 10
    + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
)
_BWD_DQ90_ARGTYPES = _BWD_DQ_ARGTYPES[:-1] + [ctypes.c_void_p, ctypes.c_void_p]  # + k_rot
# The column-group sources add their scratches before the stream: q_s and
# k_rot (forward); q_s, k_rot and the f32 dk sum (fused backward); q_s, k_rot
# and the f32 dq sum (K5).
_FWD_DS_ARGTYPES = _FWD_ARGTYPES[:-1] + [ctypes.c_void_p] * 3
_BWD_DS_ARGTYPES = _BWD_ARGTYPES[:-1] + [ctypes.c_void_p] * 4
_BWD_DQ_DS_ARGTYPES = _BWD_DQ_ARGTYPES[:-1] + [ctypes.c_void_p] * 4
# Each source's C signature.
_SOURCE_ARGTYPES = {
    "flash_fwd": _FWD_ARGTYPES, "flash_fwd_sm90": _FWD90_ARGTYPES,
    "flash_fwd_dstream": _FWD_DS_ARGTYPES, "flash_fwd_cols_sm90": _FWD_DS_ARGTYPES,
    "flash_fwd_pipe": _PIPE_FWD_ARGTYPES, "flash_fwd_pipe_sm90": _PIPE_FWD_ARGTYPES,
    "flash_bwd": _BWD_ARGTYPES, "flash_bwd_sm90": _BWD_ARGTYPES,
    "flash_bwd_dstream": _BWD_DS_ARGTYPES, "flash_bwd_cols_sm90": _BWD_DS_ARGTYPES,
    "flash_bwd_dq": _BWD_DQ_ARGTYPES, "flash_bwd_dq_sm90": _BWD_DQ90_ARGTYPES,
    "flash_bwd_dq_dstream": _BWD_DQ_DS_ARGTYPES, "flash_bwd_dq_cols_sm90": _BWD_DQ_DS_ARGTYPES,
}
# The sources that take the column-group prepare pass's scratches.
_PREP_SOURCES = ("flash_fwd_dstream", "flash_fwd_cols_sm90", "flash_bwd_dstream",
                 "flash_bwd_cols_sm90", "flash_bwd_dq_dstream", "flash_bwd_dq_cols_sm90")

_FNS: dict = {}


def _kernel_fn(source: str):
    """``dtt_<source>`` of ``csrc/<source>.cu``: the library is built and
    loaded at the first call, and its argtypes are set then, once."""
    fn = _FNS.get(source)
    if fn is None:
        fn = getattr(_build.load(source), f"dtt_{source}")
        fn.argtypes = _SOURCE_ARGTYPES[source]
        fn.restype = ctypes.c_int
        _FNS[source] = fn
    return fn


def _table_stride(cos) -> int:
    return 0 if cos is None or cos.shape[0] == 1 else cos.shape[1] * cos.shape[2]


def _strides(*tensors) -> list[int]:
    """The (b, h, s) element strides of each 4-D operand, in order."""
    return [st for t in tensors for st in t.stride()[:3]]


def _dims(q, k):
    """B, H, KV, Sq, Skv, D of (B, H, Sq, D) q against (B, KV, Skv, D) k."""
    b, h, sq, d = q.shape
    return b, h, k.shape[1], sq, k.shape[2], d


class _Plan:
    """The launch of one call signature: the source that runs it; the (b, h,
    s) element strides of its strided operands (``stride_values``) and the
    same as the kernels' host array; the byte offsets of operands read
    inside one packed tensor (q, k and v in qkv, and dq, dk and dv in dqkv
    alike); the arguments between the strides and the scratch pointers;
    the scratch the source takes, each as (shape, dtype) or None; and for a
    packed call at a head dim between the instances, (d, instance). Built
    from shapes alone: no card is needed until the launch, which builds and
    loads the library."""

    __slots__ = ("source", "stride_values", "strides", "offsets", "args", "scratch", "pad")

    def __init__(self, source, stride_values, args, scratch=(), offsets=(), pad=None):
        self.source = source
        self.stride_values = tuple(stride_values)
        self.strides = (ctypes.c_longlong * len(self.stride_values))(*self.stride_values)
        self.args = (ctypes.addressof(self.strides), *args)
        self.scratch = scratch
        self.offsets = tuple(offsets)
        self.pad = pad


# At most this many plans are kept; the oldest goes first.
PLAN_CACHE_SIZE = 256
_PLANS: dict = {}


def _cached_plan(key, build) -> _Plan:
    """The plan of call signature ``key``, made by ``build()`` on a miss."""
    plan = _PLANS.get(key)
    if plan is None:
        plan = build()
        while len(_PLANS) >= PLAN_CACHE_SIZE:
            del _PLANS[next(iter(_PLANS))]
        _PLANS[key] = plan
    return plan


def _scratch_specs(source, dtype, b, h, kv, sq, skv, d, rope):
    """The scratch ``source`` takes before the stream, as (shape, dtype) or
    None: the warpgroup forward's (and K5's) k rotated under rope; the
    column-group sources' q rotated and scale-folded, k rotated under rope,
    and the fused backward's (or K5's) f32 dk (dq) sum."""
    k_rot = ((b, kv, skv, d), dtype) if rope else None
    if source in ("flash_fwd_sm90", "flash_bwd_dq_sm90"):
        return (k_rot,)
    if source in _PREP_SOURCES:
        specs = (((b, h, sq, d), dtype), k_rot)
        if source.startswith("flash_bwd_dq"):
            return specs + (((b, h, sq, d), torch.float32),)
        if source.startswith("flash_bwd"):
            return specs + (((b, kv, skv, d), torch.float32),)
        return specs
    return ()


def _common_args(dtype, b, h, kv, sq, skv, d, causal, window, off, tstride, scale):
    return (b, h, kv, sq, skv, d, int(dtype == torch.bfloat16), int(causal), window or 0, off,
            tstride, scale)


def _view_plan(source, q, k, operands, causal, window, off, scale, cos):
    """The plan of a launch on (B, H, S, D) views: ``operands`` are the
    strided operands in the order of the source's strides array."""
    dims = _dims(q, k)
    return _Plan(source, _strides(*operands),
                 _common_args(q.dtype, *dims, causal, window, off, _table_stride(cos), scale),
                 _scratch_specs(source, q.dtype, *dims, cos is not None))


def _view_key(kind, source, q, k, operands, causal, window, off, scale, cos):
    return (kind, source, q.dtype, q.shape, k.shape, *(t.stride() for t in operands), causal,
            window, off, scale, None if cos is None else cos.shape[0])


def _alloc(specs, device):
    return [None if s is None else torch.empty(s[0], dtype=s[1], device=device) for s in specs]


def _run(plan, counter, device, ptrs, scratch=()) -> None:
    """Launch ``plan``'s kernel on the current stream of card ``device`` (its
    index) with operand pointers ``ptrs`` and the ``scratch`` tensors (held
    until the launch returns), counting the launch under
    ``KERNEL_LAUNCHES[counter]`` and its source; raises if it failed. The
    card is made current only where it is not."""
    fn = _kernel_fn(plan.source)
    extra = [None if t is None else t.data_ptr() for t in scratch]
    if device == torch.cuda.current_device():
        status = fn(*ptrs, *plan.args, *extra, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            status = fn(*ptrs, *plan.args, *extra, torch._C._cuda_getCurrentRawStream(device))
    KERNEL_LAUNCHES[counter] += 1
    SOURCE_LAUNCHES[plan.source] += 1
    if status != 0:
        raise RuntimeError(f"{counter} kernel launch failed: CUDA error {status}")


def _ptr(t):
    return None if t is None else t.data_ptr()


# The instances the warpgroup forward, fused backward and two-pass dq kernel
# are compiled for; above them, the bf16 forward's and K6's warpgroup
# instances.
_SM90_HEAD_DIMS = (64, 128, 256)
_COLS90_HEAD_DIMS = (384, 512)


def forward_kernel(dtype: torch.dtype, d: int) -> str:
    """The source of the forward kernel that runs a call: bf16 at head_dim
    384 or 512 goes to the warpgroup (wgmma) kernel
    ``csrc/flash_fwd_cols_sm90.cu`` (two warpgroups a block, each summing
    half of q·kᵀ's contraction and owning half of out's columns); any other
    head_dim above 256 to the column-group kernel
    ``csrc/flash_fwd_dstream.cu`` in either dtype; bf16 at head_dim 64, 128
    or 256 to the warpgroup kernel ``csrc/flash_fwd_sm90.cu`` (two
    warpgroups a block at 256); f32 and head_dim 32 stay on
    ``csrc/flash_fwd.cu``. ``d`` is the instance the call runs at (after
    padding)."""
    if dtype == torch.bfloat16 and d in _COLS90_HEAD_DIMS:
        return "flash_fwd_cols_sm90"
    if d > _KERNEL_HEAD_DIMS[-1]:
        return "flash_fwd_dstream"
    if dtype == torch.bfloat16 and d in _SM90_HEAD_DIMS:
        return "flash_fwd_sm90"
    return "flash_fwd"


def _launch_forward(counter, q, k, v, out, lse, causal, window, q_pos_offset, scale,
                    cos=None, sin=None, k_rot=None) -> None:
    """Launch the forward on q's stream (:func:`forward_kernel` picks the
    source): q, out (B, H, Sq, D) and k, v (B, KV, Skv, D) views with a
    contiguous last dimension, lse (B, H, Sq) f32; rope tables (1|B, Skv,
    D/2) f32 read at each row's position. Under rope the warpgroup kernel
    first rotates k once into ``k_rot``, a contiguous (B, KV, Skv, D) scratch
    (allocated here unless given), and reads k from there. A head dim between
    the kernel's instances runs zero-padded to the next one, at the scale of
    the real one. Above head_dim 256 both sources take the prepare pass's
    scratches (q rotated and scale-folded, k rotated), allocated here. The
    launch counts under ``KERNEL_LAUNCHES[counter]``."""
    d, scale = q.shape[-1], _scale(q.shape[-1], scale)
    dp = _instance_dim(d)
    if dp != d:
        out_p = torch.empty(*q.shape[:3], dp, dtype=q.dtype, device=q.device)
        _launch_forward(counter, *(pad_head_dim(t, dp) for t in (q, k, v)), out_p, lse, causal,
                        window, q_pos_offset, scale, *pad_rope_tables(cos, sin, dp))
        out.copy_(unpad_head_dim(out_p, d))
        return
    source, device = forward_kernel(q.dtype, d), q.get_device()
    operands = (q, k, v, out)
    plan = _cached_plan(
        _view_key("fwd", source, q, k, operands, causal, window, q_pos_offset, scale, cos),
        lambda: _view_plan(source, q, k, operands, causal, window, q_pos_offset, scale, cos))
    scratch = _alloc(plan.scratch, device)
    if k_rot is not None and source == "flash_fwd_sm90":
        scratch[0] = k_rot
    _run(plan, counter, device,
         (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), _ptr(cos),
          _ptr(sin)), scratch)


# The instances the pipelining probe's kernels are compiled for.
_PIPE_HEAD_DIMS = (64, 128, 256)


def _pipe_instance_dim(d: int) -> int:
    """The head dim K9 runs head_dim ``d`` at: the next of 64, 128 and 256;
    above 256 the forward's instance (:func:`_instance_dim`)."""
    for n in _PIPE_HEAD_DIMS:
        if d <= n:
            return n
    return _instance_dim(d)


def pipe_forward_kernel(dtype: torch.dtype, d: int) -> str:
    """The source of the pipelining probe's kernel (K9) that runs a call at
    instance ``d`` (after padding): at head_dim 64, 128 and 256 bf16 goes to
    the warpgroup (wgmma) kernel ``csrc/flash_fwd_pipe_sm90.cu`` (two
    warpgroups a block and 32-key tiles at 256), f32 to
    ``csrc/flash_fwd_pipe.cu``; above 256, where the pipelined order is not
    built, the forward's source (:func:`forward_kernel`)."""
    if d > _PIPE_HEAD_DIMS[-1]:
        return forward_kernel(dtype, d)
    if dtype == torch.bfloat16:
        return "flash_fwd_pipe_sm90"
    return "flash_fwd_pipe"


def _launch_pipe_forward(q, k, v, out, lse, causal, q_pos_offset, scale) -> None:
    """Launch K9 on q's stream (:func:`pipe_forward_kernel` picks the
    source): q, out (B, H, Sq, D) and k, v (B, H, Skv, D) views with a
    contiguous last dimension, lse (B, H, Sq) f32. Any head_dim up to 256
    runs zero-padded to the next instance (64, 128 or 256) at the real head
    dim's scale; the probe has no rope. Above 256 the pipelined order is not
    built: the call runs the shipped forward (:func:`_launch_forward`) at
    that head dim. The launch counts under ``KERNEL_LAUNCHES["pipe_fwd"]``
    and under the source that ran."""
    b, h, sq, d = q.shape
    scale = _scale(d, scale)
    if d > _PIPE_HEAD_DIMS[-1]:
        _launch_forward("pipe_fwd", q, k, v, out, lse, causal, None, q_pos_offset, scale)
        return
    dp = _pipe_instance_dim(d)
    if dp != d:
        out_p = torch.empty(b, h, sq, dp, dtype=q.dtype, device=q.device)
        _launch_pipe_forward(*(pad_head_dim(t, dp) for t in (q, k, v)), out_p, lse, causal,
                             q_pos_offset, scale)
        out.copy_(unpad_head_dim(out_p, d))
        return
    source, device = pipe_forward_kernel(q.dtype, d), q.get_device()
    operands = (q, k, v, out)
    plan = _cached_plan(
        _view_key("pipe", source, q, k, operands, causal, None, q_pos_offset, scale, None),
        lambda: _Plan(source, _strides(*operands),
                      (b, h, sq, k.shape[2], d, int(q.dtype == torch.bfloat16), int(causal),
                       q_pos_offset, scale)))
    _run(plan, "pipe_fwd", device,
         (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr()))


def backward_kernel(dtype: torch.dtype, d: int, want_dq: bool) -> str:
    """The source of the fused backward kernel that runs a call: bf16 at
    head_dim 384 or 512 without dq (the two-pass pair's dk/dv half, K6) goes
    to the warpgroup (wgmma) kernel ``csrc/flash_bwd_cols_sm90.cu`` (two
    blocks a 64-row kv tile, each owning half of dK's and dV's columns and
    computing the scores once for them); any other call above head_dim 256
    to the column-group kernel ``csrc/flash_bwd_dstream.cu`` in either
    dtype, with dq (K2/K4/K8) or without; bf16 at head_dim 64, 128 or 256 to
    the warpgroup kernel ``csrc/flash_bwd_sm90.cu`` (at 256 a 64-row kv tile
    a block, dK and dV split by columns over its two warpgroups), with dq or
    without (K6, which compiles the dQ product out); f32 and head_dim 32
    stay on ``csrc/flash_bwd.cu``. ``d`` is the instance the call runs at
    (after padding)."""
    if dtype == torch.bfloat16 and d in _COLS90_HEAD_DIMS and not want_dq:
        return "flash_bwd_cols_sm90"
    if d > _KERNEL_HEAD_DIMS[-1]:
        return "flash_bwd_dstream"
    if dtype == torch.bfloat16 and d in _SM90_HEAD_DIMS:
        return "flash_bwd_sm90"
    return "flash_bwd"


def _launch_backward(counter, q, k, v, out, g, lse, dq, dk, dv, causal, window,
                     q_pos_offset, scale, cos=None, sin=None, delta=None) -> None:
    """Launch the fused backward on q's stream — a delta pre-pass, the
    kv-tile kernel (dk/dv in registers, GQA group sums included, dq by f32
    atomics into a scratch allocated here) and the dq rotate-back/cast pass —
    writing dq, dk, dv through their strides; :func:`backward_kernel` picks
    the source. With ``dq`` None only dk and dv are computed (the two-pass
    pair's K6) and ``delta`` (B, H, Sq) f32 is left for its dq kernel. A
    head dim between the instances runs zero-padded, as in
    :func:`_launch_forward`."""
    b, h, sq, d = q.shape
    scale = _scale(d, scale)
    dp = _instance_dim(d)
    if dp != d:
        grads_p = [None if t is None else
                   torch.empty(*t.shape[:3], dp, dtype=t.dtype, device=t.device)
                   for t in (dq, dk, dv)]
        _launch_backward(counter, *(pad_head_dim(t, dp) for t in (q, k, v, out, g)), lse,
                         *grads_p, causal, window, q_pos_offset, scale,
                         *pad_rope_tables(cos, sin, dp), delta=delta)
        for t, t_p in zip((dq, dk, dv), grads_p):
            if t is not None:
                t.copy_(unpad_head_dim(t_p, d))
        return
    source, device = backward_kernel(q.dtype, d, dq is not None), q.get_device()
    operands = (q, k, v, out, g, dk if dq is None else dq, dk, dv)
    plan = _cached_plan(
        _view_key("bwd", source, q, k, operands, causal, window, q_pos_offset, scale, cos),
        lambda: _view_plan(source, q, k, operands, causal, window, q_pos_offset, scale, cos))
    dq_acc = None
    if dq is not None:
        dq_acc = torch.empty(b, h, sq, d, dtype=torch.float32, device=device)
    if delta is None:
        delta = torch.empty(b, h, sq, dtype=torch.float32, device=device)
    _run(plan, counter, device,
         (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
          lse.data_ptr(), _ptr(cos), _ptr(sin), _ptr(dq), dk.data_ptr(), dv.data_ptr(),
          _ptr(dq_acc), delta.data_ptr()), _alloc(plan.scratch, device))


def backward_dq_kernel(dtype: torch.dtype, d: int) -> str:
    """The source of the two-pass dq kernel (K5) that runs a call: bf16 at
    head_dim 384 or 512 goes to the warpgroup (wgmma) kernel
    ``csrc/flash_bwd_dq_cols_sm90.cu`` (a block a 64-row q tile, S in one
    warpgroup and dP in the other, computed once for all of dq's columns,
    which the two split); any other call above head_dim 256 to the
    column-group kernel ``csrc/flash_bwd_dq_dstream.cu`` in either dtype;
    bf16 at head_dim 64, 128 or 256 to the warpgroup kernel
    ``csrc/flash_bwd_dq_sm90.cu`` (at 256 two warpgroups a block, S in one
    and dP in the other, dq split by columns); f32 and head_dim 32 stay on
    ``csrc/flash_bwd_dq.cu``. ``d`` is the instance the call runs at (after
    padding)."""
    if dtype == torch.bfloat16 and d in _COLS90_HEAD_DIMS:
        return "flash_bwd_dq_cols_sm90"
    if d > _KERNEL_HEAD_DIMS[-1]:
        return "flash_bwd_dq_dstream"
    if dtype == torch.bfloat16 and d in _SM90_HEAD_DIMS:
        return "flash_bwd_dq_sm90"
    return "flash_bwd_dq"


def _launch_backward_dq(q, k, v, g, lse, delta, dq, causal, window, q_pos_offset, scale,
                        cos=None, sin=None) -> None:
    """Launch K5 on q's stream (:func:`backward_dq_kernel` picks the
    source): dq in registers over the kv loop, written once through dq's
    strides; ``delta`` as the dk/dv launch wrote it; a head dim between the
    instances runs zero-padded. Under rope the warpgroup kernel first
    rotates k once into a contiguous (B, KV, Skv, D) scratch allocated here.
    Counts under ``KERNEL_LAUNCHES["bwd_dq"]``."""
    d, scale = q.shape[-1], _scale(q.shape[-1], scale)
    dp = _instance_dim(d)
    if dp != d:
        dq_p = torch.empty(*dq.shape[:3], dp, dtype=dq.dtype, device=dq.device)
        _launch_backward_dq(*(pad_head_dim(t, dp) for t in (q, k, v, g)), lse, delta, dq_p,
                            causal, window, q_pos_offset, scale, *pad_rope_tables(cos, sin, dp))
        dq.copy_(unpad_head_dim(dq_p, d))
        return
    source, device = backward_dq_kernel(q.dtype, d), q.get_device()
    operands = (q, k, v, g, dq)
    plan = _cached_plan(
        _view_key("bwd_dq", source, q, k, operands, causal, window, q_pos_offset, scale, cos),
        lambda: _view_plan(source, q, k, operands, causal, window, q_pos_offset, scale, cos))
    _run(plan, "bwd_dq", device,
         (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
          delta.data_ptr(), _ptr(cos), _ptr(sin), dq.data_ptr()), _alloc(plan.scratch, device))


# ---------------------------------------------------------------------------
# The backward's routes, on (B, H, S, D) views with preallocated outputs.
# ---------------------------------------------------------------------------


def _backward(counter, q, k, v, out, g, lse, dq, dk, dv, causal, window, off, scale,
              cos=None, sin=None) -> None:
    """One fused backward of the q rows placed at ``off`` (K2, K4 or K8:
    ``counter`` names it) into dq, dk and dv: the kernel for CUDA tensors,
    the plain version for CPU ones."""
    if q.device.type == "cuda":
        _launch_backward(counter, q, k, v, out, g, lse, dq, dk, dv, causal, window, off, scale,
                         cos, sin)
        return
    grads = flash_backward_reference(q, k, v, out, lse, g, causal, window, scale, off, cos, sin)
    for t, r in zip((dq, dk, dv), grads):
        t.copy_(r)


def _backward_two_pass(q, k, v, out, g, lse, dq, dk, dv, causal, window, off, scale,
                       cos=None, sin=None) -> None:
    """The two-pass pair into dq, dk and dv: K6 (dk, dv and delta) then K5
    (dq) for CUDA tensors, their plain versions for CPU ones."""
    if q.device.type == "cuda":
        delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
        _launch_backward("bwd_dkv", q, k, v, out, g, lse, None, dk, dv, causal, window, off,
                         scale, cos, sin, delta=delta)
        _launch_backward_dq(q, k, v, g, lse, delta, dq, causal, window, off, scale, cos, sin)
        return
    args = (q, k, v, out, lse, g, causal, window, scale, off, cos, sin)
    dq.copy_(flash_backward_dq_reference(*args))
    for t, r in zip((dk, dv), flash_backward_dkv_reference(*args)):
        t.copy_(r)


def _route_backward(whole, segment, sq, d, views, causal, window, off, scale, cos=None,
                    sin=None) -> None:
    """The JAX package's backward dispatch (``_flash_backward``,
    ``_flash_backward_bshd`` and ``_flash_backward_qkv``) for ``sq`` q rows
    of head dim ``d``: ``whole()``, one fused call on the caller's own
    layout, while :func:`_segment_rows` allows it; else, on ``views()`` —
    q, k, v, out, g, lse, dq, dk, dv as (B, H, S, D) views, built only for
    these two routes — one fused call per q segment (counted under
    ``segment``), placed by ``off + a``, else the two-pass pair. Segment dq
    rows land in their rows of dq; the segments' dk/dv shares, each rounded
    to the operand dtype by its kernel, are summed in f32 and rounded once
    (the JAX package sums them in the operand dtype)."""
    seg = _segment_rows(sq, d)
    if seg == sq:
        whole()
        return
    q, k, v, out, g, lse, dq, dk, dv = views()
    if seg is None:
        _backward_two_pass(q, k, v, out, g, lse, dq, dk, dv, causal, window, off, scale, cos,
                           sin)
        return
    dk_sum, dv_sum = (torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                      for t in (dk, dv))
    dk_s, dv_s = torch.empty_like(dk), torch.empty_like(dv)
    for a in range(0, sq, seg):
        rows = slice(a, a + seg)
        _backward(segment, q[:, :, rows], k, v, out[:, :, rows], g[:, :, rows],
                  lse[:, :, rows].contiguous(), dq[:, :, rows], dk_s, dv_s, causal, window,
                  off + a, scale, cos, sin)
        dk_sum += dk_s
        dv_sum += dv_s
    dk.copy_(dk_sum)
    dv.copy_(dv_sum)


def _backward_by_route(whole, segment, q, k, v, out, g, lse, dq, dk, dv, causal, window, off,
                       scale, cos=None, sin=None) -> None:
    """:func:`_route_backward` on (B, H, S, D) views, its one fused call on
    them too (counted under ``whole``)."""
    ops = (q, k, v, out, g, lse, dq, dk, dv)
    _route_backward(
        lambda: _backward(whole, *ops, causal, window, off, scale, cos, sin), segment,
        q.shape[2], q.shape[3], lambda: ops, causal, window, off, scale, cos, sin)


# ---------------------------------------------------------------------------
# Packed-qkv wrappers (K1/K2, and the long branch through K8 or K5/K6).
# ---------------------------------------------------------------------------


def _check_kernel_operands(qkv, h, kv, causal, window, cos, sin, *others):
    b, sq, width, d = _qkv_dims(qkv, h, kv)
    _check_window(causal, window)
    if qkv.device.type != "cuda":
        raise ValueError(f"the flash kernels take CUDA tensors, got {qkv.device}")
    if qkv.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the flash kernels take bf16 or f32, got {qkv.dtype}")
    for t in (qkv, *others, *(() if cos is None else (cos, sin))):
        if t.device != qkv.device:
            raise ValueError(f"operand on {t.device}, qkv on {qkv.device}")
        _check_layout(t)
    if cos is not None and (cos.dtype != torch.float32 or sin.dtype != torch.float32):
        raise ValueError("rope tables reach the kernels as f32")
    return b, sq, width, d


def _check_layout(*tensors) -> None:
    """The per-call check of a packed launch: contiguous, 16-byte aligned."""
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the flash kernels take contiguous, 16-byte aligned operands")


def _pad_packed(t, n, d, dp):
    """``t`` (B, S, n·d), heads of width d, with each head padded to dp as
    :func:`pad_head_dim` pads it, in one copy: (B, S, n·dp)."""
    b, s = t.shape[:2]
    if d % 2:
        return torch.nn.functional.pad(t.view(b, s, n, d), (0, dp - d)).view(b, s, n * dp)
    halves = t.view(b, s, n, 2, d // 2)
    return torch.nn.functional.pad(halves, (0, (dp - d) // 2)).view(b, s, n * dp)


def _unpad_packed(t, n, d, dp, out=None):
    """The real columns of each head of a :func:`_pad_packed` layout, in one
    copy: (B, S, n·dp) -> (B, S, n·d), into ``out`` where it is given."""
    b, s = t.shape[:2]
    if out is None:
        out = torch.empty(b, s, n * d, dtype=t.dtype, device=t.device)
    if d % 2:
        out.view(b, s, n, d).copy_(t.view(b, s, n, dp)[..., :d])
    else:
        out.view(b, s, n, 2, d // 2).copy_(t.view(b, s, n, 2, dp // 2)[..., :d // 2])
    return out


def _packed_offsets(h, kv, d, elt):
    """Byte offsets of q, k and v (and of dq, dk, dv) in a packed row."""
    return 0, h * d * elt, (h + kv) * d * elt


def _qkv_plan(direction, source, dtype, b, s, h, kv, d, causal, window, scale, table_batch,
              pad=None):
    """The plan of a packed launch (``direction`` "fwd": K1; "bwd": K2) on
    qkv (B, S, (H + 2·KV)·d) at instance ``d``: q, k and v (and dq, dk, dv
    of dqkv) read in place at :func:`_packed_offsets` with (b, h, s) strides
    (S·W, d, W), out (and dO) at (S·H·d, d, H·d). ``table_batch``: the rope
    tables' leading dim (1 or B), None without rope; the tables the kernel
    reads are (table_batch, S, d/2) at the instance. ``pad`` (real d,
    instance) when the call pads its head dim."""
    width = (h + 2 * kv) * d
    packed, heads = (s * width, d, width), (s * h * d, d, h * d)
    operands = (packed,) * 3 + ((heads,) if direction == "fwd" else (heads, heads) + (packed,) * 3)
    tstride = 0 if table_batch in (None, 1) else s * (d // 2)
    return _Plan(source, [st for op in operands for st in op],
                 _common_args(dtype, b, h, kv, s, s, d, causal, window, 0, tstride, scale),
                 _scratch_specs(source, dtype, b, h, kv, s, s, d, table_batch is not None),
                 _packed_offsets(h, kv, d, dtype.itemsize), pad)


def _signature(t):
    """What a packed call's checks read of an operand, besides its layout:
    its shape, dtype and card."""
    return t.shape, t.dtype, t.get_device()


def _qkv_key(direction, qkv, h, kv, causal, window, scale, *operands):
    """The call signature of a packed launch: first the source it runs on
    (:func:`forward_kernel` for "fwd", :func:`backward_kernel` with dq for
    "bwd", at its head dim's instance), then its arguments and the
    :func:`_signature` of qkv and of every other operand its checks read
    (``operands``: K2's out, lse and g, then the rope tables), so that the
    checks a plan was built under hold for every call with its key."""
    sig = _signature(qkv)
    dp = _instance_dim(_packed_dims(sig[0], h, kv)[3])
    source = forward_kernel(sig[1], dp) if direction == "fwd" else \
        backward_kernel(sig[1], dp, True)
    return (source, h, kv, causal, window, scale, sig, *map(_signature, operands))


def _packed_plan(direction, qkv, h, kv, causal, window, cos, sin, scale, *others):
    """The cached launch plan of a packed call (``others``: K2's out, lse
    and g), its operands' layout checked on every call; the other checks run
    when the plan is built, once per :func:`_qkv_key`."""
    tables = () if cos is None else (cos, sin)
    key = _qkv_key(direction, qkv, h, kv, causal, window, scale, *others, *tables)
    plan = _cached_plan(key, lambda: _build_qkv_plan(direction, key[0], qkv, h, kv, causal,
                                                     window, cos, sin, scale, *others))
    _check_layout(qkv, *others, *tables)
    return plan


def _build_qkv_plan(direction, source, qkv, h, kv, causal, window, cos, sin, scale, out=None,
                    lse=None, g=None):
    """Check a packed call's operands and plan it on ``source`` at the head
    dim's instance."""
    others = () if direction == "fwd" else (out, lse, g)
    b, sq, _, d = _check_kernel_operands(qkv, h, kv, causal, window, cos, sin, *others)
    if direction == "bwd":
        if out.dtype != qkv.dtype or g.dtype != qkv.dtype or lse.dtype != torch.float32:
            raise ValueError("out and g must match qkv's dtype and lse must be f32")
        if tuple(out.shape) != (b, sq, h * d) or tuple(g.shape) != (b, sq, h * d) \
                or tuple(lse.shape) != (b, h, sq):
            raise ValueError("out/g must be (B, S, H*dh) and lse (B, H, S)")
    dp = _instance_dim(d)
    return _qkv_plan(direction, source, qkv.dtype, b, sq, h, kv, dp, causal, window,
                     _scale(d, scale), None if cos is None else cos.shape[0],
                     None if dp == d else (d, dp))


def flash_forward_qkv_kernel(qkv, num_heads, num_kv_heads, causal, window,
                             cos, sin, scale):
    """Launch the forward (:func:`forward_kernel`) on qkv's stream, reading
    q, k and v in place inside qkv through a cached launch plan (no head
    views are built). ``cos``/``sin`` are the f32 tables from
    :func:`rope_operands` or None. A head dim between the instances runs on
    qkv padded in one copy. Returns ``out`` (B, S, H·dh) and ``lse`` (B, H,
    S) f32, like the plain version."""
    h, kv = num_heads, num_kv_heads
    device = qkv.get_device()
    plan = _packed_plan("fwd", qkv, h, kv, causal, window, cos, sin, scale)
    b, sq = qkv.shape[:2]
    if plan.pad is not None:
        d, dp = plan.pad
        qkv = _pad_packed(qkv, h + 2 * kv, d, dp)
        cos, sin = pad_rope_tables(cos, sin, dp)
    d = plan.stride_values[1]
    out = torch.empty(b, sq, h * d, dtype=qkv.dtype, device=device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=device)
    base = qkv.data_ptr()
    q_off, k_off, v_off = plan.offsets
    _run(plan, "flash_fwd", device,
         (base + q_off, base + k_off, base + v_off, out.data_ptr(), lse.data_ptr(), _ptr(cos),
          _ptr(sin)), _alloc(plan.scratch, device))
    if plan.pad is not None:
        out = _unpad_packed(out, h, *plan.pad)
    return out, lse


def _qkv_backward(qkv, out, lse, g, dqkv, h, kv, causal, window, cos, sin, scale):
    """The fused backward in one launch (K2) on packed operands through a
    cached launch plan: dq, dk and dv written in place inside ``dqkv``
    (qkv's shape, contiguous)."""
    device = qkv.get_device()
    plan = _packed_plan("bwd", qkv, h, kv, causal, window, cos, sin, scale, out, lse, g)
    b, sq = qkv.shape[:2]
    grads = dqkv
    if plan.pad is not None:
        d, dp = plan.pad
        qkv, out, g = (_pad_packed(t, n, d, dp) for t, n in ((qkv, h + 2 * kv), (out, h), (g, h)))
        cos, sin = pad_rope_tables(cos, sin, dp)
        grads = torch.empty(qkv.shape, dtype=qkv.dtype, device=device)
    d = plan.stride_values[1]
    dq_acc = torch.empty(b, h, sq, d, dtype=torch.float32, device=device)
    delta = torch.empty(b, h, sq, dtype=torch.float32, device=device)
    base, dbase = qkv.data_ptr(), grads.data_ptr()
    q_off, k_off, v_off = plan.offsets
    _run(plan, "flash_bwd", device,
         (base + q_off, base + k_off, base + v_off, out.data_ptr(), g.data_ptr(),
          lse.data_ptr(), _ptr(cos), _ptr(sin), dbase + q_off, dbase + k_off, dbase + v_off,
          dq_acc.data_ptr(), delta.data_ptr()), _alloc(plan.scratch, device))
    if plan.pad is not None:
        _unpad_packed(grads, h + 2 * kv, *plan.pad, out=dqkv)


def flash_backward_qkv_kernel(qkv, out, lse, g, num_heads, num_kv_heads, causal,
                              window, cos, sin, scale):
    """Launch the fused backward once on qkv's stream (K2, whatever the
    length), writing dq, dk and dv in place inside one dqkv through a cached
    launch plan. Returns dqkv."""
    dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
    _qkv_backward(qkv, out, lse, g, dqkv, num_heads, num_kv_heads, causal, window, cos, sin,
                  scale)
    return dqkv


def _on(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, got {t.device}")
    return t.device.type


class FlashAttentionQKV(torch.autograd.Function):
    """Flash self-attention on packed qkv with a kernel in each direction:
    CUDA tensors go through the forward kernel and, backward, the
    route the JAX package's ``_flash_backward_qkv`` takes — K2 in one call
    on the packed operands, else K8 per q segment on head views of qkv (GQA
    through the kernel's head-group divisor, rope at each segment's
    positions), else the two-pass K5/K6 — CPU tensors through the plain
    versions of the same route. The f32 rope tables are constants (integer
    positions) and get no gradient."""

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
        sq, d = qkv.shape[1], qkv.shape[2] // (h + 2 * kv)
        dqkv = torch.empty_like(qkv)

        def views():
            return (*_packed_heads(qkv, h, kv, d), _heads(out, d), _heads(g, d), lse,
                    *_packed_heads(dqkv, h, kv, d))

        if _on(qkv) == "cuda":
            whole = lambda: _qkv_backward(qkv, out, lse, g, dqkv, h, kv, causal, window, cos,
                                          sin, scale)
        else:
            whole = lambda: _backward("flash_bwd", *views(), causal, window, 0, scale, cos, sin)
        _route_backward(whole, "bshd_bwd", sq, d, views, causal, window, 0, scale, cos, sin)
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
# BHSD wrappers: q (B, H, Sq, D), k and v (B, KV, Skv, D).
# ---------------------------------------------------------------------------


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it through its strides
    (contiguous last dimension, 16-byte aligned rows and start), else a
    contiguous copy."""
    elt = t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        (st * elt) % 16 == 0 for st in t.stride()[:3]
    ):
        return t
    return t.contiguous()


def _check_bhsd_kernel_operands(q, k, v, causal, window, *others, cos=None, sin=None,
                                q_pos_offset=None):
    b, h, sq, skv, d = _bhsd_dims(q, k, v)
    _check_window(causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernels take CUDA tensors, got {q.device}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the flash kernels take bf16 or f32, got {q.dtype}")
    for t in (k, v, *others):
        if t.device != q.device:
            raise ValueError(f"operand on {t.device}, q on {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share a dtype")
    if min(b, h, sq, skv) < 1:
        raise ValueError("the flash kernels take non-empty operands")
    if cos is not None:
        off = _offset(sq, skv, q_pos_offset)
        for t in (cos, sin):
            if t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous() \
                    or t.dim() != 3 or t.shape[0] not in (1, b) \
                    or tuple(t.shape[1:]) != (skv, d // 2):
                raise ValueError(f"rope tables must be contiguous f32 (1|{b}, {skv}, {d // 2})"
                                 f" on {q.device}")
        if off < 0 or off + sq > skv:
            raise ValueError("with rope tables the q rows' positions must lie in [0, Skv)")
    return b, h, sq, skv, d


def _check_backward_operands(q, k, v, out, lse, g, causal, window, **rope):
    b, h, sq, _, _ = _check_bhsd_kernel_operands(q, k, v, causal, window, out, lse, g, **rope)
    if out.dtype != q.dtype or g.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError("out and g must match q's dtype and lse must be f32")
    if out.shape != q.shape or g.shape != q.shape or tuple(lse.shape) != (b, h, sq):
        raise ValueError("out/g must be shaped like q and lse (B, H, Sq)")


def flash_forward_kernel(q, k, v, causal=False, window=None, scale=None, q_pos_offset=None,
                         cos=None, sin=None, counter="bhsd_fwd"):
    """Launch the forward (:func:`forward_kernel`) on q's stream. Operands
    are read through their strides (a head-transposed view of a (B, S, H·D)
    projection needs no copy); ``out`` is allocated in q's layout. Returns
    ``out`` (B, H, Sq, D) and ``lse`` (B, H, Sq) f32, like the plain
    version."""
    b, h, sq, skv, d = _check_bhsd_kernel_operands(q, k, v, causal, window, cos=cos, sin=sin,
                                                   q_pos_offset=q_pos_offset)
    q, k, v = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    _launch_forward(counter, q, k, v, out, lse, causal, window, _offset(sq, skv, q_pos_offset),
                    scale, cos, sin)
    return out, lse


def flash_backward_kernel(q, k, v, out, lse, g, causal=False, window=None, scale=None,
                          q_pos_offset=None, cos=None, sin=None, counter="bhsd_bwd"):
    """Launch the fused backward once on q's stream. ``q_pos_offset``
    places q row 0 in the key sequence, so a call on a q segment gives that
    segment's dq and its share of dk/dv. Returns ``dq, dk, dv`` in the
    layouts of q, k, v."""
    _check_backward_operands(q, k, v, out, lse, g, causal, window, cos=cos, sin=sin,
                             q_pos_offset=q_pos_offset)
    q, k, v, out, g = (_kernel_layout(t) for t in (q, k, v, out, g))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch_backward(counter, q, k, v, out, g, lse.contiguous(), dq, dk, dv, causal, window,
                     _offset(q.shape[2], k.shape[2], q_pos_offset), scale, cos, sin)
    return dq, dk, dv


def flash_backward_dkv_kernel(q, k, v, out, lse, g, causal=False, window=None, scale=None,
                              q_pos_offset=None, cos=None, sin=None):
    """K6: launch the fused backward with dq compiled out. Returns ``dk,
    dv`` in the layouts of k, v and ``delta`` (B, H, Sq) f32, the input of
    :func:`flash_backward_dq_kernel`."""
    _check_backward_operands(q, k, v, out, lse, g, causal, window, cos=cos, sin=sin,
                             q_pos_offset=q_pos_offset)
    q, k, v, out, g = (_kernel_layout(t) for t in (q, k, v, out, g))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    _launch_backward("bwd_dkv", q, k, v, out, g, lse.contiguous(), None, dk, dv, causal, window,
                     _offset(q.shape[2], k.shape[2], q_pos_offset), scale, cos, sin, delta=delta)
    return dk, dv, delta


def flash_backward_dq_kernel(q, k, v, lse, g, delta, causal=False, window=None, scale=None,
                             q_pos_offset=None, cos=None, sin=None):
    """K5: launch the two-pass dq kernel (:func:`backward_dq_kernel`).
    ``delta`` is the one :func:`flash_backward_dkv_kernel` returned. Returns
    ``dq`` in q's layout."""
    _check_bhsd_kernel_operands(q, k, v, causal, window, lse, g, delta, cos=cos, sin=sin,
                                q_pos_offset=q_pos_offset)
    q, k, v, g = (_kernel_layout(t) for t in (q, k, v, g))
    dq = torch.empty_like(q)
    _launch_backward_dq(q, k, v, g, lse.contiguous(), delta.contiguous(), dq, causal, window,
                        _offset(q.shape[2], k.shape[2], q_pos_offset), scale, cos, sin)
    return dq


class FlashAttention(torch.autograd.Function):
    """BHSD flash attention with a kernel in each direction: CUDA tensors go
    through the forward kernel and, backward, the route the JAX
    package's ``_flash_backward`` takes — K4 in one call or per q segment,
    else the two-pass K5/K6 — CPU tensors through the plain versions of the
    same route."""

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
        causal, window, scale = ctx.args
        if _on(q) == "cuda":
            q, k, v, out, g = (_kernel_layout(t) for t in (q, k, v, out, g))
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        _backward_by_route("bhsd_bwd", "bhsd_bwd", q, k, v, out, g, lse, *grads, causal, window,
                           _offset(q.shape[2], k.shape[2], None), scale)
        return (*grads, None, None, None)


def flash_attention(q, k, v, causal: bool = False, scale: float | None = None,
                    window: int | None = None):
    """Flash attention on q (B, H, Sq, D) against k, v (B, KV, Skv, D) (KV
    divides H; query head h reads kv head h // (H / KV)); returns (B, H, Sq,
    D), differentiable in q, k and v. Causal masking is end-aligned (query i
    attends keys <= i + Skv - Sq); ``window`` needs ``causal``. The JAX
    function's ``block_q``/``block_kv`` and ``interpret`` are TPU arguments
    and have no counterpart here."""
    _check_window(causal, window)
    _bhsd_dims(q, k, v)
    return FlashAttention.apply(q, k, v, causal, window, scale)


# ---------------------------------------------------------------------------
# BSHD wrappers (K7/K8): q (B, Sq, H, D), k and v (B, Skv, KV, D) — the
# layout the projections produce, handed to the kernels as head-transposed
# views.
# ---------------------------------------------------------------------------


def _bhsd(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(1, 2)


def flash_forward_bshd(q, k, v, causal=False, window=None, scale=None):
    """K7, the forward of :func:`flash_attention_bshd`: the kernel for CUDA
    tensors (counted under ``bshd_fwd``), the plain version for CPU ones.
    Returns ``out`` (B, Sq, H, D) and ``lse`` (B, H, Sq) f32."""
    if _on(q) == "cuda":
        out, lse = flash_forward_kernel(_bhsd(q), _bhsd(k), _bhsd(v), causal, window, scale,
                                        counter="bshd_fwd")
    else:
        out, lse = flash_forward_reference(_bhsd(q), _bhsd(k), _bhsd(v), causal, window, scale)
    return _bhsd(out), lse


def flash_backward_bshd(q, k, v, out, lse, g, causal=False, window=None, scale=None,
                        q_pos_offset=None, cos=None, sin=None):
    """K8 in one call: the fused backward on (B, S, H, D) operands — a q
    segment when ``q_pos_offset`` places it — with optional rope tables
    (1|B, Skv, D/2) f32 read at the rows' positions. The kernel for CUDA
    tensors (counted under ``bshd_bwd``), the plain version for CPU ones.
    Returns ``dq, dk, dv`` (B, S, ·, D)."""
    args = (causal, window, scale, q_pos_offset, cos, sin)
    views = [_bhsd(t) for t in (q, k, v, out)]
    if _on(q) == "cuda":
        grads = flash_backward_kernel(*views, lse, _bhsd(g), *args, counter="bshd_bwd")
    else:
        grads = flash_backward_reference(*views, lse, _bhsd(g), *args)
    return tuple(_bhsd(t) for t in grads)


class FlashAttentionBSHD(torch.autograd.Function):
    """:class:`FlashAttention` on (B, S, H, D) operands: K7 forward and,
    backward, the route of the JAX package's ``_flash_backward_bshd`` — K8
    in one call or per q segment, else the two-pass K5/K6."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = flash_forward_bshd(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        views = [_bhsd(t) for t in (q, k, v, out, g)]
        if _on(q) == "cuda":
            views = [_kernel_layout(t) for t in views]
        grads = tuple(torch.empty_like(t) for t in views[:3])
        _backward_by_route("bshd_bwd", "bshd_bwd", *views, lse, *grads, causal, window,
                           _offset(q.shape[1], k.shape[1], None), scale)
        return (*(_bhsd(t) for t in grads), None, None, None)


def flash_attention_bshd(q, k, v, causal: bool = False, scale: float | None = None,
                         window: int | None = None):
    """:func:`flash_attention` on the activation layout: q (B, Sq, H, D)
    against k, v (B, Skv, KV, D); returns (B, Sq, H, D), differentiable in
    q, k and v."""
    _check_window(causal, window)
    _bhsd_dims(_bhsd(q), _bhsd(k), _bhsd(v))
    return FlashAttentionBSHD.apply(q, k, v, causal, window, scale)
