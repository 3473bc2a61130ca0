#!/usr/bin/env python
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero and no result is printed:

  1. card      — nvidia-smi's name and power limit, torch's device name;
  2. build     — nvcc builds every kernel under
                 distributed_tensorflow_tpu_torch/csrc/ (in parallel);
  3. kernels   — each kernel against its plain PyTorch version on the same
                 inputs, by a max-based and a blockwise normwise limit (see
                 TOL and BLOCK_TOL). One CUDA kernel per direction serves
                 both layouts. Packed-qkv wrappers (K1/K2): the dp path's
                 call shape (batch 12, seq 2048, 16 heads of 128, bf16), and
                 a small GQA + window + rope case at head_dim 64 with a
                 ragged sequence, in bf16 and f32. BHSD wrappers (K3/K4): the
                 tp path's call shape (the same sizes, as the head-transposed
                 views the tp block hands over) with planted-fault controls,
                 cross-length causal with a window (Sq 192, Skv 320, head_dim
                 64) in bf16 and f32, Sq > Skv with fully masked rows (out
                 exactly 0, everything finite), non-causal at head_dim 128 in
                 f32, and K4 called on q segments placed by q_pos_offset
                 against one whole call;
  4. main      — the trainer (cli/train_lm.py) at the bench flagship's full
                 width and depth (d_model 2048, 16 heads, 8 layers, d_ff
                 8192, seq 2048, batch 12, bias-free, flash attention) for 6
                 steps, in dp mode and then in tp mode (--model_parallel 1,
                 a world of one): finite loss at every boundary, and exactly
                 8 forward and 8 backward launches per step of that mode's
                 kernels and none of the other mode's;
  5. parity    — one step at flagship width (batch 2) through the kernels and
                 through plain dense attention, same weights and tokens: the
                 dp model, and the tp model against the dp model (its fused
                 qkv weight split into q/k/v) and against dense attention;
  6. timing    — each kernel at its path's call shape beside its plain
                 version, its bound on this card and the library's nearest
                 call (scaled_dot_product_attention, forward for a forward
                 kernel and forward+backward for a backward kernel, with its
                 backward alone beside it; its top-left causal alignment
                 agrees with ours because Sq == Skv);
  7. profile   — one flagship training step of each mode under
                 torch.profiler: device time by kernel class and the device's
                 idle share.

Then a line with nvidia-smi's name and power limit, a JSON line with the
kernels' numbers, and last ``{"ok": true, "device": {...}}``. Needs one
card and no network.
"""

import contextlib
import io
import json
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device visible to torch")

from distributed_tensorflow_tpu_torch.ops import _build  # noqa: E402
from distributed_tensorflow_tpu_torch.ops import attention as A  # noqa: E402

FLAGSHIP = dict(d_model=2048, num_heads=16, num_layers=8, d_ff=8192, seq_len=2048,
                batch_size=12)
STEPS, INTERVAL = 6, 2
# Tolerances, as max |kernel - plain| / max |plain|, except lse (absolute).
# f32 runs every product in full f32 (no TF32); bf16 rounds p and dS to
# bf16 before their products, as the TPU kernels do, where the plain
# version keeps f32.
TOL = {
    torch.float32: {"out": 1e-4, "lse": 1e-4, "dqkv": 1e-4},
    torch.bfloat16: {"out": 2e-2, "lse": 1e-3, "dqkv": 3e-2},
}
# The max-based limit above is loose where it matters: max |plain| comes
# from the first causal rows (out = v there), while a row past a few hundred
# keys is ~30x smaller, so a kernel that dropped one kv tile from P·V or
# dS·K could pass it. Every output is also held blockwise: per head, per
# block of BLOCK_ROWS consecutive rows, ||kernel - plain||_F / ||plain||_F,
# and the largest over all blocks must stay under BLOCK_TOL (three times the
# largest reading of a sound run on an H100; PERF.md). A block whose plain
# value is all zero must come out exactly zero. The fault controls in phase
# 3 show that one dropped tile fails this check.
BLOCK_ROWS = 64
BLOCK_TOL = {  # largest sound readings: f32 4.8e-7 / 4.5e-7, bf16 2.7e-3 / 3.6e-3
    torch.float32: {"out": 1.5e-6, "dqkv": 1.4e-6},
    torch.bfloat16: {"out": 8.2e-3, "dqkv": 1.1e-2},
}
REPLACES = {
    "flash_fwd": "distributed_tensorflow_tpu/ops/attention.py:1660 (_flash_kernel via "
                 "_flash_forward_qkv)",
    "flash_bwd": "distributed_tensorflow_tpu/ops/attention.py:1796 (_flash_bwd_fused_kernel "
                 "via _flash_backward_qkv)",
    "bhsd_fwd": "distributed_tensorflow_tpu/ops/attention.py:481 (_flash_kernel via "
                "_flash_forward)",
    "bhsd_bwd": "distributed_tensorflow_tpu/ops/attention.py:1004 (_flash_bwd_fused_kernel "
                "via _flash_backward_fused)",
}
# The wrappers' launch counters and the source each one launches: both
# layouts go through one kernel per direction, as the TPU's do.
SOURCES = {"flash_fwd": "flash_fwd", "bhsd_fwd": "flash_fwd",
           "flash_bwd": "flash_bwd", "bhsd_bwd": "flash_bwd"}
# Each mode's wrappers: its main phase must launch these 8 + 8 times a step
# and the other mode's not at all.
MODE_KERNELS = {"dp": ("flash_fwd", "flash_bwd"), "tp": ("bhsd_fwd", "bhsd_bwd")}


def emit(**record):
    print(json.dumps(record), flush=True)


def fail(msg):
    sys.exit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def phase_card():
    smi = nvidia_smi()
    emit(phase="card", nvidia_smi=smi, torch_device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return smi


def phase_build():
    seconds = _build.build()
    for name in _build.sources():
        # Each instance's "Compiling entry function" line (its mangled name
        # carries the dtype and head_dim) heads its register and spill lines.
        lines = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln or "entry function" in ln]
        emit(phase="build", kernel=name, library=str(_build.library_path(name).name),
             ptxas=lines)
    emit(phase="build", seconds=round(seconds, 2))


def _packed(b, s, h, kv, d, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, s, (h + 2 * kv) * d, device="cuda", generator=gen).to(dtype)
    g = torch.randn(b, s, h * d, device="cuda", generator=gen).to(dtype)
    return qkv, g


def _err(got, ref):
    diff = (got.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-30)


def _block_err(got, ref):
    """Largest ||got - ref||_F / ||ref||_F over blocks of BLOCK_ROWS
    consecutive rows of each head of (..., S, D) tensors; inf when a block
    whose reference is all zero is not zero."""
    def blocks(t):
        t = t.float().reshape(-1, t.shape[-2], t.shape[-1])
        t = torch.nn.functional.pad(t, (0, 0, 0, (-t.shape[1]) % BLOCK_ROWS))
        return t.reshape(t.shape[0], -1, BLOCK_ROWS * t.shape[-1])

    g, r = blocks(got), blocks(ref)
    num, den = (g - r).norm(dim=-1), r.norm(dim=-1)
    zero = den == 0
    if (num[zero] > 0).any():
        return float("inf")
    return (num[~zero] / den[~zero]).max().item()


def _check(case, name, dtype, got, ref, tol_key):
    """Hold got to ref: lse by its absolute error, every other tensor (as
    (..., S, D) head rows) by the max-based and the blockwise limits."""
    abs_err, rel_err = _err(got, ref)
    rec = dict(phase="kernels", case=case, tensor=name, dtype=str(dtype).split(".")[-1],
               max_abs_err=abs_err, rel_err=rel_err, tol=TOL[dtype][tol_key])
    if tol_key == "lse":
        ok = abs_err <= TOL[dtype]["lse"]
        rec.update(tol_kind="abs")
    else:
        block = _block_err(got, ref)
        ok = rel_err <= TOL[dtype][tol_key] and block <= BLOCK_TOL[dtype][tol_key]
        rec.update(tol_kind="rel", block_err=block, block_tol=BLOCK_TOL[dtype][tol_key])
    emit(**rec, ok=ok)
    if not ok:
        fail(f"{case}: {name} outside its limits ({rec})")
    return abs_err


def compare(case, b, s, h, kv, d, dtype, causal=True, window=None, rope=False, seed=0):
    """Kernel vs plain version, forward and backward, on the same inputs.
    Returns the max abs errors of out and dqkv."""
    from distributed_tensorflow_tpu_torch.ops.rope import rope_tables

    qkv, g = _packed(b, s, h, kv, d, dtype, seed)
    cos = sin = None
    if rope:
        cos, sin = rope_tables(d, s, 10000.0, device="cuda")
    args = (h, kv, causal, window, cos, sin)
    out, lse = A.flash_forward_qkv_kernel(qkv, *args, None)
    dqkv = A.flash_backward_qkv_kernel(qkv, out, lse, g, *args, None)
    torch.cuda.synchronize()
    ref_out, ref_lse = A.flash_forward_qkv_reference(qkv, *args)
    # The backward is held against the plain backward on the kernel's own
    # forward results, so its error is its own.
    ref_dqkv = A.flash_backward_qkv_reference(qkv, out, lse, g, *args)
    errs = {}
    for name, got, ref in (("out", out, ref_out), ("lse", lse, ref_lse), ("dqkv", dqkv, ref_dqkv)):
        if not torch.isfinite(got).all():
            fail(f"{case}: non-finite {name}")
        if name != "lse":  # hold each head's rows: (B, S, n·d) -> (B, n, S, d)
            got, ref = (A._heads(t, d) for t in (got, ref))
        errs[name] = _check(case, name, dtype, got, ref, name)
    return errs


def _bhsd(b, h, sq, skv, d, dtype, seed, bshd=False):
    """q, k, v, g on the card; with ``bshd`` each is the head-transposed view
    of a (B, S, H, D) tensor, as the tp block hands its projections over."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def make(s):
        if bshd:
            return torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)
        return torch.randn(b, h, s, d, device="cuda", generator=gen).to(dtype)

    return make(sq), make(skv), make(skv), make(sq)


def compare_bhsd(case, b, h, sq, skv, d, dtype, causal=True, window=None, bshd=False, seed=0,
                 controls=False):
    """K3/K4 vs their plain versions on the same inputs. Rows that attend
    nothing must come out exactly 0 with lse at NEG_INF. With ``controls``
    the planted faults are checked too. Returns the max abs errors of out
    and of the worst gradient."""
    q, k, v, g = _bhsd(b, h, sq, skv, d, dtype, seed, bshd)
    out, lse = A.flash_forward_kernel(q, k, v, causal, window)
    grads = A.flash_backward_kernel(q, k, v, out, lse, g, causal, window)
    torch.cuda.synchronize()
    ref_out, ref_lse = A.flash_forward_reference(q, k, v, causal, window)
    # The backward is held against the plain backward on the kernel's own
    # forward results, so its error is its own.
    ref_grads = A.flash_backward_reference(q, k, v, out, lse, g, causal, window)
    for name, t in (("out", out), ("lse", lse), *zip(("dq", "dk", "dv"), grads)):
        if not torch.isfinite(t).all():
            fail(f"{case}: non-finite {name}")
    dead = ref_lse <= A.NEG_INF / 2  # rows that attend no key
    if dead.any():
        if not (lse[dead] <= A.NEG_INF / 2).all() or (out[dead] != 0).any():
            fail(f"{case}: fully masked rows must give out 0 and lse NEG_INF")
        emit(phase="kernels", case=case, masked_rows=int(dead.sum()), zero_out=True)
    errs = {"out": _check(case, "out", dtype, out, ref_out, "out")}
    _check(case, "lse", dtype, lse[~dead], ref_lse[~dead], "lse")
    errs["grads"] = max(_check(case, name, dtype, t, r, "dqkv")
                        for name, t, r in zip(("dq", "dk", "dv"), grads, ref_grads))
    if controls:
        fault_controls(case, q, k, v, g, out, lse, grads, ref_out, ref_grads)
    return errs


def fault_controls(case, q, k, v, g, out, lse, grads, ref_out, ref_grads):
    """Plant the fault the max-based limit can miss — one 64-key kv tile
    dropped from the products of the last q tile of head (0, 0) — into the
    kernel's results, one product at a time, and require the blockwise
    check to fail on each (causal, Sq == Skv, no window)."""
    dtype, s, d = q.dtype, q.shape[2], q.shape[3]
    rows, keys = slice(s - BLOCK_ROWS, s), slice(s // 2, s // 2 + BLOCK_ROWS)
    scale = d ** -0.5
    qs = (q[0, 0, rows].float() * scale).to(dtype).float()
    kt, vt, go = k[0, 0, keys].float(), v[0, 0, keys].float(), g[0, 0, rows].float()
    p = torch.exp(qs @ kt.T - lse[0, 0, rows, None])
    delta = (go * out[0, 0, rows].float()).sum(-1, keepdim=True)
    ds = p * (go @ vt.T - delta)
    planted = (
        ("out: P.V", "out", out, ref_out, rows, p @ vt),
        ("dq: dS.K", "dqkv", grads[0], ref_grads[0], rows, scale * ds @ kt),
        ("dk: dS^T.Q", "dqkv", grads[1], ref_grads[1], keys, ds.T @ qs),
        ("dv: P^T.dO", "dqkv", grads[2], ref_grads[2], keys, p.T @ go),
    )
    for name, kind, got, ref, at, part in planted:
        bad = got.to(torch.float32, copy=True)
        bad[0, 0, at] -= part
        _, rel = _err(bad, ref)
        block = _block_err(bad, ref)
        del bad
        caught = block > BLOCK_TOL[dtype][kind]
        emit(phase="kernels", case=case, control=name, rel_err=rel, tol=TOL[dtype][kind],
             passes_max_rule=rel <= TOL[dtype][kind], block_err=block,
             block_tol=BLOCK_TOL[dtype][kind], caught=caught)
        if not caught:
            fail(f"{case}: the blockwise check misses the planted fault {name}")


def check_segments(case, b, h, s, d, dtype, n_seg, causal=True, window=None, seed=4):
    """K4 called on q segments, each placed by q_pos_offset: the dq rows
    concatenated and the dk/dv shares summed equal one whole call."""
    q, k, v, g = _bhsd(b, h, s, s, d, dtype, seed)
    out, lse = A.flash_forward_kernel(q, k, v, causal, window)
    whole = A.flash_backward_kernel(q, k, v, out, lse, g, causal, window)
    seg = s // n_seg
    parts = [
        A.flash_backward_kernel(q[:, :, a:a + seg], k, v, out[:, :, a:a + seg],
                                lse[:, :, a:a + seg], g[:, :, a:a + seg], causal, window,
                                q_pos_offset=a)
        for a in range(0, s, seg)
    ]
    got = (torch.cat([p[0] for p in parts], dim=2),
           sum(p[1].float() for p in parts), sum(p[2].float() for p in parts))
    torch.cuda.synchronize()
    for name, t, w in zip(("dq", "dk", "dv"), got, whole):
        _check(case, f"{name}_segments_vs_whole", dtype, t, w, "dqkv")


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fl = FLAGSHIP
    b, s, h = fl["batch_size"], fl["seq_len"], fl["num_heads"]
    dh = fl["d_model"] // h
    errs = {}
    flagship = compare("flagship", b, s, h, h, dh, torch.bfloat16)
    errs["flash_fwd"], errs["flash_bwd"] = flagship["out"], flagship["dqkv"]
    for dtype in (torch.bfloat16, torch.float32):
        compare("gqa_window_rope_d64", 2, 200, 8, 2, 64, dtype, window=100, rope=True, seed=1)
    compare("noncausal_gqa_d128", 1, 136, 4, 2, 128, torch.float32, causal=False, seed=2)

    tp_shape = compare_bhsd("bhsd_tp_path", b, h, s, s, dh, torch.bfloat16, bshd=True, seed=5,
                            controls=True)
    errs["bhsd_fwd"], errs["bhsd_bwd"] = tp_shape["out"], tp_shape["grads"]
    for dtype in (torch.bfloat16, torch.float32):
        compare_bhsd("bhsd_cross_window_d64", 2, 4, 192, 320, 64, dtype, window=100, seed=6)
    compare_bhsd("bhsd_fully_masked_rows_d64", 2, 4, 200, 72, 64, torch.float32, seed=7)
    compare_bhsd("bhsd_noncausal_d128", 1, 4, 136, 200, 128, torch.float32, causal=False,
                 seed=8)
    check_segments("bhsd_segments_f32_d128", 2, 4, 384, 128, torch.float32, n_seg=2)
    check_segments("bhsd_segments_tp_path", b, h, s, dh, torch.bfloat16, n_seg=2, seed=9)
    return errs


def _zero_counts():
    for k in A.KERNEL_LAUNCHES:
        A.KERNEL_LAUNCHES[k] = 0


def phase_main(smi, parallelism):
    from distributed_tensorflow_tpu_torch.cli import train_lm

    fl = FLAGSHIP
    argv = [
        "--d_model", str(fl["d_model"]), "--num_heads", str(fl["num_heads"]),
        "--num_layers", str(fl["num_layers"]), "--d_ff", str(fl["d_ff"]),
        "--seq_len", str(fl["seq_len"]), "--batch_size", str(fl["batch_size"]),
        "--use_bias", "0", "--attention", "flash", "--training_steps", str(STEPS),
        "--eval_step_interval", str(INTERVAL), "--device", "cuda",
        "--parallelism", parallelism,
    ]
    if parallelism == "tp":
        argv += ["--model_parallel", "1"]
    phase = f"main_{parallelism}"
    _zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train_lm.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(A.KERNEL_LAUNCHES)
    records = [json.loads(line) for line in buf.getvalue().splitlines()]
    for r in records:
        emit(phase=phase, **r)
    if [r["step"] for r in records] != list(range(INTERVAL, STEPS + 1, INTERVAL)):
        fail(f"{phase}: unexpected boundaries {[r['step'] for r in records]}")
    if not all(r["parallelism"] == parallelism for r in records):
        fail(f"{phase}: records name another parallelism")
    if not all(r["loss"] == r["loss"] and abs(r["loss"]) < float("inf") for r in records):
        fail(f"{phase}: non-finite loss")
    want = {k: fl["num_layers"] * STEPS if k in MODE_KERNELS[parallelism] else 0
            for k in A.KERNEL_LAUNCHES}
    emit(phase=phase, launches=launches, expected=want, wall_s=round(wall, 2))
    if launches != want:
        fail(f"{phase}: kernel launches {launches}, expected {want}")
    last = records[-1]
    if "steps_per_sec" not in last:
        fail(f"{phase}: no timed window")
    emit(phase=phase, steps_per_sec=last["steps_per_sec"],
         tokens_per_sec=last["tokens_per_sec"], mfu=last.get("mfu"), card=smi)
    return launches


def _flagship_cfg(attention="flash"):
    from distributed_tensorflow_tpu_torch.models.transformer import TransformerConfig

    fl = FLAGSHIP
    return TransformerConfig(
        vocab_size=256, d_model=fl["d_model"], num_heads=fl["num_heads"],
        num_layers=fl["num_layers"], d_ff=fl["d_ff"], max_seq_len=fl["seq_len"],
        use_bias=False, attention=attention, compute_dtype=torch.bfloat16,
    )


def _loss_and_backward(model, tokens):
    from distributed_tensorflow_tpu_torch.models.transformer import next_token_loss

    loss = next_token_loss(model(tokens), tokens)
    loss.backward()
    return loss.item()


def _parity(phase, name_a, a, name_b, b):
    """(loss, grad) pairs of two models on the same step: loss within 1e-2
    relative, the gradient within 5e-2 of its largest value."""
    loss_rel = abs(a[0] - b[0]) / abs(b[0])
    _, grad_rel = _err(a[1], b[1])
    ok = loss_rel <= 1e-2 and grad_rel <= 5e-2
    emit(phase=phase, **{f"loss_{name_a}": a[0], f"loss_{name_b}": b[0]},
         loss_rel_err=loss_rel, loss_tol=1e-2, grad_rel_err=grad_rel, grad_tol=5e-2, ok=ok)
    if not ok:
        fail(f"{phase}: {name_a} and {name_b} disagree")


def phase_parity():
    from distributed_tensorflow_tpu_torch.models.transformer import TransformerLM
    from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import TpTransformerLM

    fl = FLAGSHIP
    d = fl["d_model"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, 256, (2, fl["seq_len"]), device="cuda", generator=gen)
    results = {}
    for attention in ("flash", "dense"):
        model = TransformerLM(_flagship_cfg(attention), seed=0, device="cuda")
        loss = _loss_and_backward(model, tokens)
        results[attention] = (loss, model.block_0.qkv.weight.grad.float()[:d].clone())
        if attention == "flash":
            # The tp model's separate q/k/v weights are the rows of the fused one.
            tp_state = {}
            for name, t in model.state_dict().items():
                if name.endswith(".qkv.weight"):
                    base = name[: -len("qkv.weight")]
                    for part, w in zip("qkv", t.split(d, dim=0)):
                        tp_state[f"{base}{part}.weight"] = w
                else:
                    tp_state[name] = t
        del model
        torch.cuda.empty_cache()
    _parity("parity", "flash", results["flash"], "dense", results["dense"])
    for attention in ("flash", "dense"):
        model = TpTransformerLM(_flagship_cfg(attention), device="cuda")
        model.load_state_dict(tp_state)
        loss = _loss_and_backward(model, tokens)
        results[f"tp_{attention}"] = (loss, model.block_0.q.weight.grad.float().clone())
        del model
        torch.cuda.empty_cache()
    _parity("parity_tp", "tp_flash", results["tp_flash"], "dp_flash", results["flash"])
    _parity("parity_tp", "tp_flash", results["tp_flash"], "tp_dense", results["tp_dense"])


def time_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _sdpa(q, k, v, g):
    """The library's calls on (B, H, S, D) tensors: forward, forward +
    backward, and backward alone."""
    import torch.nn.functional as F

    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def fwd_bwd():
        F.scaled_dot_product_attention(ql, kl, vl, is_causal=True).backward(g)

    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

    def bwd():
        torch.autograd.grad(ol, (ql, kl, vl), g, retain_graph=True)

    return fwd, fwd_bwd, bwd


def phase_timing(launches, errs):
    from distributed_tensorflow_tpu_torch.utils.flops import chip_hbm_bandwidth, chip_peak_flops

    fl = FLAGSHIP
    b, s, h = fl["batch_size"], fl["seq_len"], fl["num_heads"]
    d = fl["d_model"] // h
    peak, bw = chip_peak_flops(), chip_hbm_bandwidth()
    if peak is None:
        fail(f"timing: no peak rates known for {torch.cuda.get_device_name(0)}")
    pairs = s * (s + 1) // 2  # attended (q, k) pairs of one causal head
    fwd_flops = 4 * b * h * d * pairs  # q·kᵀ and p·v
    bwd_flops = fwd_flops * 5 // 2  # five products against the forward's two

    # K1/K2 on the dp path's packed operand.
    qkv, g = _packed(b, s, h, h, d, torch.bfloat16, seed=3)
    args = (h, h, True, None, None, None)
    out, lse = A.flash_forward_qkv_kernel(qkv, *args, None)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in qkv.split(h * d, dim=-1))
    lib = _sdpa(q, k, v, g.reshape(b, s, h, d).transpose(1, 2))
    elt = qkv.element_size()
    qkv_bytes, o_bytes, lse_bytes = qkv.numel() * elt, out.numel() * elt, lse.numel() * 4
    runs = {
        "flash_fwd": (
            (fwd_flops, qkv_bytes + o_bytes + lse_bytes),
            lambda: A.flash_forward_qkv_kernel(qkv, *args, None),
            lambda: A.flash_forward_qkv_reference(qkv, *args),
            lib[0], None,
        ),
        # reads qkv, out, lse, dO, writes dqkv
        "flash_bwd": (
            (bwd_flops, 2 * qkv_bytes + 2 * o_bytes + lse_bytes),
            lambda: A.flash_backward_qkv_kernel(qkv, out, lse, g, *args, None),
            lambda: A.flash_backward_qkv_reference(qkv, out, lse, g, *args),
            lib[1], lib[2],
        ),
    }
    kernels = _time_kernels(runs, launches, errs, peak, bw,
                            dict(B=b, S=s, H=h, KV=h, D=d, dtype="bf16", causal=True))
    del qkv, g, out, lse, q, k, v, lib
    torch.cuda.empty_cache()

    # K3/K4 on the tp path's head-transposed views.
    q, k, v, g = _bhsd(b, h, s, s, d, torch.bfloat16, seed=10, bshd=True)
    out, lse = A.flash_forward_kernel(q, k, v, True)
    lib = _sdpa(q, k, v, g)
    t_bytes = q.numel() * q.element_size()  # one of q, k, v, out, dO, dq, dk, dv
    runs = {
        "bhsd_fwd": (
            (fwd_flops, 4 * t_bytes + lse_bytes),
            lambda: A.flash_forward_kernel(q, k, v, True),
            lambda: A.flash_forward_reference(q, k, v, True),
            lib[0], None,
        ),
        # reads q, k, v, out, dO, lse, writes dq, dk, dv
        "bhsd_bwd": (
            (bwd_flops, 8 * t_bytes + lse_bytes),
            lambda: A.flash_backward_kernel(q, k, v, out, lse, g, True),
            lambda: A.flash_backward_reference(q, k, v, out, lse, g, True),
            lib[1], lib[2],
        ),
    }
    kernels += _time_kernels(runs, launches, errs, peak, bw,
                             dict(B=b, S=s, H=h, D=d, dtype="bf16", causal=True,
                                  layout="BSHD views"))
    return kernels


def _time_kernels(runs, launches, errs, peak, bw, shape):
    kernels = []
    for name, ((flops, nbytes), kernel, plain, library, library_bwd) in runs.items():
        t_flops, t_bytes = flops / peak * 1e3, nbytes / bw * 1e3
        rec = {
            "name": name,
            "route": "cuda",
            "source": f"distributed_tensorflow_tpu_torch/csrc/{SOURCES[name]}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": time_ms(kernel, 10),
            "plain_ms": time_ms(plain, 3, warmup=1),
            "bound_ms": max(t_flops, t_bytes),
            "bound_by": "operations" if t_flops >= t_bytes else "bytes",
            "library_ms": time_ms(library, 10),
        }
        extra = {} if library_bwd is None else {"library_bwd_only_ms": time_ms(library_bwd, 10)}
        emit(phase="timing", shape=shape, flops=flops, bytes=nbytes, **rec, **extra)
        kernels.append(rec)
    return kernels


# Kernel-name substrings → class, checked in order (cuBLAS's Hopper GEMMs
# are named nvjet_*, sm90_xmma_* or *gemm*). No kernel name of one class
# contains another class's substring. Each profiled step runs one mode, so
# attn_fwd is K1 in the dp step and K3 in the tp step (one CUDA kernel).
KERNEL_CLASSES = (
    ("attn_fwd", ("dtt::flash_fwd",)),
    ("attn_bwd", ("dtt::flash_bwd",)),  # delta pre-pass, main kernel, dq pass
    ("matmul", ("nvjet", "gemm", "xmma", "cutlass")),
    ("layer_norm", ("layer_norm",)),
    ("optimizer", ("multi_tensor", "foreach", "adam")),
    ("cross_entropy", ("softmax", "nll_loss")),
)


def phase_profile(parallelism):
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_tpu_torch.models.transformer import TransformerLM
    from distributed_tensorflow_tpu_torch.parallel.data_parallel import build_lm_train_step
    from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
        TpTransformerLM,
        build_tp_lm_train_step,
    )
    from distributed_tensorflow_tpu_torch.train.optimizers import make_optimizer

    fl = FLAGSHIP
    if parallelism == "tp":
        model = TpTransformerLM(_flagship_cfg(), seed=0, device="cuda")
        build = build_tp_lm_train_step
    else:
        model = TransformerLM(_flagship_cfg(), seed=0, device="cuda")
        build = build_lm_train_step
    step = build(model, make_optimizer("adam", model.parameters(), 3e-3, 10))
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, 256, (fl["batch_size"], fl["seq_len"]), device="cuda",
                           generator=gen)
    for _ in range(2):
        step(tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class = {name: 0.0 for name, _ in KERNEL_CLASSES}
    by_class["other"] = 0.0
    spans = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        cls = next((c for c, subs in KERNEL_CLASSES if any(x.lower() in name for x in subs)),
                   "other")
        by_class[cls] += (e.time_range.end - e.time_range.start) / 1e3
        spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        fail("profile: the trace holds no device time")
    # Busy time is the union of the kernels' intervals (they may overlap).
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    first, last = min(s for s, _ in spans), max(e for _, e in spans)
    emit(phase=f"profile_{parallelism}", step_wall_ms=wall_ms,
         device_span_ms=(last - first) / 1e3, device_busy_ms=busy_us / 1e3,
         idle_share=1.0 - busy_us / (last - first), kernels=len(spans),
         device_ms_by_class={k: round(v, 3) for k, v in by_class.items()})
    del model, step
    torch.cuda.empty_cache()


def main():
    smi = phase_card()
    phase_build()
    errs = phase_kernels()
    launches = phase_main(smi, "dp")
    launches.update({k: v for k, v in phase_main(smi, "tp").items() if k in MODE_KERNELS["tp"]})
    phase_parity()
    kernels = phase_timing(launches, errs)
    phase_profile("dp")
    phase_profile("tp")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
