#!/usr/bin/env python
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero and no result is printed:

  1. card     — nvidia-smi's name and power limit, torch's device name;
  2. build    — nvcc builds every kernel under
                distributed_tensorflow_tpu_torch/csrc/ (in parallel);
  3. kernels  — each kernel against its plain PyTorch version on the same
                inputs: the main path's call shape (batch 12, seq 2048, 16
                heads of 128, bf16), and a small GQA + window + rope case at
                head_dim 64 with a ragged sequence, in bf16 and f32;
  4. main     — the trainer (cli/train_lm.py) at the bench flagship's full
                width and depth (d_model 2048, 16 heads, 8 layers, d_ff 8192,
                seq 2048, batch 12, bias-free, flash attention) for 6 steps:
                finite loss at every boundary, and exactly 8 forward and 8
                backward kernel launches per step;
  5. parity   — one step at flagship width (batch 2) through the kernels and
                through plain dense attention, same weights and tokens;
  6. timing   — each kernel at the main path's call shape beside its plain
                version, its bound on this card and the library's nearest
                call (scaled_dot_product_attention, forward for the forward
                kernel and forward+backward for the backward kernel, with
                its backward alone beside it; its top-left causal alignment
                agrees with ours because Sq == Skv);
  7. profile  — one flagship training step under torch.profiler: device
                time by kernel class and the device's idle share.

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
REPLACES = {
    "flash_fwd": "distributed_tensorflow_tpu/ops/attention.py:1660 (_flash_kernel via "
                 "_flash_forward_qkv)",
    "flash_bwd": "distributed_tensorflow_tpu/ops/attention.py:1796 (_flash_bwd_fused_kernel "
                 "via _flash_backward_qkv)",
}


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
        lines = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
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
    tol = TOL[dtype]
    errs = {}
    for name, got, ref in (("out", out, ref_out), ("lse", lse, ref_lse), ("dqkv", dqkv, ref_dqkv)):
        if not torch.isfinite(got).all():
            fail(f"{case}: non-finite {name}")
        abs_err, rel_err = _err(got, ref)
        measure = abs_err if name == "lse" else rel_err
        ok = measure <= tol[name]
        emit(phase="kernels", case=case, tensor=name, dtype=str(dtype).split(".")[-1],
             max_abs_err=abs_err, rel_err=rel_err, tol=tol[name],
             tol_kind="abs" if name == "lse" else "rel", ok=ok)
        if not ok:
            fail(f"{case}: {name} error {measure:.3g} > {tol[name]}")
        errs[name] = abs_err
    return errs


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fl = FLAGSHIP
    dh = fl["d_model"] // fl["num_heads"]
    flagship = compare("flagship", fl["batch_size"], fl["seq_len"], fl["num_heads"],
                       fl["num_heads"], dh, torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):
        compare("gqa_window_rope_d64", 2, 200, 8, 2, 64, dtype, window=100, rope=True, seed=1)
    compare("noncausal_gqa_d128", 1, 136, 4, 2, 128, torch.float32, causal=False, seed=2)
    return flagship


def phase_main(smi):
    from distributed_tensorflow_tpu_torch.cli import train_lm

    fl = FLAGSHIP
    argv = [
        "--d_model", str(fl["d_model"]), "--num_heads", str(fl["num_heads"]),
        "--num_layers", str(fl["num_layers"]), "--d_ff", str(fl["d_ff"]),
        "--seq_len", str(fl["seq_len"]), "--batch_size", str(fl["batch_size"]),
        "--use_bias", "0", "--attention", "flash", "--training_steps", str(STEPS),
        "--eval_step_interval", str(INTERVAL), "--device", "cuda",
    ]
    for k in A.KERNEL_LAUNCHES:
        A.KERNEL_LAUNCHES[k] = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train_lm.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(A.KERNEL_LAUNCHES)
    records = [json.loads(line) for line in buf.getvalue().splitlines()]
    for r in records:
        emit(phase="main", **r)
    if [r["step"] for r in records] != list(range(INTERVAL, STEPS + 1, INTERVAL)):
        fail(f"main: unexpected boundaries {[r['step'] for r in records]}")
    if not all(r["loss"] == r["loss"] and abs(r["loss"]) < float("inf") for r in records):
        fail("main: non-finite loss")
    want = {"flash_fwd": fl["num_layers"] * STEPS, "flash_bwd": fl["num_layers"] * STEPS}
    emit(phase="main", launches=launches, expected=want, wall_s=round(wall, 2))
    if launches != want:
        fail(f"main: kernel launches {launches}, expected {want}")
    last = records[-1]
    if "steps_per_sec" not in last:
        fail("main: no timed window")
    emit(phase="main", steps_per_sec=last["steps_per_sec"],
         tokens_per_sec=last["tokens_per_sec"], mfu=last.get("mfu"), card=smi)
    return launches


def phase_parity():
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        next_token_loss,
    )

    fl = FLAGSHIP
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, 256, (2, fl["seq_len"]), device="cuda", generator=gen)
    results = {}
    for attention in ("flash", "dense"):
        cfg = TransformerConfig(
            vocab_size=256, d_model=fl["d_model"], num_heads=fl["num_heads"],
            num_layers=fl["num_layers"], d_ff=fl["d_ff"], max_seq_len=fl["seq_len"],
            use_bias=False, attention=attention, compute_dtype=torch.bfloat16,
        )
        model = TransformerLM(cfg, seed=0, device="cuda")
        loss = next_token_loss(model(tokens), tokens)
        loss.backward()
        results[attention] = (loss.item(), model.block_0.qkv.weight.grad.float().clone())
        del model
        torch.cuda.empty_cache()
    (lf, gf), (ld, gd) = results["flash"], results["dense"]
    loss_rel = abs(lf - ld) / abs(ld)
    _, grad_rel = _err(gf, gd)
    ok = loss_rel <= 1e-2 and grad_rel <= 5e-2
    emit(phase="parity", loss_flash=lf, loss_dense=ld, loss_rel_err=loss_rel, loss_tol=1e-2,
         qkv_grad_rel_err=grad_rel, grad_tol=5e-2, ok=ok)
    if not ok:
        fail("parity: flash and dense attention disagree")


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


def phase_timing(launches, errs):
    import torch.nn.functional as F

    from distributed_tensorflow_tpu_torch.utils.flops import chip_hbm_bandwidth, chip_peak_flops

    fl = FLAGSHIP
    b, s, h = fl["batch_size"], fl["seq_len"], fl["num_heads"]
    d = fl["d_model"] // h
    peak, bw = chip_peak_flops(), chip_hbm_bandwidth()
    if peak is None:
        fail(f"timing: no peak rates known for {torch.cuda.get_device_name(0)}")
    qkv, g = _packed(b, s, h, h, d, torch.bfloat16, seed=3)
    args = (h, h, True, None, None, None)
    out, lse = A.flash_forward_qkv_kernel(qkv, *args, None)

    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in qkv.split(h * d, dim=-1))
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    g4 = g.reshape(b, s, h, d).transpose(1, 2)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(ql, kl, vl, is_causal=True).backward(g4)

    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

    def sdpa_bwd():
        torch.autograd.grad(ol, (ql, kl, vl), g4, retain_graph=True)

    pairs = s * (s + 1) // 2  # attended (q, k) pairs of one causal head
    fwd_flops = 4 * b * h * d * pairs  # q·kᵀ and p·v
    elt = qkv.element_size()
    qkv_bytes, o_bytes, lse_bytes = qkv.numel() * elt, out.numel() * elt, lse.numel() * 4
    work = {
        "flash_fwd": (fwd_flops, qkv_bytes + o_bytes + lse_bytes),
        # five products against the forward's two; reads qkv, out, lse, dO,
        # writes dqkv
        "flash_bwd": (fwd_flops * 5 // 2, 2 * qkv_bytes + 2 * o_bytes + lse_bytes),
    }
    runs = {
        "flash_fwd": (
            lambda: A.flash_forward_qkv_kernel(qkv, *args, None),
            lambda: A.flash_forward_qkv_reference(qkv, *args),
            sdpa_fwd,
        ),
        "flash_bwd": (
            lambda: A.flash_backward_qkv_kernel(qkv, out, lse, g, *args, None),
            lambda: A.flash_backward_qkv_reference(qkv, out, lse, g, *args),
            sdpa_fwd_bwd,
        ),
    }
    kernels = []
    for name, (kernel, plain, library) in runs.items():
        flops, nbytes = work[name]
        t_flops, t_bytes = flops / peak * 1e3, nbytes / bw * 1e3
        rec = {
            "name": name,
            "route": "cuda",
            "source": f"distributed_tensorflow_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": time_ms(kernel, 10),
            "plain_ms": time_ms(plain, 3, warmup=1),
            "bound_ms": max(t_flops, t_bytes),
            "bound_by": "operations" if t_flops >= t_bytes else "bytes",
            "library_ms": time_ms(library, 10),
        }
        extra = {"library_bwd_only_ms": time_ms(sdpa_bwd, 10)} if name == "flash_bwd" else {}
        emit(phase="timing", shape=dict(B=b, S=s, H=h, KV=h, D=d, dtype="bf16", causal=True),
             flops=flops, bytes=nbytes, **rec, **extra)
        kernels.append(rec)
    return kernels


# Kernel-name substrings → class, checked in order (cuBLAS's Hopper GEMMs
# are named nvjet_*, sm90_xmma_* or *gemm*).
KERNEL_CLASSES = (
    ("flash_fwd", ("dtt::flash_fwd",)),
    ("flash_bwd", ("dtt::flash_bwd",)),
    ("matmul", ("nvjet", "gemm", "xmma", "cutlass")),
    ("layer_norm", ("layer_norm",)),
    ("optimizer", ("multi_tensor", "foreach", "adam")),
    ("cross_entropy", ("softmax", "nll_loss")),
)


def phase_profile():
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from distributed_tensorflow_tpu_torch.parallel.data_parallel import build_lm_train_step
    from distributed_tensorflow_tpu_torch.train.optimizers import make_optimizer

    fl = FLAGSHIP
    cfg = TransformerConfig(
        vocab_size=256, d_model=fl["d_model"], num_heads=fl["num_heads"],
        num_layers=fl["num_layers"], d_ff=fl["d_ff"], max_seq_len=fl["seq_len"],
        use_bias=False, attention="flash", compute_dtype=torch.bfloat16,
    )
    model = TransformerLM(cfg, seed=0, device="cuda")
    step = build_lm_train_step(model, make_optimizer("adam", model.parameters(), 3e-3, 10))
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
    emit(phase="profile", step_wall_ms=wall_ms, device_span_ms=(last - first) / 1e3,
         device_busy_ms=busy_us / 1e3, idle_share=1.0 - busy_us / (last - first),
         kernels=len(spans), device_ms_by_class={k: round(v, 3) for k, v in by_class.items()})


def main():
    smi = phase_card()
    phase_build()
    errs = phase_kernels()
    launches = phase_main(smi)
    phase_parity()
    kernels = phase_timing(launches, {"flash_fwd": errs["out"], "flash_bwd": errs["dqkv"]})
    phase_profile()
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
