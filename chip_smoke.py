#!/usr/bin/env python
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero and no result is printed:

  1. card      — nvidia-smi's name and power limit, torch's device name;
  2. build     — nvcc builds every kernel under
                 distributed_tensorflow_tpu_torch/csrc/ (in parallel), with
                 each instance's registers and spills and ptxas's wgmma
                 advisories, and a summary of the head_dim 256 instances
                 and of the column-group kernels (head_dim above 256);
  3. kernels   — each kernel against its plain PyTorch version on the same
                 inputs, by a max-based and a blockwise normwise limit (see
                 TOL and BLOCK_TOL). One CUDA kernel per direction serves
                 every layout, and the two-pass pair adds a dq kernel.
                 Packed-qkv wrappers (K1/K2): the dp path's call shape (batch
                 12, seq 2048, 16 heads of 128, bf16), and a small GQA +
                 window + rope case at head_dim 64 with a ragged sequence, in
                 bf16 and f32. BHSD wrappers (K3/K4): the tp path's call
                 shape (the head-transposed views the tp block hands over)
                 with planted-fault controls, cross-length causal with a
                 window in bf16 and f32, Sq > Skv with fully masked rows,
                 non-causal at head_dim 128 in f32, and K4 on q segments
                 against one whole call. The long-sequence family (K7
                 forward, K8 fused backward on q segments, K5/K6 two-pass
                 pair) on BSHD operands: the long path's segment call (seq
                 8192, 4 query heads on one kv head of 128, bf16, rope θ
                 500000, four segments), GQA + window + cross-length + rope
                 in bf16 and f32, non-causal, fully masked rows, and planted
                 faults in K8's, K5's and K6's products, and the delta K6
                 leaves for K5. Every bf16 case at head_dim 64/128 runs the
                 warpgroup kernels (flash_fwd_sm90.cu forward,
                 flash_bwd_sm90.cu backward, K6 included, and
                 flash_bwd_dq_sm90.cu for K5, each case checking K5's
                 source), with extra
                 cases for them: the backward non-causal, cross-length and
                 fully masked; the forward non-causal with GQA, on a q
                 segment placed by q_pos_offset, with window + GQA + rope,
                 with fully masked rows, at a ragged length, its rotate pass
                 bit for bit against its plain version (at the long call and
                 with per-batch tables), and a dropped kv tile in its last
                 step's P·V that the blockwise check must catch; K6 bf16
                 non-causal and fully masked. Head_dim 32 (an instance) and
                 80 (padded to 128) at the CLI's call shape, packed and BHSD,
                 bf16 and f32; head_dim 256 (an instance of its own) and
                 160/192 (padded to 256): K1/K2 at Gemma 7B's attention width
                 (16 heads of 256, seq 2048), with GQA and rope at a ragged
                 length, K3/K4 with fully masked rows and cross-length, K5-K8
                 with GQA, window, rope and cross-length and with fully
                 masked rows, in bf16 and f32; then, for the warpgroup
                 kernels at 256 (bf16), packed GQA + window + rope at a
                 ragged length, the forward with GQA + window + rope,
                 cross-length on a q segment, with fully masked rows and
                 non-causal, K4 non-causal cross-length, K4 on q segments
                 placed by q_pos_offset against one whole call, the rotate
                 pass bit for bit, the `wide` path's own calls at its full
                 shape (K1 with rope on packed qkv, its backward's eight K8
                 segment calls on dqkv, and the timed last-segment call's dq
                 rows and dk/dv shares; the plain versions one batch row at
                 a time), the long family at that length (K7, K8 on eight
                 q segments, K5, K6 and its delta, 4 heads), and planted
                 faults: a
                 dropped kv tile in each product and one warpgroup's column
                 half of dK zeroed; K5 on the warpgroup dq kernel at Gemma
                 7B's width with rope, with GQA + window, and with a
                 dropped kv tile and one warpgroup's column half of dq.
                 Every bf16 launch at 160-256 must run flash_fwd_sm90.cu,
                 flash_bwd_sm90.cu or flash_bwd_dq_sm90.cu, every f32 one
                 flash_fwd.cu, flash_bwd.cu or flash_bwd_dq.cu.
                 Head dims above 256, on the column-group kernels
                 (flash_fwd_dstream.cu, flash_bwd_dstream.cu with and
                 without dq, flash_bwd_dq_dstream.cu; the bf16 forward at
                 384 and 512 on the warpgroup kernel
                 flash_fwd_cols_sm90.cu), in bf16 and f32:
                 320, 384 and 512, 300 without rope and 257 (odd, padded at
                 the tail), packed GQA + window + rope, BHSD cross-length
                 with a window and non-causal, fully masked rows, the long
                 family (K7, K8 on q segments, K5, K6) with GQA + window +
                 cross-length + rope, K4 on q segments against one whole
                 call; planted faults at 512 (a dropped kv tile in each
                 product, one column group's P·V and one D chunk of q·kᵀ
                 dropped) and the D 512 call the timing phase times; the
                 warpgroup forward from dh 320 and at 384/512 with GQA +
                 window + rope, on a q segment, with fully masked rows,
                 non-causal, and planted faults (one warpgroup's half of
                 P·V, one D half of q·kᵀ), K10 on head views at 512, and
                 bf16 at 640 on the column-group forward; K6 at 384 and
                 512 on the warpgroup kernel flash_bwd_cols_sm90.cu with
                 GQA + window + rope cross-length (384), rope on a q
                 segment (from 320), a window on a q segment (512), kv
                 rows no q row sees exactly 0, and planted faults (a
                 dropped q tile, one warpgroup's columns, one of the two
                 column blocks, in dK and in dV) at 512 and 384; K5 at
                 384 and 512 on the warpgroup kernel
                 flash_bwd_dq_cols_sm90.cu with GQA + window + rope (from
                 320), rope on a cross-length q segment (512), rows that
                 attend nothing exactly 0, non-causal cross-length (384),
                 and planted faults (a dropped
                 32-key tile in dS·K, one warpgroup's column half of dq)
                 at 512 and 384; every
                 launch on the source its dtype and head dim name. Then K9 at dh 80
                 (padded to 128), 256 and 320 (the shipped forward), bf16
                 and f32, against its plain version and against K3 (bit
                 for bit or not, recorded), with fully masked rows,
                 non-causal and a planted fault at 256;
  4. main      — the trainer (cli/train_lm.py) for 6 steps on each main path:
                 dp and tp (--model_parallel 1, a world of one) at the bench
                 flagship's full width and depth (d_model 2048, 16 heads, 8
                 layers, d_ff 8192, seq 2048, batch 12, bias-free, flash
                 attention), long-context training (the same width with
                 4 kv heads, seq 8192, batch 3, rope θ 500000), and `wide`,
                 Gemma 7B's attention at its context (16 heads of 256 on 16
                 kv heads, rope θ 10000, seq 8192, batch 2, d_model 4096,
                 d_ff 16384, 8 layers): finite loss at every boundary and
                 exactly the path's launches per step (8 + 8 of dp's or tp's
                 pair; 8 K1 and 32 K8 on the long path; 8 K1 and 64 K8 on
                 `wide`) and none of any other kernel, every launch on the
                 warpgroup kernels (flash_fwd_sm90.cu, flash_bwd_sm90.cu) and
                 none on flash_fwd.cu or flash_bwd.cu; `wide` again for 3
                 steps with both directions forced to flash_fwd.cu and
                 flash_bwd.cu (its "was" reading); then the trainer at its
                 own defaults (head_dim 32: flash_fwd.cu and flash_bwd.cu),
                 at head_dim 80 and at head_dim 256 (d_model 1024 over 4
                 heads, its loss falling), both on the warpgroup kernels, 4
                 steps each; then `d512`, the flagship's width over 4 heads
                 of 512 (lr 1e-4, 6 steps, its loss falling): exactly 8 K1,
                 8 K5 and 8 K6 launches a step (the gate's two-pass route at
                 head_dim 512), on flash_fwd_cols_sm90.cu,
                 flash_bwd_dq_cols_sm90.cu and flash_bwd_cols_sm90.cu;
     pipeline  — pp, 3d and --remat at the flagship on one card (6 steps
                 each, phase 4's seed and flags): pp with one stage and 2
                 microbatches (exactly 2 x 8 K1 and 2 x 8 K2 launches a
                 step, on flash_fwd_sm90.cu and flash_bwd_sm90.cu, its
                 losses within cli/tp_cards.py's LOSS_TOL of dp's), 3d on
                 one rank (data 1 x pipe 1 x model 1, 2 microbatches: 2 x 8
                 K3 and 2 x 8 K4 a step, losses within LOSS_TOL of tp's),
                 and dp with --remat (2 x 8 K1, the recompute, and 8 K2 a
                 step, losses within LOSS_TOL of dp's); steps/s, tokens/s,
                 MFU and the peak device memory of each run beside dp's;
     train_dir — checkpoints, resume, export and eval at the flagship's
                 full width, byte-level on a file of the repo's own text,
                 every run at learning rate TRAIN_DIR_LR (1e-4):
                 run A trains 8 steps with --train_dir (only the forced
                 final save fires) and commits step 8; run B, the same
                 command to step 12 with --output, restores step 8 (the
                 restored state, saved again, equal to the step bitwise),
                 makes exactly 4 steps x 8 layers of K1 and K2 launches on
                 flash_fwd_sm90.cu and flash_bwd_sm90.cu, commits step 12
                 and writes the bundle; run C trains 12 steps straight, its
                 loss within 1e-2 of B's; a flagship model and its fused
                 Adam saved through CheckpointManager and restored into
                 fresh objects bitwise (parameters, moments, step, the
                 schedule's count), with the save, restore and export
                 seconds and bytes; cli/eval_lm.py on the bundle on the card
                 and on the CPU (two holdout windows, nll within 2e-2);
                 then --train_dir under pp and 3d (one stage, one rank),
                 sp and sp_tp (a world of one) at the flagship's width, 2
                 of its 8 layers: run A commits step 3, run B restores it
                 (bitwise, as above; exactly 3 steps of the mode's launches: pp K1/K2, 3d
                 K3/K4, sp and sp_tp none) and commits step 6, its loss
                 within 1e-2 of run C's, 6 steps straight; save seconds and
                 bytes, restore seconds;
     seq_parallel — the modes that attend without a flash kernel, at the
                 flagship byte-level on the repo's text, 6 steps each: dp
                 with --attention blockwise, sp and sp_tp in a world of one
                 (the ring as one hop); every launch count stays 0 while
                 they train, and each first-step loss is within 1e-2 of the
                 flash forward's on the same seed's weights and batch;
                 steps/s, tokens/s, MFU and peak memory; then sp at the
                 long recipe (seq 8192, rope θ 500000, 4 kv heads, batch 3,
                 cut to 2 or 1 only if it does not fit, the cut printed),
                 its losses within LOSS_TOL of phase 4's long path;
     serve     — the serving core at the flagship's width: weights from a
                 seed exported to a bundle and served by cli/serve_lm.py's
                 build_stack (8 slots, page 16, prefix cache, buckets 64 and
                 256 under prefill_len 1024, chunk 512); 16 concurrent HTTP
                 requests (16-1,500 tokens, half on a 512-token prefix, 64
                 new tokens, 12 greedy, 4 sampled, 2 streamed) with the
                 engine's logit trace on; no flash kernel launched while
                 serving; every request's logits within SERVE_TOL of the
                 uncached forward on K1 over its prompt and tokens, greedy
                 tokens its argmax but at near-ties (counted), sampled ones
                 inside their top_k/top_p support; compile_count flat, every
                 page back after the prefix cache's eviction; TTFT, time per
                 output token, decode tokens/s at 1 and 8 slots (and with
                 per-call weight casts), cold against prefix-hit TTFT, pool
                 bytes; the long recipe (2 layers) on a 6,000-token prompt
                 through chunked prefill against K1; cli/serve_lm.py --demo
                 as a subprocess, one /generate and /healthz, SIGTERM;
     serve_variants — serving as it is deployed, at SERVE's flagship: the
                 target quantized by cli/quantize_lm.py; int8 weights, int4
                 at group 64, the int8 KV cache, n-gram spec (k 4), tree
                 spec (k 4, 3 branches) and a learned drafter (2 layers from
                 init_draft_params, k 4, window 16), each through
                 build_stack with 16 concurrent HTTP requests: logits
                 against K1's uncached forward (quantized: on the
                 dequantized weights; int8 KV: within KV8_TOL; spec: each
                 greedy token its verify row's argmax), sampled tokens in
                 their support, compile_count flat, every page freed,
                 weight_bytes_per_device == tree_bytes of the quantized
                 tree, no K1-K10 launch; decode round ms and tokens/s at 1
                 and 8 slots, acceptance per drafter, pool bytes per token;
                 the port's tools/loadgen.py self-served (8 concurrent, 32
                 requests, then open loop at 1.5x), --smoke, 0 errored;
  5. routes    — one long-context step (batch 1, 2 layers) through the three
                 backward routes the gate can take (K8 segments, K2 whole,
                 K5/K6 two-pass) on the same weights: equal launches to the
                 route (K6 on flash_bwd_sm90.cu), losses and gradients
                 agreeing; then the public
                 flash_attention_bshd forward and backward at one batch row
                 of the long call (one K7 launch, four K8 segments) against
                 the plain versions;
     parity    — one step at flagship width (batch 2, 2 of its 8 layers)
                 through the kernels and
                 through plain dense attention, same weights and tokens: the
                 dp model, and the tp model against the dp model (its fused
                 qkv weight split into q/k/v) and against dense attention;
                 and one step at the `wide` width (2 layers, batch 1, seq
                 2048: K8 on two q segments) against dense attention;
  6. turns     — the warpgroup kernels against the bf16 instances of the
                 kernels they replaced (flash_fwd.cu, flash_bwd.cu,
                 flash_bwd_dq.cu), in turns (new, old, old, new) at the K1,
                 K2, K3, K4, long K7, K8, K6 and K5 calls, K1 with rope at
                 the long call, K1 and K2 at head_dim 256 (Gemma 7B's width,
                 seq 2048), and K1 with rope and one K8 segment call (the
                 last, 1024 q rows against 8192 keys) at the `wide` call;
     timing    — each kernel at its path's call shape beside its plain
                 version, its bound on this card and the library's nearest
                 call (scaled_dot_product_attention, forward for a forward
                 kernel and forward+backward for a fused backward kernel,
                 with its backward alone beside it; its top-left causal
                 alignment agrees with ours because Sq == Skv, and the K8
                 segment row passes its end-aligned mask); K5-K8 at the
                 long path's call (batch 3, seq 8192, 16 heads on 4 kv
                 heads), K1 with rope at the long path's call (a row of its
                 own), K1/K2 at head_dim 256 (Gemma 7B's width, rows of
                 their own), K1 with rope and the K8 segment call at the
                 `wide` call, K1/K2 at head_dim 32 (the CLI's call, with each
                 call's device time by the profiler beside the back-to-back
                 reading), the three backward routes of one long layer, and
                 the rows above 256: K1 (flash_fwd_cols_sm90.cu, against
                 flash_fwd_dstream.cu in turns), K2, K5 and K6 at head_dim
                 512 (B 2, S 2048, 4 heads, packed qkv), K8 at head_dim 320
                 on the last of its two q segments, K1 at head_dim 320 (in
                 turns too), with SDPA's kernels' names (it has no flash
                 backend above 256), and K5 at head_dim 256
                 (flash_bwd_dq_sm90.cu against flash_bwd_dq.cu in turns,
                 Gemma 7B's width), and K6 and K5 at 512 and 384
                 (flash_bwd_cols_sm90.cu against flash_bwd_dstream.cu and
                 flash_bwd_dq_cols_sm90.cu against flash_bwd_dq_dstream.cu
                 in turns); and one layer's backward at the `wide`
                 call through each of the three routes (K2 whole, K8 on
                 eight segments, K6 + K5), forced through the gate's hooks;
     host_dispatch — the wrappers' host pieces at the CLI's call (K1 and K2
                 at head_dim 32), each timed over 1000 calls, beside a
                 whole call's host time, its back-to-back time and SDPA's
                 (in turns, and one reading of 10 calls each);
  7. probes    — the two kernel probes (tools/pipeline_probe.py and
                 tools/bshd_probe.py of the port): K9, the forward in the
                 probe's issue order (flash_fwd_pipe_sm90.cu in bf16),
                 against its plain version at both probe shapes (bf16) and
                 at ragged, cross-length, fully masked and non-causal cases
                 in bf16 and f32, with a planted fault in the last kv tile
                 of its P.V (the tile its last step handles), within
                 PARITY_TOL of K3 (and whether bit for bit), against
                 flash_fwd_pipe.cu in turns, and against K3 in turns — the
                 probe's verdict on which issue order wins (and the same,
                 but the old kernel, at head_dim 256, Gemma 7B's width); K10, the
                 forward on (B, S, H·dh) views, equal bit for bit to K3 on a
                 contiguous copy and held against its plain version; both
                 timed like phase 6; then each probe's main() as a
                 subprocess, which must exit 0 having launched its kernel;
  8. profile   — one training step of each main path (`wide` included) under
                 torch.profiler: device time by kernel class and the
                 device's idle share.

Then a line with nvidia-smi's name and power limit, a JSON line with the
kernels' numbers, and last ``{"ok": true, "device": {...}}``. Needs one
card and no network.

    python3 chip_smoke.py --serve

runs the card line and the serve phase alone;

    python3 chip_smoke.py --seq

the card line, phase seq_parallel and the extended train_dir runs alone.

    python3 chip_smoke.py --spread

the card line and, for a few seeds, two uninterrupted runs of each
train_dir phase's command and how far apart their last losses end, at the
trainer's default learning rate and at TRAIN_DIR_LR.

    python3 chip_smoke.py --dispatch [--tree DIR]

times whole calls through the public wrappers (K1/K2 at head_dim 32 beside
SDPA, K1 at head_dim 320) and the trainer at its defaults for 400 steps, on
this checkout's package or, with ``--tree``, on checkout DIR's (a parent
commit unpacked by ``git archive``), so that two trees compare on one card.
"""

import contextlib
import io
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device visible to torch")
# ``--dispatch --tree DIR``: time the package of another checkout (e.g. the
# parent commit's, unpacked by `git archive`) instead of this one.
TREE = sys.argv[sys.argv.index("--tree") + 1] if "--tree" in sys.argv else None
if TREE is not None:
    sys.path.insert(0, os.path.abspath(TREE))

from distributed_tensorflow_tpu_torch.ops import _build  # noqa: E402
from distributed_tensorflow_tpu_torch.ops import attention as A  # noqa: E402
from distributed_tensorflow_tpu_torch.utils.timer import cuda_ms  # noqa: E402

FLAGSHIP = dict(d_model=2048, num_heads=16, num_layers=8, d_ff=8192, seq_len=2048,
                batch_size=12)
# Long-context training: the Llama-3 recipe (8192 context, rope theta 500000,
# 4 query heads per kv head) at the flagship's width; batch 3 keeps its
# 24576 tokens a step.
LONG = dict(FLAGSHIP, num_kv_heads=4, seq_len=8192, batch_size=3, rope_theta=500000.0)
# `wide`: Gemma 7B's attention at its context (its config.json: head_dim 256,
# 16 attention heads on 16 kv heads, max_position_embeddings 8192,
# rope_theta 10000) in the repo's block: d_model 4096 (the model ties it to
# heads x head_dim, where Gemma has 3072), LayerNorm and a GELU MLP at 4x
# (d_ff 16384), 8 of its 28 layers, batch 2 (16,384 tokens a step).
WIDE = dict(d_model=4096, num_heads=16, num_layers=8, d_ff=16384, seq_len=8192, batch_size=2,
            rope_theta=10000.0)
# `d512`: the flagship's width over 4 heads of 512 (`--num_heads 4`), the
# head_dim a user meets at `--d_model 2048 --num_heads 4`; above 256 every
# call runs the column-group kernels, and at head_dim 512 the backward's gate
# takes the two-pass pair (K5 + K6) at seq 2048.
D512 = dict(FLAGSHIP, num_heads=4)
SHAPES = {"dp": FLAGSHIP, "tp": FLAGSHIP, "long": LONG, "wide": WIDE, "d512": D512}
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
    "bshd_fwd": "distributed_tensorflow_tpu/ops/attention.py:1261 (_flash_kernel via "
                "_flash_forward_bshd)",
    "bshd_bwd": "distributed_tensorflow_tpu/ops/attention.py:1347 (_flash_bwd_fused_kernel "
                "via _flash_backward_fused_bshd)",
    "bwd_dq": "distributed_tensorflow_tpu/ops/attention.py:1114 (_flash_bwd_dq_kernel via "
              "_flash_backward)",
    "bwd_dkv": "distributed_tensorflow_tpu/ops/attention.py:1140 (_flash_bwd_dkv_kernel via "
               "_flash_backward)",
    "flash_fwd": "distributed_tensorflow_tpu/ops/attention.py:1660 (_flash_kernel via "
                 "_flash_forward_qkv)",
    "flash_bwd": "distributed_tensorflow_tpu/ops/attention.py:1796 (_flash_bwd_fused_kernel "
                 "via _flash_backward_qkv)",
    "bhsd_fwd": "distributed_tensorflow_tpu/ops/attention.py:481 (_flash_kernel via "
                "_flash_forward)",
    "bhsd_bwd": "distributed_tensorflow_tpu/ops/attention.py:1004 (_flash_bwd_fused_kernel "
                "via _flash_backward_fused)",
    "pipe_fwd": "tools/pipeline_probe.py:169 (_pipe_fwd_kernel via pipe_flash_forward)",
    "probe_bshd_fwd": "tools/bshd_probe.py:49 (_flash_kernel of distributed_tensorflow_tpu/ops/"
                      "attention.py via bshd_forward)",
}
# K1 with rope at the long path's call, K1/K2 at head_dim 256 and at 32, and
# the `wide` path's K1 with rope and K8 segment call have timing rows of
# their own.
REPLACES.update({row: REPLACES["flash_fwd"] for row in (
    "flash_fwd_rope", "flash_fwd_d256", "flash_fwd_d32", "flash_fwd_rope_d256_wide")})
REPLACES.update({row: REPLACES["flash_bwd"] for row in ("flash_bwd_d256", "flash_bwd_d32")})
REPLACES["bshd_bwd_d256_wide"] = REPLACES["bshd_bwd"]
# The rows above head_dim 256: K1 at 512 and 320 (padded to 384) on the
# warpgroup forward flash_fwd_cols_sm90.cu, K5 and K6 at 512 and 384 on
# their warpgroup kernels, K2 at 512 and K8 at 320 on the column-group
# kernels; K5 at 256 on the warpgroup dq kernel; K9 at 256.
REPLACES.update({"flash_fwd_d512": REPLACES["flash_fwd"], "flash_bwd_d512": REPLACES["flash_bwd"],
                 "bwd_dq_d512": REPLACES["bwd_dq"], "bwd_dkv_d512": REPLACES["bwd_dkv"],
                 "bshd_bwd_d320": REPLACES["bshd_bwd"], "bwd_dq_d256": REPLACES["bwd_dq"],
                 "flash_fwd_d320": REPLACES["flash_fwd"], "pipe_fwd_d256": REPLACES["pipe_fwd"],
                 "bwd_dkv_d384": REPLACES["bwd_dkv"], "bwd_dq_d384": REPLACES["bwd_dq"]})
# The wrappers' launch counters and the source each one launches at the
# main paths' calls (bf16, head_dim 64, 128 or 256): every layout goes
# through one forward and one fused backward kernel, as the TPU's do — the
# warpgroup kernels flash_fwd_sm90.cu and flash_bwd_sm90.cu
# (attention.forward_kernel, attention.backward_kernel; f32 and head_dim 32
# calls take flash_fwd.cu and flash_bwd.cu); the two-pass pair is
# flash_bwd_dq_sm90.cu (K5; attention.backward_dq_kernel, f32 and D 32 on
# flash_bwd_dq.cu) and flash_bwd_sm90.cu with dq compiled out (K6).
# The BSHD probe (K10) is the forward on head views; the pipelining probe
# (K9) has a kernel of its own, flash_fwd_pipe_sm90.cu in bf16
# (attention.pipe_forward_kernel; f32 on flash_fwd_pipe.cu). The head_dim 32
# rows run the plain-design kernels; above 256 the bf16 forward at 384 and
# 512 runs flash_fwd_cols_sm90.cu, K6 there flash_bwd_cols_sm90.cu, K5
# flash_bwd_dq_cols_sm90.cu, the fused backward the column-group kernel. A
# main path's launches by source must be exactly what this map makes of its
# launches by wrapper.
SOURCES = {"flash_fwd": "flash_fwd_sm90", "bhsd_fwd": "flash_fwd_sm90",
           "bshd_fwd": "flash_fwd_sm90", "flash_bwd": "flash_bwd_sm90",
           "bhsd_bwd": "flash_bwd_sm90", "bshd_bwd": "flash_bwd_sm90",
           "bwd_dq": "flash_bwd_dq_sm90", "bwd_dkv": "flash_bwd_sm90",
           "pipe_fwd": "flash_fwd_pipe_sm90", "probe_bshd_fwd": "flash_fwd_sm90",
           "flash_fwd_rope": "flash_fwd_sm90", "flash_fwd_d256": "flash_fwd_sm90",
           "flash_bwd_d256": "flash_bwd_sm90", "flash_fwd_rope_d256_wide": "flash_fwd_sm90",
           "bshd_bwd_d256_wide": "flash_bwd_sm90", "flash_fwd_d32": "flash_fwd",
           "flash_bwd_d32": "flash_bwd", "flash_fwd_d512": "flash_fwd_cols_sm90",
           "flash_bwd_d512": "flash_bwd_dstream", "bwd_dq_d512": "flash_bwd_dq_cols_sm90",
           "bwd_dq_d384": "flash_bwd_dq_cols_sm90",
           "bwd_dkv_d512": "flash_bwd_cols_sm90", "bwd_dkv_d384": "flash_bwd_cols_sm90",
           "bshd_bwd_d320": "flash_bwd_dstream",
           "bwd_dq_d256": "flash_bwd_dq_sm90", "flash_fwd_d320": "flash_fwd_cols_sm90",
           "pipe_fwd_d256": "flash_fwd_pipe_sm90"}
# The sources `wide`'s "was" run forces: the plain-design kernels.
PLAIN_DESIGN = {"flash_fwd_sm90": "flash_fwd", "flash_bwd_sm90": "flash_bwd"}
# Where every bf16 launch at head_dim 384 or 512 goes instead: the forward to
# the warpgroup kernel flash_fwd_cols_sm90.cu, K6 (the wrapper bwd_dkv: a
# wrapper's entry comes before its source's) to the warpgroup kernel
# flash_bwd_cols_sm90.cu, K5 to the warpgroup kernel
# flash_bwd_dq_cols_sm90.cu, the fused backward to the column-group kernel.
# f32 above 256 runs the column-group kernels in all three (DSTREAM_F32).
DSTREAM = {"flash_fwd_sm90": "flash_fwd_cols_sm90", "flash_bwd_sm90": "flash_bwd_dstream",
           "flash_bwd_dq_sm90": "flash_bwd_dq_cols_sm90", "bwd_dkv": "flash_bwd_cols_sm90"}
DSTREAM_F32 = dict(DSTREAM, flash_fwd_sm90="flash_fwd_dstream",
                   flash_bwd_dq_sm90="flash_bwd_dq_dstream", bwd_dkv="flash_bwd_dstream")
# Each main path: its trainer flags, its launches per layer per step (every
# other counter must stay at 0) and the map of SOURCES' sources to those its
# launches run instead (None: SOURCES as it stands). The long path's
# backward runs the fused kernel on four q segments of 2048 rows, `wide`'s on
# eight of 1024 (the JAX package's gate at head_dim 128 and 256); at head_dim
# 512 `d512`'s takes the two-pass pair.
MAIN_PATHS = {
    "dp": ([], {"flash_fwd": 1, "flash_bwd": 1}, None),
    "tp": (["--parallelism", "tp", "--model_parallel", "1"], {"bhsd_fwd": 1, "bhsd_bwd": 1},
           None),
    "long": (["--num_kv_heads", "4", "--position", "rope", "--rope_theta", "500000"],
             {"flash_fwd": 1, "bshd_bwd": 4}, None),
    # At the CLI's default rate (3e-3) the flagship's loss rises over its
    # first 6 steps; `wide` and `d512` must show a falling one, at a rate for
    # their widths.
    "wide": (["--position", "rope", "--rope_theta", "10000", "--learning_rate", "1e-4"],
             {"flash_fwd": 1, "bshd_bwd": 8}, None),
    "d512": (["--learning_rate", "1e-4"], {"flash_fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}, DSTREAM),
}


def expected_sources(launches, forced=None):
    """The launches by source (``attention.SOURCE_LAUNCHES``) that wrapper
    ``launches`` make on the main paths' calls, by :data:`SOURCES`, each
    source replaced by the wrapper's entry in ``forced`` where it has one,
    else by the source's."""
    forced = forced or {}
    out = {src: 0 for src in A.SOURCE_LAUNCHES}
    for name, n in launches.items():
        src = SOURCES[name]
        out[forced.get(name, forced.get(src, src))] += n
    return out


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
                 if "registers" in ln or "spill" in ln or "entry function" in ln
                 or "C75" in ln]  # ptxas's wgmma advisories (serialised products)
        emit(phase="build", kernel=name, library=str(_build.library_path(name).name),
             nvcc_seconds=_build.BUILD_SECONDS.get(name), ptxas=lines)
    emit(phase="build", seconds=round(seconds, 2))
    for name in ("flash_fwd_sm90", "flash_bwd_sm90"):
        for rec in _ptxas_instances(_build.build_log(name)):
            if "ILi256E" in rec["entry"] or "cols_kernel" in rec["entry"]:
                emit(phase="build", kernel=name, head_dim=256, **rec)
    # The head_dim 256 instances of K5 and K9 (the f32 K9 on flash_fwd_pipe.cu).
    for name, key in (("flash_bwd_dq_sm90", "cols_kernel"), ("flash_fwd_pipe_sm90", "Li256E"),
                      ("flash_fwd_pipe", "Li256E")):
        for rec in _ptxas_instances(_build.build_log(name)):
            if key in rec["entry"]:
                emit(phase="build", kernel=name, head_dim=256, **rec)
    # The kernels above head_dim 256: the column-group kernels (head dim taken
    # at run time) and the warpgroup forward at 384 and 512.
    for name in sorted(set(DSTREAM.values()) | set(DSTREAM_F32.values())):
        for rec in _ptxas_instances(_build.build_log(name)):
            emit(phase="build", kernel=name, head_dim="above 256", **rec)


def _ptxas_instances(log):
    """Each kernel instance of an ``nvcc -Xptxas -v`` report: its mangled
    entry name, registers, spill stores and loads (bytes), and ptxas's
    wgmma advisories (C75xx) that name it."""
    instances = []
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            instances.append({"entry": ln.split("'")[1], "registers": None, "spill_stores": None,
                              "spill_loads": None})
        elif instances and "spill stores" in ln:
            stores, loads = re.findall(r"(\d+) bytes spill", ln)
            instances[-1].update(spill_stores=int(stores), spill_loads=int(loads))
        elif instances and re.search(r"Used \d+ registers", ln):
            instances[-1]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    for rec in instances:
        rec["wgmma_advisories"] = [ln.strip() for ln in log.splitlines()
                                   if "C75" in ln and rec["entry"] in ln]
    return instances


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
    """Kernel vs plain version, forward and backward, on the same inputs;
    ``rope="per_batch"`` gives each batch row its own positions (tables
    (B, S, d/2)). Returns the max abs errors of out and dqkv."""
    from distributed_tensorflow_tpu_torch.ops.rope import rope_tables

    qkv, g = _packed(b, s, h, kv, d, dtype, seed)
    cos = sin = None
    if rope == "per_batch":
        positions = torch.arange(s, device="cuda") + 37 * torch.arange(b, device="cuda")[:, None]
        cos, sin = rope_tables(d, s, 10000.0, positions=positions)
    elif rope:
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


def _masked_rows(case, lse, ref_lse, *zero):
    """The rows that attend no key (by the plain version's lse): there the
    kernel's lse must be NEG_INF and each tensor of ``zero`` exactly 0.
    Returns their mask."""
    dead = ref_lse <= A.NEG_INF / 2
    if dead.any():
        if not (lse[dead] <= A.NEG_INF / 2).all() or any((t[dead] != 0).any() for t in zero):
            fail(f"{case}: fully masked rows must give exact zeros and lse NEG_INF")
        emit(phase="kernels", case=case, masked_rows=int(dead.sum()), exact_zeros=len(zero))
    return dead


def compare_bhsd(case, b, h, sq, skv, d, dtype, causal=True, window=None, bshd=False, seed=0,
                 controls=False):
    """K3/K4 vs their plain versions on the same inputs. Rows that attend
    nothing must come out exactly 0 with lse at NEG_INF. With ``controls``
    the planted faults are checked too (at head_dim 256 also one
    warpgroup's column half of dK zeroed). Returns the max abs errors of
    out and of the worst gradient."""
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
    dead = _masked_rows(case, lse, ref_lse, out)
    errs = {"out": _check(case, "out", dtype, out, ref_out, "out")}
    _check(case, "lse", dtype, lse[~dead], ref_lse[~dead], "lse")
    errs["grads"] = max(_check(case, name, dtype, t, r, "dqkv")
                        for name, t, r in zip(("dq", "dk", "dv"), grads, ref_grads))
    if controls:
        fault_controls(case, q, k, v, g, out, lse, grads, ref_out, ref_grads)
        if d == 256:
            column_half_control(case, grads[1], ref_grads[1])
        if d > 256:
            column_group_controls(case, q, k, v, out, ref_out)
    return errs


def column_group_controls(case, q, k, v, out, ref_out):
    """The faults a kernel above head_dim 256 can make, planted into the last
    64-row q tile of head (0, 0) of its forward's out: one column group's
    P·V dropped (its 128 columns of out zero), one 64-column chunk of D
    dropped from q·kᵀ (those rows as the plain forward gives them with that
    chunk of q zeroed), and, for the warpgroup forward's split, one
    warpgroup's half of P·V (out's columns [D/2, D) zero) and one D half of
    q·kᵀ (q's columns [D/2, D) zeroed). The blockwise check must catch each
    (causal, Sq == Skv, no window, no rope)."""
    rows, half = slice(q.shape[2] - BLOCK_ROWS, q.shape[2]), q.shape[3] // 2

    def plain_without(cols):
        q_drop = q[:1, :1].clone()
        q_drop[..., cols] = 0
        return A.flash_forward_reference(q_drop, k[:1, :1], v[:1, :1], True)[0]

    chunk, d_half = plain_without(slice(128, 192)), plain_without(slice(half, None))
    kind = "out"
    for name, plant in (("out: one column group's P.V", lambda t: t[0, 0, rows, 128:256].zero_()),
                        ("out: one D chunk of q.k^T", lambda t: t[0, 0, rows].copy_(
                            chunk[0, 0, rows].float())),
                        ("out: one warpgroup's half of P.V",
                         lambda t: t[0, 0, rows, half:].zero_()),
                        ("out: one D half of q.k^T", lambda t: t[0, 0, rows].copy_(
                            d_half[0, 0, rows].float()))):
        bad = out.to(torch.float32, copy=True)
        plant(bad)
        _, rel = _err(bad, ref_out)
        block = _block_err(bad, ref_out)
        caught = block > BLOCK_TOL[q.dtype][kind]
        emit(phase="kernels", case=case, control=name, rel_err=rel, tol=TOL[q.dtype][kind],
             passes_max_rule=rel <= TOL[q.dtype][kind], block_err=block,
             block_tol=BLOCK_TOL[q.dtype][kind], caught=caught)
        if not caught:
            fail(f"{case}: the blockwise check misses the planted fault {name}")


def column_half_control(case, dk, ref_dk, name="dk"):
    """The fault a column split can make: the second warpgroup's half of a
    gradient (``name``: dK of the fused backward, dq of K5; columns [64, 128)
    and [192, 256) at head_dim 256, [D/2, D) for K5 at 384 and 512) zeroed
    for one 64-row tile, the middle one of head (0, 0), which the blockwise
    check must catch."""
    bad = dk.to(torch.float32, copy=True)
    rows, d = slice(dk.shape[2] // 2, dk.shape[2] // 2 + BLOCK_ROWS), dk.shape[3]
    for cols in ((slice(64, 128), slice(192, 256)) if d == 256 else (slice(d // 2, d),)):
        bad[0, 0, rows, cols] = 0
    _, rel = _err(bad, ref_dk)
    block = _block_err(bad, ref_dk)
    caught = block > BLOCK_TOL[dk.dtype]["dqkv"]
    emit(phase="kernels", case=case, control=f"{name}: one warpgroup's column half", rel_err=rel,
         tol=TOL[dk.dtype]["dqkv"], passes_max_rule=rel <= TOL[dk.dtype]["dqkv"], block_err=block,
         block_tol=BLOCK_TOL[dk.dtype]["dqkv"], caught=caught)
    if not caught:
        fail(f"{case}: the blockwise check misses a zeroed column half of {name}")


def fault_controls(case, q, k, v, g, out, lse, grads, ref_out, ref_grads,
                   products=("out: P.V", "dq: dS.K", "dk: dS^T.Q", "dv: P^T.dO"), keys=None):
    """Plant the fault the max-based limit can miss — one 64-key kv tile
    (``keys``, default the one at s//2) dropped from the products of the
    last q tile of head (0, 0) — into the kernel's results, one product at
    a time, and require the blockwise check to fail on each of ``products``
    (causal, Sq == Skv, no window, no rope; head 0 reads kv head 0 under GQA
    too). ``out`` or any grad not checked may be None, and ``g`` and
    ``ref_grads`` too when only ``out: P.V`` is checked."""
    dtype, s, d = q.dtype, q.shape[2], q.shape[3]
    rows = slice(s - BLOCK_ROWS, s)
    keys = slice(s // 2, s // 2 + BLOCK_ROWS) if keys is None else keys
    scale = d ** -0.5
    qs = (q[0, 0, rows].float() * scale).to(dtype).float()
    kt, vt = k[0, 0, keys].float(), v[0, 0, keys].float()
    p = torch.exp(qs @ kt.T - lse[0, 0, rows, None])
    causal = torch.arange(keys.start, keys.stop, device=p.device) \
        <= torch.arange(rows.start, rows.stop, device=p.device)[:, None]
    p = p * causal  # the diagonal tile's masked keys carry no weight
    planted = [("out: P.V", "out", out, ref_out, rows, p @ vt)]
    if products != ("out: P.V",):
        go = g[0, 0, rows].float()
        delta = (go * ref_out[0, 0, rows].float()).sum(-1, keepdim=True)
        ds = p * (go @ vt.T - delta)
        planted += [
            ("dq: dS.K", "dqkv", grads[0], ref_grads[0], rows, scale * ds @ kt),
            ("dk: dS^T.Q", "dqkv", grads[1], ref_grads[1], keys, ds.T @ qs),
            ("dv: P^T.dO", "dqkv", grads[2], ref_grads[2], keys, p.T @ go),
        ]
    for name, kind, got, ref, at, part in planted:
        if name not in products:
            continue
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


def compare_fwd(case, b, h, kv, sq, skv, d, causal=True, window=None, rope=False,
                q_pos_offset=None, seed=0, controls=False):
    """The warpgroup forward (bf16, one launch on the source
    attention.forward_kernel names: flash_fwd_sm90.cu up to head_dim 256,
    flash_fwd_cols_sm90.cu at 384 and 512) against its plain version on (B,
    H, Sq, D) q and (B, KV, Skv, D) k, v: out by the max-based and blockwise
    limits, lse by its absolute limit, and rows that attend nothing exactly
    0 with lse at NEG_INF. Rope tables of Skv rows are read at each row's
    position (q row i at i + q_pos_offset). With ``controls`` the last 64-key
    tile of the last q tile, which the kernel's last step multiplies with no
    next product in flight, is dropped from P·V as a planted fault that must
    be caught, and above 256 column_group_controls' faults too. Returns
    out's max abs error."""
    from distributed_tensorflow_tpu_torch.ops.rope import rope_tables

    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    make = lambda n, s: torch.randn(b, n, s, d, device="cuda", generator=gen).to(dtype)
    q, k, v = make(h, sq), make(kv, skv), make(kv, skv)
    cos = sin = None
    if rope:
        cos, sin = rope_tables(d, skv, 10000.0, device="cuda")
    args = (causal, window, None, q_pos_offset, cos, sin)
    source = A.forward_kernel(dtype, A._instance_dim(d))
    before = A.SOURCE_LAUNCHES[source]
    out, lse = A.flash_forward_kernel(q, k, v, *args)
    torch.cuda.synchronize()
    if A.SOURCE_LAUNCHES[source] != before + 1:
        fail(f"{case}: the call did not run {source}.cu")
    ref_out, ref_lse = A.flash_forward_reference(q, k, v, *args)
    if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
        fail(f"{case}: non-finite out or lse")
    dead = _masked_rows(case, lse, ref_lse, out)
    err = _check(case, "out", dtype, out, ref_out, "out")
    _check(case, "lse", dtype, lse[~dead], ref_lse[~dead], "lse")
    if controls:
        fault_controls(case, q, k, v, None, out, lse, None, ref_out, None,
                       products=("out: P.V",), keys=slice(sq - BLOCK_ROWS, sq))
        if d > 256:
            column_group_controls(case, q, k, v, out, ref_out)
    return err


def check_rotate(case, qkv, h, kv, d, cos, sin):
    """The warpgroup forward's rotate pass (flash_fwd_rotate_k) against its
    plain version, bit for bit: K1 on packed ``qkv`` with rope tables, its k
    scratch handed in and read back after the launch."""
    q, k, v = A._packed_heads(qkv, h, kv, d)
    b, s = qkv.shape[:2]
    out = torch.empty(b, h, s, d, dtype=qkv.dtype, device="cuda")
    lse = torch.empty(b, h, s, dtype=torch.float32, device="cuda")
    k_rot = torch.full((b, kv, s, d), float("nan"), dtype=qkv.dtype, device="cuda")
    A._launch_forward("flash_fwd", q, k, v, out, lse, True, None, 0, None, cos, sin, k_rot=k_rot)
    torch.cuda.synchronize()
    ref = A.rotate_k_reference(k, cos, sin)
    same = bool(torch.equal(k_rot, ref))
    emit(phase="kernels", case=case, tensor="k_rot", shape=list(k_rot.shape),
         max_abs_err=(k_rot.float() - ref.float()).abs().max().item(), bitwise_equal=same)
    if not same:
        fail(f"{case}: the rotate pass differs from its plain version")


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
    # The warpgroup backward (bf16 at head_dim 64 and 128) where the cases
    # above leave it untried; GQA, window, rope and q segments placed by
    # q_pos_offset at head_dim 64 are gqa_window_rope_d64 above and the long
    # family's long_gqa_window_cross_rope_d64.
    compare_bhsd("wgmma_noncausal_cross_d64", 2, 8, 136, 200, 64, torch.bfloat16, causal=False,
                 seed=11)
    compare_bhsd("wgmma_fully_masked_rows_d64", 2, 4, 200, 72, 64, torch.bfloat16, seed=12)
    compare_bhsd("wgmma_cross_window_d128", 2, 4, 192, 320, 128, torch.bfloat16, window=100,
                 seed=13)
    compare_bhsd("wgmma_fully_masked_rows_d128", 1, 4, 200, 72, 128, torch.bfloat16, seed=14)
    # The warpgroup forward (bf16 at head_dim 64 and 128) where the cases above
    # leave it untried: non-causal with GQA, a q segment placed by
    # q_pos_offset, window with GQA and rope, rows that attend nothing inside
    # a block that attends something and in one that attends nothing, a
    # ragged length, its rotate pass, and a dropped tile in its last step.
    compare_fwd("fwd_sm90_noncausal_gqa_d128", 2, 8, 2, 200, 136, 128, causal=False, seed=15)
    compare_fwd("fwd_sm90_cross_offset_d64", 2, 4, 4, 136, 320, 64, q_pos_offset=100, seed=16)
    compare_fwd("fwd_sm90_gqa_window_rope_d128", 2, 8, 2, 300, 300, 128, window=100, rope=True,
                seed=17)
    compare_fwd("fwd_sm90_window_rope_offset_d64", 1, 4, 1, 136, 400, 64, window=50, rope=True,
                q_pos_offset=200, seed=18)
    compare_fwd("fwd_sm90_fully_masked_rows_d64", 2, 4, 4, 200, 100, 64, seed=19)
    compare_fwd("fwd_sm90_fully_masked_rows_d128", 2, 4, 2, 200, 72, 128, seed=27)
    compare_fwd("fwd_sm90_ragged_d64", 2, 4, 2, 200, 200, 64, seed=28)
    compare_fwd("fwd_sm90_controls_d128", 2, 4, 4, 1024, 1024, 128, seed=29, controls=True)
    from distributed_tensorflow_tpu_torch.ops.rope import rope_tables

    gen = torch.Generator(device="cuda").manual_seed(30)
    lb, ls, lh, lkv = LONG["batch_size"], LONG["seq_len"], LONG["num_heads"], LONG["num_kv_heads"]
    qkv = torch.randn(lb, ls, (lh + 2 * lkv) * dh, device="cuda", generator=gen).to(torch.bfloat16)
    check_rotate("rotate_k_long_call", qkv, lh, lkv, dh,
                 *rope_tables(dh, ls, LONG["rope_theta"], device="cuda"))
    qkv = torch.randn(2, 200, 12 * 64, device="cuda", generator=gen).to(torch.bfloat16)
    positions = torch.arange(200, device="cuda") + 37 * torch.arange(2, device="cuda")[:, None]
    check_rotate("rotate_k_per_batch_tables_d64", qkv, 8, 2, 64,
                 *rope_tables(64, 200, 10000.0, positions=positions))
    del qkv
    torch.cuda.empty_cache()
    return errs


# Gemma 7B's attention width (16 heads of 256; its config.json on the Hugging
# Face hub) at seq 2048: the D 256 instance's call for phase 3, its turns
# and its timing rows.
GEMMA = dict(batch_size=2, seq_len=2048, num_heads=16, head_dim=256)


def _head_dim_sources(case, want):
    """The launches by source since the counts were zeroed must be on the
    sources ``want`` and no other."""
    sources = {k: n for k, n in A.SOURCE_LAUNCHES.items() if n}
    emit(phase="head_dims", case=case, source_launches=sources)
    if set(sources) != set(want):
        fail(f"head_dims: {case} ran {sources}, expected {sorted(want)}")


def phase_head_dims():
    """Head dims off the flagship's 128: 32 (an instance of its own; the
    CLI's default d_model 128 over 4 heads) at the CLI's call shape (batch
    8, seq 128), and 80 (zero-padded to 128, rope paired half by half),
    forward and backward, packed qkv and BHSD, bf16 and f32, against the
    plain versions at the real head_dim. Then head_dim
    256 and 160/192 (padded to 256) in bf16, where every launch runs the
    warpgroup kernels flash_fwd_sm90.cu, flash_bwd_sm90.cu and
    flash_bwd_dq_sm90.cu (compare_k5 holds K5 at Gemma 7B's width with rope,
    GQA + window and planted faults): K1/K2 at Gemma 7B's width, packed GQA + rope (and +
    window) at a ragged length, K3/K4 with fully masked rows, cross-length,
    window and non-causal with planted faults, K4 on q segments against one
    whole call, the forward's own cases and rotate pass, and K5-K8 with GQA,
    window, rope and cross-length, with fully masked rows and at the `wide`
    path's length, and the `wide` path's own calls at its full shape
    (compare_wide); then the same families in f32, on flash_fwd.cu,
    flash_bwd.cu and flash_bwd_dq.cu. Returns the errors of the D 32 and
    D 256 rows."""
    from distributed_tensorflow_tpu_torch.ops.rope import rope_tables

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        d32 = compare("packed_d32_cli_shape", 8, 128, 4, 4, 32, dtype, seed=60)
        if dtype == torch.bfloat16:
            errs["flash_fwd_d32"], errs["flash_bwd_d32"] = d32["out"], d32["dqkv"]
        compare("packed_d80_gqa_rope", 8, 128, 4, 2, 80, dtype, rope=True, seed=61)
        # a padded head dim with per-batch tables: padded to the instance's width
        compare("packed_d80_per_batch_rope", 2, 136, 4, 2, 80, dtype, rope="per_batch", seed=59)
        compare_bhsd("bhsd_d32_cross_window", 2, 4, 136, 200, 32, dtype, window=50, seed=62)
        compare_bhsd("bhsd_d80_cross", 2, 4, 136, 200, 80, dtype, seed=63)
    bf = torch.bfloat16
    _zero_counts()
    gm = GEMMA
    gemma = compare("packed_d256_gemma_width", gm["batch_size"], gm["seq_len"], gm["num_heads"],
                    gm["num_heads"], gm["head_dim"], bf, seed=64)
    errs["flash_fwd_d256"], errs["flash_bwd_d256"] = gemma["out"], gemma["dqkv"]
    torch.cuda.empty_cache()
    compare("packed_d256_gqa_window_rope_ragged", 2, 200, 8, 2, 256, bf, window=100, rope=True,
            seed=71)
    compare_bhsd("bhsd_d256_noncausal_cross", 2, 8, 136, 200, 256, bf, causal=False, seed=72)
    compare_bhsd("bhsd_d256_cross_window", 2, 4, 192, 320, 256, bf, window=100, seed=73)
    compare_bhsd("bhsd_d256_controls", 1, 4, 1024, 1024, 256, bf, seed=74, controls=True)
    check_segments("bhsd_segments_d256", 2, 4, 384, 256, bf, n_seg=3, seed=75)
    compare_fwd("fwd_d256_gqa_window_rope_ragged", 2, 8, 2, 300, 300, 256, window=100, rope=True,
                seed=76)
    compare_fwd("fwd_d256_cross_offset", 2, 4, 4, 136, 320, 256, q_pos_offset=100, seed=77)
    compare_fwd("fwd_d256_fully_masked_rows", 2, 4, 2, 200, 72, 256, seed=78)
    compare_fwd("fwd_d256_noncausal_gqa", 2, 8, 2, 200, 136, 256, causal=False, seed=79)
    compare_fwd("fwd_d256_controls", 2, 4, 4, 1024, 1024, 256, seed=80, controls=True)
    gen = torch.Generator(device="cuda").manual_seed(81)
    qkv = torch.randn(2, 300, 12 * 256, device="cuda", generator=gen).to(bf)
    check_rotate("rotate_k_d256", qkv, 8, 2, 256, *rope_tables(256, 300, 10000.0, device="cuda"))
    del qkv
    # The `wide` path's own calls at its full shape give its rows' errors;
    # the long family at the same length (K7, K8 on eight q segments, K5, K6
    # and its delta, 4 heads) is an extra check.
    errs.update(compare_wide("wide_call"))
    torch.cuda.empty_cache()
    compare_long("wide_segment_call_long_family", 1, 4, 4, WIDE["seq_len"], WIDE["seq_len"], 256,
                 bf, rope=True, segments=8, seed=82, theta=WIDE["rope_theta"])
    torch.cuda.empty_cache()
    # K5 on the warpgroup dq kernel at 256: Gemma 7B's width (16 heads of
    # 256, seq 2048) with rope, with GQA and a window, and with planted
    # faults; the long family's cases below run it with GQA + window + rope
    # cross-length and with fully masked rows, and compare_long's controls
    # with its dropped tile and column half.
    gb, gs, gh = gm["batch_size"], gm["seq_len"], gm["num_heads"]
    compare_k5("k5_d256_gemma_width_rope", gb, gh, gh, gs, gs, 256, rope=True, seed=85)
    compare_k5("k5_d256_gemma_width_gqa_window", gb, gh, 4, gs, gs, 256, window=1024, seed=86)
    compare_k5("k5_d256_gemma_width_controls", gb, gh, gh, gs, gs, 256, seed=87, controls=True)
    compare_long("long_d256_controls", 1, 4, 1, 2048, 2048, 256, bf, seed=88, controls=True)
    torch.cuda.empty_cache()

    def families(dtype):
        compare("packed_d256_gqa_rope_ragged", 2, 200, 4, 2, 256, dtype, rope=True, seed=65)
        compare("packed_d192_gqa_rope", 2, 136, 4, 2, 192, dtype, rope=True, seed=66)
        compare_bhsd("bhsd_d256_fully_masked_rows", 2, 4, 200, 72, 256, dtype, seed=67)
        compare_bhsd("bhsd_d160_cross_window", 2, 4, 136, 200, 160, dtype, window=50, seed=68)
        compare_long("long_d256_gqa_window_cross_rope", 2, 8, 2, 192, 320, 256, dtype,
                     window=100, rope=True, segments=2, seed=69)
        compare_long("long_d256_fully_masked_rows", 2, 4, 4, 200, 72, 256, dtype, seed=70)

    families(bf)
    _head_dim_sources("d160_256_bf16", ("flash_fwd_sm90", "flash_bwd_sm90", "flash_bwd_dq_sm90"))
    _zero_counts()
    families(torch.float32)
    _head_dim_sources("d160_256_f32", ("flash_fwd", "flash_bwd", "flash_bwd_dq"))
    return errs


def compare_two_pass(case, b, s, h, d, seed):
    """The d512 path's calls: K1 on packed bf16 qkv (batch ``b``, seq ``s``,
    ``h`` heads of ``d``, causal, no rope), then K6 (dk, dv, delta) and K5
    (dq) on its head views, each against its plain version. Returns the
    errors (out, lse, dq, and the larger of dk's and dv's) and the operands
    (q, k, v, out, lse, dO and delta as head views)."""
    bf = torch.bfloat16
    qkv, g = _packed(b, s, h, h, d, bf, seed)
    args = (h, h, True, None, None, None)
    out, lse = A.flash_forward_qkv_kernel(qkv, *args, None)
    q, k, v = A._packed_heads(qkv, h, h, d)
    o4, go = A._heads(out, d), A._heads(g, d)
    dk, dv, delta = A.flash_backward_dkv_kernel(q, k, v, o4, lse, go, True)
    dq = A.flash_backward_dq_kernel(q, k, v, lse, go, delta, True)
    torch.cuda.synchronize()
    ref_out, ref_lse = A.flash_forward_qkv_reference(qkv, *args)
    errs = {"out": _check(case, "out", bf, o4, A._heads(ref_out, d), "out"),
            "lse": _check(case, "lse", bf, lse, ref_lse, "lse")}
    del ref_out, ref_lse
    ref = A.flash_backward_reference(q, k, v, o4, lse, go, True)
    errs["dq"] = _check(case, "k5_dq", bf, dq, ref[0], "dqkv")
    errs["dkv"] = max(_check(case, f"k6_{n}", bf, t, r, "dqkv")
                      for n, t, r in zip(("dk", "dv"), (dk, dv), ref[1:]))
    _check(case, "k6_delta", bf, delta, (go.float() * o4.float()).sum(-1), "lse")
    return errs, (q, k, v, o4, lse, go, delta)


def compare_k5(case, b, h, kv, sq, skv, d, causal=True, window=None, rope=False,
               q_pos_offset=None, seed=0, controls=False, masked=False):
    """K5 at head_dim ``d`` on BHSD bf16 operands (``h`` query heads on ``kv``
    kv heads, rope θ 10000 tables of ``skv`` rows, q rows placed by
    ``q_pos_offset``): K3's forward and K6's delta first, then one K5 launch
    on the source attention.backward_dq_kernel names, held against its plain
    version on the kernel forward's results; rows that attend nothing give
    exact zeros (with ``masked`` the case must have some). With ``controls``
    (Sq == Skv, no window, no rope) a dropped kv tile in dS·K (the kernel's
    own: 64 keys, 32 for the warpgroup kernel above 256) and one
    warpgroup's column half of dq (:func:`column_half_control`) must be
    caught. Returns dq's max abs error."""
    from distributed_tensorflow_tpu_torch.ops.rope import rope_tables

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    make = lambda n, s: torch.randn(b, n, s, d, device="cuda", generator=gen).to(bf)
    q, k, v, g = make(h, sq), make(kv, skv), make(kv, skv), make(h, sq)
    cos = sin = None
    if rope:
        cos, sin = rope_tables(d, skv, 10000.0, device="cuda")
    args = (causal, window, None, q_pos_offset, cos, sin)
    out, lse = A.flash_forward_kernel(q, k, v, *args)
    _, _, delta = A.flash_backward_dkv_kernel(q, k, v, out, lse, g, *args)
    source = A.backward_dq_kernel(bf, A._instance_dim(d))
    before = A.SOURCE_LAUNCHES[source]
    dq = A.flash_backward_dq_kernel(q, k, v, lse, g, delta, *args)
    torch.cuda.synchronize()
    if A.SOURCE_LAUNCHES[source] != before + 1:
        fail(f"{case}: K5 did not run {source}.cu")
    emit(phase="kernels", case=case, k5_source=source)
    if not torch.isfinite(dq).all():
        fail(f"{case}: non-finite dq")
    ref_out, ref_lse = A.flash_forward_reference(q, k, v, *args)
    if not _masked_rows(case, lse, ref_lse, dq).any() and masked:
        fail(f"{case}: the case has no row that attends nothing")
    ref = A.flash_backward_reference(q, k, v, out, lse, g, *args)
    err = _check(case, "k5_dq", bf, dq, ref[0], "dqkv")
    if controls:
        # the warpgroup kernel above 256 walks 32-key tiles
        keys = slice(sq // 2, sq // 2 + 32) if d > 256 else None
        fault_controls(case, q, k, v, g, None, lse, (dq, None, None), ref_out, ref,
                       products=("dq: dS.K",), keys=keys)
        column_half_control(case, dq, ref[0], "dq")
    return err


def compare_k6(case, b, h, kv, sq, skv, d, window=None, rope=False, q_pos_offset=None, seed=0,
               controls=False):
    """K6 at head_dim ``d`` on BHSD bf16 operands (``h`` query heads on ``kv``
    kv heads, causal, rope θ 10000 tables of ``skv`` rows, q rows placed by
    ``q_pos_offset``): K3's forward first, then one K6 launch on the source
    attention.backward_kernel names, dk, dv and delta held against their
    plain versions on the kernel forward's results; kv rows that no q row
    sees must give dk and dv exactly 0 (the case must have some). With
    ``controls`` (Sq == Skv, no window, no rope) the faults the warpgroup
    dk/dv kernel (flash_bwd_cols_sm90.cu) can make must be caught
    blockwise (:func:`k6_cols_controls`). Returns the larger of dk's and
    dv's max abs errors."""
    from distributed_tensorflow_tpu_torch.ops.rope import rope_tables

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    make = lambda n, s: torch.randn(b, n, s, d, device="cuda", generator=gen).to(bf)
    q, k, v, g = make(h, sq), make(kv, skv), make(kv, skv), make(h, sq)
    cos = sin = None
    if rope:
        cos, sin = rope_tables(d, skv, 10000.0, device="cuda")
    args = (True, window, None, q_pos_offset, cos, sin)
    out, lse = A.flash_forward_kernel(q, k, v, *args)
    source = A.backward_kernel(bf, A._instance_dim(d), False)
    before = A.SOURCE_LAUNCHES[source]
    dk, dv, delta = A.flash_backward_dkv_kernel(q, k, v, out, lse, g, *args)
    torch.cuda.synchronize()
    if A.SOURCE_LAUNCHES[source] != before + 1:
        fail(f"{case}: K6 did not run {source}.cu")
    emit(phase="kernels", case=case, k6_source=source)
    for name, t in (("dk", dk), ("dv", dv), ("delta", delta)):
        if not torch.isfinite(t).all():
            fail(f"{case}: non-finite {name}")
    ref = A.flash_backward_dkv_reference(q, k, v, out, lse, g, *args)
    if not controls:  # kv rows no q row sees, by the mask
        off = A._offset(sq, skv, q_pos_offset)
        unseen = ~A._mask(sq, skv, True, window, q.device, off).any(dim=0)
        if not unseen.any():
            fail(f"{case}: the case has no kv row that no q row sees")
        if any((t[:, :, unseen] != 0).any() for t in (dk, dv)):
            fail(f"{case}: kv rows no q row sees must give dk and dv exactly 0")
        emit(phase="kernels", case=case, unseen_kv_rows=int(unseen.sum()), exact_zeros=2)
    err = max(_check(case, f"k6_{n}", bf, t, r, "dqkv") for n, t, r in zip(("dk", "dv"), (dk, dv),
                                                                           ref))
    _check(case, "k6_delta", bf, delta, (g.float() * out.float()).sum(-1), "lse")
    if controls:
        k6_cols_controls(case, q, k, v, g, out, lse, dk, dv, *ref)
    return err


def k6_cols_controls(case, q, k, v, g, out, lse, dk, dv, ref_dk, ref_dv):
    """The faults of the warpgroup dk/dv kernel above head_dim 256
    (flash_bwd_cols_sm90.cu: two blocks a 64-row kv tile, each owning half
    of D's columns, split over its two warpgroups; 32-row q tiles), planted
    into the middle 64-row kv tile of head (0, 0) and required to fail the
    blockwise check: one 32-row q tile (the last, which sees every key)
    dropped from dK and from dV; one warpgroup's columns of dK and of dV
    zeroed (warpgroup 1 of the first block: [64, 128) and [128 + W, 128 +
    2W), W = 64 at D 512 and 32 at 384); and one of the two column blocks
    (D's second half) zeroed. Causal, Sq == Skv, no window, no rope."""
    s, d = q.shape[2], q.shape[3]
    keys = slice(s // 2, s // 2 + BLOCK_ROWS)
    rows = slice(s - 32, s)
    w = d // 4 - 64
    # P and dS of the dropped tile against those keys (all of them seen),
    # from the saved lse, as the plain version forms them.
    qs = (q[0, 0, rows].float() * d ** -0.5).to(q.dtype).float()
    p = torch.exp(qs @ k[0, 0, keys].float().T - lse[0, 0, rows, None])
    go = g[0, 0, rows].float()
    delta = (go * out[0, 0, rows].float()).sum(-1, keepdim=True)
    ds = p * (go @ v[0, 0, keys].float().T - delta)
    drops = [("dk: one q tile's dS^T.Q", dk, ref_dk, lambda t: t[0, 0, keys].sub_(ds.T @ qs)),
             ("dv: one q tile's P^T.dO", dv, ref_dv, lambda t: t[0, 0, keys].sub_(p.T @ go))]
    for name, t, ref in (("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        drops += [
            (f"{name}: one warpgroup's columns", t, ref,
             lambda x: (x[0, 0, keys, 64:128].zero_(), x[0, 0, keys, 128 + w:128 + 2 * w].zero_())),
            (f"{name}: one of the two column blocks", t, ref,
             lambda x: x[0, 0, keys, d // 2:].zero_()),
        ]
    for name, got, ref, plant in drops:
        bad = got.to(torch.float32, copy=True)
        plant(bad)
        _, rel = _err(bad, ref)
        block = _block_err(bad, ref)
        caught = block > BLOCK_TOL[q.dtype]["dqkv"]
        emit(phase="kernels", case=case, control=name, rel_err=rel, tol=TOL[q.dtype]["dqkv"],
             passes_max_rule=rel <= TOL[q.dtype]["dqkv"], block_err=block,
             block_tol=BLOCK_TOL[q.dtype]["dqkv"], caught=caught)
        if not caught:
            fail(f"{case}: the blockwise check misses the planted fault {name}")


def check_bshd_probe(case, b, s, h, dh, seed):
    """K10 (tools/bshd_probe.py's bshd_forward on (B, S, H·dh) bf16 views)
    at head_dim ``dh`` against its plain version, on the source
    attention.forward_kernel names."""
    from distributed_tensorflow_tpu_torch.tools import bshd_probe as bp

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = [torch.randn(b, s, h * dh, device="cuda", generator=gen).to(torch.bfloat16)
         for _ in range(3)]
    source = A.forward_kernel(torch.bfloat16, A._instance_dim(dh))
    before = A.SOURCE_LAUNCHES[source]
    got, got_lse = bp.bshd_forward(*x, h)
    torch.cuda.synchronize()
    if A.SOURCE_LAUNCHES[source] != before + 1:
        fail(f"{case}: K10 did not run {source}.cu")
    want, want_lse = bp.bshd_forward_reference(*x, h)
    _check(case, "out", torch.bfloat16, A._heads(got, dh), A._heads(want, dh), "out")
    _check(case, "lse", torch.bfloat16, got_lse, want_lse, "lse")


def phase_head_dims_above_256():
    """Head dims above 256 on the column-group kernels (flash_fwd_dstream.cu,
    flash_bwd_dstream.cu with and without dq, flash_bwd_dq_dstream.cu) and,
    for the bf16 forward at 384 and 512, the warpgroup kernel
    flash_fwd_cols_sm90.cu, which run every call at head_dim 320 and 300
    (padded to 384), 384 and 512, and
    257 (odd, padded at the tail), in bf16 and f32: packed qkv (K1/K2) with
    GQA + window + rope and with rope alone; BHSD (K3/K4) cross-length with
    a window, non-causal cross-length without rope, and with fully masked
    rows; the long family (K7, K8 on q segments placed by q_pos_offset, K5,
    K6 and its delta) with GQA + window + cross-length + rope and with fully
    masked rows; K4 on q segments against one whole call; then, in bf16, the
    planted faults (a dropped kv tile in each product, one column group's
    P·V and one D chunk of q·kᵀ dropped) and the D 512 call the timing
    phase times (B 2, S 2048, 4 heads of 512, packed qkv), and the d512
    path's own calls at its batch (K1, K6 and K5 at B 12); the warpgroup
    forward's own cases (compare_fwd) with its planted faults (one
    warpgroup's half of P·V, one D half of q·kᵀ), K10 on head views at 512,
    and bf16 at 640, still on the column-group forward; and bf16 K6, which
    runs the warpgroup kernel flash_bwd_cols_sm90.cu at 384 and 512 (in the
    families above too), on its own cases (compare_k6) with its planted
    faults, and bf16 K5, which runs the warpgroup kernel
    flash_bwd_dq_cols_sm90.cu there, on its own (compare_k5). Every launch
    must run the source its dtype and head dim name.
    Returns the errors of the rows: K2 at B 2, K1, K5 and K6 at the path's
    B 12."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        _zero_counts()
        compare("ds_packed_d512_gqa_window_rope", 2, 200, 4, 2, 512, dtype, window=100,
                rope=True, seed=90)
        compare("ds_packed_d320_rope", 2, 136, 4, 4, 320, dtype, rope=True, seed=91)
        compare_bhsd("ds_bhsd_d384_cross_window", 2, 4, 192, 320, 384, dtype, window=100, seed=92)
        compare_bhsd("ds_bhsd_d300_noncausal_cross", 2, 4, 136, 200, 300, dtype, causal=False,
                     seed=93)
        compare_bhsd("ds_bhsd_d512_fully_masked_rows", 2, 4, 200, 72, 512, dtype, seed=94)
        compare_long("ds_long_d512_gqa_window_cross_rope", 2, 8, 2, 192, 320, 512, dtype,
                     window=100, rope=True, segments=2, seed=95)
        compare_long("ds_long_d320_fully_masked_rows", 2, 4, 4, 200, 72, 320, dtype, seed=96)
        compare_long("ds_long_d257_odd_cross", 1, 4, 2, 136, 200, 257, dtype, seed=97)
        check_segments(f"ds_segments_d384_{str(dtype).split('.')[-1]}", 2, 4, 384, 384, dtype,
                       n_seg=3, seed=98)
        _head_dim_sources(f"d257_512_{str(dtype).split('.')[-1]}",
                          set((DSTREAM if dtype == torch.bfloat16 else DSTREAM_F32).values()))
    bf = torch.bfloat16
    # The warpgroup forward at 384 and 512 (flash_fwd_cols_sm90.cu) where the
    # families above leave it untried: GQA + window + rope from dh 320, a q
    # segment placed by q_pos_offset, rows that attend nothing, non-causal
    # with GQA, and the planted faults (a dropped kv tile in the last step,
    # one column group, one warpgroup's half of P·V, one D chunk and one D
    # half of q·kᵀ) at 512 and from 320; K10 on (B, S, H·dh) views at 512;
    # and bf16 above 512, which stays on the column-group forward.
    compare_fwd("fwd_cols_d320_gqa_window_rope", 2, 8, 2, 300, 300, 320, window=100, rope=True,
                seed=104)
    compare_fwd("fwd_cols_d512_cross_offset", 2, 4, 4, 136, 320, 512, q_pos_offset=100, seed=105)
    compare_fwd("fwd_cols_d512_fully_masked_rows", 2, 4, 2, 200, 72, 512, seed=106)
    compare_fwd("fwd_cols_d384_noncausal_gqa", 2, 8, 2, 200, 136, 384, causal=False, seed=107)
    compare_fwd("fwd_cols_d512_controls", 2, 4, 4, 1024, 1024, 512, seed=108, controls=True)
    compare_fwd("fwd_cols_d320_controls", 1, 4, 4, 1024, 1024, 320, seed=109, controls=True)
    check_bshd_probe("k10_d512_head_views", 2, 300, 4, 512, seed=110)
    _zero_counts()
    compare_bhsd("ds_bhsd_d640_bf16", 1, 2, 136, 136, 640, bf, seed=111)
    _head_dim_sources("d640_bf16", ("flash_fwd_dstream", "flash_bwd_dstream"))
    compare_bhsd("ds_bhsd_d512_controls", 1, 4, 1024, 1024, 512, bf, seed=99, controls=True)
    compare_long("ds_long_d512_controls", 1, 4, 1, 2048, 2048, 512, bf, seed=100, controls=True)
    # K6 at 384 and 512 on the warpgroup kernel flash_bwd_cols_sm90.cu where
    # the families above leave it untried: GQA + window + rope cross-length
    # at 384, rope on a q segment placed by q_pos_offset from dh 320 and at
    # 512 (each with kv rows no q row sees, which must give exact zeros), and
    # its own planted faults at 512 and 384.
    compare_k6("k6_cols_d384_gqa_window_rope_cross", 2, 8, 2, 192, 320, 384, window=100,
               rope=True, seed=112)
    compare_k6("k6_cols_d320_gqa_rope_offset", 2, 4, 2, 136, 320, 320, rope=True,
               q_pos_offset=100, seed=113)
    compare_k6("k6_cols_d512_window_offset", 1, 4, 4, 200, 400, 512, window=64, q_pos_offset=150,
               seed=114)
    compare_k6("k6_cols_d512_controls", 1, 4, 4, 1024, 1024, 512, seed=115, controls=True)
    compare_k6("k6_cols_d384_controls", 1, 4, 4, 1024, 1024, 384, seed=116, controls=True)
    # K5 at 384 and 512 on the warpgroup kernel flash_bwd_dq_cols_sm90.cu
    # where the families above leave it untried: GQA + window + rope from dh
    # 320, rope at 512 on a cross-length q segment placed by q_pos_offset,
    # rows that attend nothing (exact zeros), non-causal cross-length with
    # GQA at 384, and its planted faults (a dropped 32-key tile in dS·K, one
    # warpgroup's column half of dq) at 512 and 384.
    compare_k5("k5_cols_d320_gqa_window_rope", 2, 8, 2, 300, 300, 320, window=100, rope=True,
               seed=130)
    compare_k5("k5_cols_d512_rope_cross_offset", 2, 4, 2, 136, 320, 512, rope=True,
               q_pos_offset=100, seed=131)
    compare_k5("k5_cols_d512_fully_masked_rows", 2, 4, 2, 200, 72, 512, seed=132, masked=True)
    compare_k5("k5_cols_d384_noncausal_gqa_cross", 2, 8, 2, 200, 136, 384, causal=False,
               seed=135)
    compare_k5("k5_cols_d512_controls", 1, 4, 4, 1024, 1024, 512, seed=133, controls=True)
    compare_k5("k5_cols_d384_controls", 1, 4, 4, 1024, 1024, 384, seed=134, controls=True)
    errs["flash_bwd_d512"] = compare("ds_packed_d512_call", 2, 2048, 4, 4, 512, bf,
                                     seed=101)["dqkv"]
    b, s, h = (D512[key] for key in ("batch_size", "seq_len", "num_heads"))
    path = compare_two_pass("ds_packed_d512_path_call", b, s, h, D512["d_model"] // h, seed=103)[0]
    errs["flash_fwd_d512"], errs["bwd_dq_d512"], errs["bwd_dkv_d512"] = (
        path["out"], path["dq"], path["dkv"])
    torch.cuda.empty_cache()
    return errs


def compare_wide(case):
    """The `wide` path's own calls at its full shape (_wide_operands: batch
    2, seq 8192, 16 heads of 256, packed qkv, rope θ 10000, bf16), each held
    against its plain version run one batch row at a time: K1 with rope (out
    and lse, rows that attend nothing exactly 0); the backward as the
    trainer's autograd runs it (_backward_by_route: the eight K8 segment
    calls, their dq rows in place and their dk/dv shares summed) on dqkv;
    and the call the timing phase times, K8 on the last segment, on its dq
    rows and its dk/dv shares. Returns the rows' errors: out's, and the
    worst of K8's gradients."""
    w = _wide_operands()
    qkv, go, cos, sin, out, lse = (w[key] for key in ("qkv", "go", "cos", "sin", "out", "lse"))
    b, s, h, d, a, seg = (w[key] for key in ("b", "s", "h", "d", "a", "seg"))
    bf = qkv.dtype
    plain = [A.flash_forward_qkv_reference(qkv[i:i + 1], h, h, True, None, cos, sin)
             for i in range(b)]
    ref_out, ref_lse = (torch.cat(t) for t in zip(*plain))
    del plain
    if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
        fail(f"{case}: non-finite out or lse")
    dead = _masked_rows(case, lse, ref_lse, A._heads(out, d))
    errs = {"flash_fwd_rope_d256_wide": _check(case, "out", bf, A._heads(out, d),
                                               A._heads(ref_out, d), "out")}
    _check(case, "lse", bf, lse[~dead], ref_lse[~dead], "lse")
    del ref_out

    before = A.KERNEL_LAUNCHES["bshd_bwd"]
    dqkv = torch.empty_like(qkv)
    A._backward_by_route("flash_bwd", "bshd_bwd", *A._packed_heads(qkv, h, h, d),
                         A._heads(out, d), A._heads(go, d), lse, *A._packed_heads(dqkv, h, h, d),
                         True, None, 0, None, cos, sin)
    torch.cuda.synchronize()
    if A.KERNEL_LAUNCHES["bshd_bwd"] != before + s // seg:
        fail(f"{case}: the backward did not run {s // seg} K8 segment calls")
    if not torch.isfinite(dqkv).all():
        fail(f"{case}: non-finite dqkv")
    ref = torch.cat([A.flash_backward_qkv_reference(qkv[i:i + 1], out[i:i + 1], lse[i:i + 1],
                                                    go[i:i + 1], h, h, True, None, cos, sin)
                     for i in range(b)])
    # each head's rows: (B, S, 3·h·d) -> (B, 3·h, S, d)
    worst = _check(case, "dqkv", bf, A._heads(dqkv, d), A._heads(ref, d), "dqkv")
    del dqkv, ref

    w["segment"]()
    torch.cuda.synchronize()
    got = (w["dq_seg"], w["dk_s"], w["dv_s"])
    for name, t in zip(("dq", "dk", "dv"), got):
        if not torch.isfinite(t).all():
            fail(f"{case}: non-finite segment {name}")
    plain = [A.flash_backward_reference(w["q_seg"][i:i + 1], w["k"][i:i + 1], w["v"][i:i + 1],
                                        w["out_seg"][i:i + 1], w["lse_seg"][i:i + 1],
                                        w["g_seg"][i:i + 1], True, None, None, a, cos, sin)
             for i in range(b)]
    _masked_rows(f"{case} segment", w["lse_seg"], ref_lse[:, :, a:], w["dq_seg"])
    for name, t, r in zip(("dq", "dk", "dv"), got, (torch.cat(p) for p in zip(*plain))):
        worst = max(worst, _check(case, f"segment_{name}", bf, t, r, "dqkv"))
    errs["bshd_bwd_d256_wide"] = worst
    return errs


def _long_operands(b, h, kv, sq, skv, d, dtype, seed):
    """q, g (B, Sq, H, D) and k, v (B, Skv, KV, D) on the card: the BSHD
    layout of K7/K8."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    make = lambda s, n: torch.randn(b, s, n, d, device="cuda", generator=gen).to(dtype)
    return make(sq, h), make(skv, kv), make(skv, kv), make(sq, h)


def compare_long(case, b, h, kv, sq, skv, d, dtype, causal=True, window=None, rope=False,
                 segments=1, seed=0, controls=False, theta=LONG["rope_theta"]):
    """K7, K8, K5 and K6 against their plain versions on the same BSHD
    operands (GQA through the head-group divisor, rope tables of Skv rows
    at ``theta`` read at each row's position, end-aligned causal masking): K7's forward
    first, then every backward on the kernel's own forward results. K8 runs
    on ``segments`` q segments placed by q_pos_offset, their dq rows
    concatenated and their dk/dv shares summed in f32, as the packed long
    branch runs it. Rows that attend nothing must give out and dq exactly 0.
    With ``controls`` the planted faults of each product are checked too.
    Returns the max abs errors of out and of each backward's worst grad."""
    from distributed_tensorflow_tpu_torch.ops.rope import rope_tables

    q, k, v, g = _long_operands(b, h, kv, sq, skv, d, dtype, seed)
    V = lambda t: t.transpose(1, 2)  # BSHD <-> BHSD view
    cos = sin = None
    if rope:
        cos, sin = rope_tables(d, skv, theta, device="cuda")
    off = skv - sq
    out, lse = A.flash_forward_kernel(V(q), V(k), V(v), causal, window, None, off, cos, sin,
                                      counter="bshd_fwd")
    seg = sq // segments
    parts = [A.flash_backward_bshd(q[:, a:a + seg], k, v, V(out)[:, a:a + seg],
                                   lse[:, :, a:a + seg].contiguous(), g[:, a:a + seg], causal,
                                   window, None, off + a, cos, sin)
             for a in range(0, sq, seg)]
    k8 = (V(torch.cat([p[0] for p in parts], dim=1)),
          V(sum(p[1].float() for p in parts)).to(dtype), V(sum(p[2].float() for p in parts)).to(dtype))
    del parts
    args = (causal, window, None, off, cos, sin)
    dk6, dv6, delta = A.flash_backward_dkv_kernel(V(q), V(k), V(v), out, lse, V(g), *args)
    k5_source = A.backward_dq_kernel(dtype, A._instance_dim(d))
    before = A.SOURCE_LAUNCHES[k5_source]
    dq5 = A.flash_backward_dq_kernel(V(q), V(k), V(v), lse, V(g), delta, *args)
    torch.cuda.synchronize()
    if A.SOURCE_LAUNCHES[k5_source] != before + 1:
        fail(f"{case}: K5 did not run {k5_source}.cu")
    emit(phase="kernels", case=case, k5_source=k5_source)
    ref_out, ref_lse = A.flash_forward_reference(V(q), V(k), V(v), *args)
    ref = A.flash_backward_reference(V(q), V(k), V(v), out, lse, V(g), *args)
    outputs = (("out", out), ("lse", lse), *zip(("k8_dq", "k8_dk", "k8_dv"), k8),
               ("k5_dq", dq5), ("k6_dk", dk6), ("k6_dv", dv6))
    for name, t in outputs:
        if not torch.isfinite(t).all():
            fail(f"{case}: non-finite {name}")
    dead = _masked_rows(case, lse, ref_lse, out, k8[0], dq5)
    errs = {"bshd_fwd": _check(case, "out", dtype, out, ref_out, "out")}
    _check(case, "lse", dtype, lse[~dead], ref_lse[~dead], "lse")
    errs["bshd_bwd"] = max(_check(case, f"k8_{n}", dtype, t, r, "dqkv")
                           for n, t, r in zip(("dq", "dk", "dv"), k8, ref))
    errs["bwd_dq"] = _check(case, "k5_dq", dtype, dq5, ref[0], "dqkv")
    errs["bwd_dkv"] = max(_check(case, f"k6_{n}", dtype, t, r, "dqkv")
                          for n, t, r in zip(("dk", "dv"), (dk6, dv6), ref[1:]))
    # The delta K6 leaves for K5, rowsum(dO∘O) in f32, by the lse limit.
    _check(case, "k6_delta", dtype, delta, (V(g).float() * out.float()).sum(-1), "lse")
    if controls:
        qh, kh, vh, gh = V(q), V(k), V(v), V(g)
        fault_controls(f"{case} K8", qh, kh, vh, gh, out, lse, k8, ref_out, ref)
        fault_controls(f"{case} K5", qh, kh, vh, gh, None, lse, (dq5, None, None), ref_out, ref,
                       products=("dq: dS.K",))
        fault_controls(f"{case} K6", qh, kh, vh, gh, None, lse, (None, dk6, dv6), ref_out, ref,
                       products=("dk: dS^T.Q", "dv: P^T.dO"))
        if d == 256 or k5_source == "flash_bwd_dq_cols_sm90":
            # K5 splits dq by columns at 256, and over its warpgroups at 384/512
            column_half_control(f"{case} K5", dq5, ref[0], "dq")
    return errs


def phase_kernels_long():
    """K5-K8: the long-context segment call (one batch row, 4 query heads on
    1 kv head, seq 8192, head_dim 128, bf16, rope θ 500000, four segments of
    2048 rows: the trainer's call per kv head group, cut to one group so the
    plain version fits), GQA + window + cross-length cases in bf16 and f32,
    fully masked rows, and the planted faults on a causal call."""
    errs = compare_long("long_segment_call", 1, 4, 1, LONG["seq_len"], LONG["seq_len"], 128,
                        torch.bfloat16, rope=True, segments=4, seed=20)
    # K1 with rope runs this forward (rotate pass included) at this length.
    errs["flash_fwd_rope"] = errs["bshd_fwd"]
    for dtype in (torch.bfloat16, torch.float32):
        compare_long("long_gqa_window_cross_rope_d64", 2, 8, 2, 192, 320, 64, dtype, window=100,
                     rope=True, segments=2, seed=21)
    compare_long("long_noncausal_cross_d128", 1, 4, 2, 136, 200, 128, torch.float32,
                 causal=False, seed=22)
    compare_long("long_fully_masked_rows_d64", 2, 4, 4, 200, 72, 64, torch.float32, seed=23)
    # K6 on the warpgroup backward (bf16) where the cases above leave it
    # untried.
    compare_long("long_noncausal_cross_d128_bf16", 1, 4, 2, 136, 200, 128, torch.bfloat16,
                 causal=False, seed=25)
    compare_long("long_fully_masked_rows_d64_bf16", 2, 4, 4, 200, 72, 64, torch.bfloat16,
                 seed=26)
    compare_long("long_controls", 1, 4, 1, 4096, 4096, 128, torch.bfloat16, seed=24,
                 controls=True)
    return errs


def _zero_counts():
    for counts in (A.KERNEL_LAUNCHES, A.SOURCE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _trainer_run(smi, phase, shape, flags, per_layer, remap=None, steps=STEPS,
                 interval=INTERVAL, forced=None):
    """The trainer (cli/train_lm.py) at ``shape`` with ``flags`` for
    ``steps`` steps: finite loss at every boundary, records naming the
    run's parallelism, and exactly ``per_layer`` launches a layer a step on
    their sources (:func:`expected_sources` with ``remap``). With ``forced``
    (a map of source to source, :data:`PLAIN_DESIGN`) both directions run
    the forced sources. Returns the launches of ``per_layer``'s counters,
    the records and the peak device memory."""
    from distributed_tensorflow_tpu_torch.cli import train_lm

    argv = [
        "--d_model", str(shape["d_model"]), "--num_heads", str(shape["num_heads"]),
        "--num_layers", str(shape["num_layers"]), "--d_ff", str(shape["d_ff"]),
        "--seq_len", str(shape["seq_len"]), "--batch_size", str(shape["batch_size"]),
        "--use_bias", "0", "--attention", "flash", "--training_steps", str(steps),
        "--eval_step_interval", str(interval), "--device", "cuda", *flags,
    ]
    parallelism = flags[flags.index("--parallelism") + 1] if "--parallelism" in flags else "dp"
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if forced:
            stack.enter_context(kernel_source("forward", forced["flash_fwd_sm90"]))
            stack.enter_context(kernel_source("backward", forced["flash_bwd_sm90"]))
        stack.enter_context(contextlib.redirect_stdout(buf))
        train_lm.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(A.KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    records = [json.loads(line) for line in buf.getvalue().splitlines()]
    for r in records:
        emit(phase=phase, **r)
    if [r["step"] for r in records] != list(range(interval, steps + 1, interval)):
        fail(f"{phase}: unexpected boundaries {[r['step'] for r in records]}")
    if not all(r["parallelism"] == parallelism for r in records):
        fail(f"{phase}: records name another parallelism")
    if not all(r["loss"] == r["loss"] and abs(r["loss"]) < float("inf") for r in records):
        fail(f"{phase}: non-finite loss")
    want = {k: per_layer.get(k, 0) * shape["num_layers"] * steps for k in A.KERNEL_LAUNCHES}
    # Every forward and backward launch ran a warpgroup kernel (or, forced,
    # the plain-design one).
    sources, want_sources = dict(A.SOURCE_LAUNCHES), expected_sources(want, remap)
    emit(phase=phase, launches=launches, expected=want, source_launches=sources,
         expected_sources=want_sources, wall_s=round(wall, 2))
    if launches != want:
        fail(f"{phase}: kernel launches {launches}, expected {want}")
    if sources != want_sources:
        fail(f"{phase}: launches by source {sources}, expected {want_sources}")
    last = records[-1]
    if "steps_per_sec" not in last:
        fail(f"{phase}: no timed window")
    emit(phase=phase, steps_per_sec=last["steps_per_sec"],
         tokens_per_sec=last["tokens_per_sec"], mfu=last.get("mfu"),
         max_memory_allocated=peak, card=smi)
    return {k: v for k, v in launches.items() if k in per_layer}, records, peak


def phase_main(smi, path, steps=STEPS, interval=INTERVAL, forced=None):
    """The trainer on one main path (:data:`MAIN_PATHS`) for ``steps``
    steps, by :func:`_trainer_run`; with ``forced`` every launch goes to
    the forced sources instead. Returns the path's launches, its records
    and its peak device memory."""
    flags, per_layer, remap = MAIN_PATHS[path]
    phase = f"main_{path}" + ("_plain_design" if forced else "")
    return _trainer_run(smi, phase, SHAPES[path], flags, per_layer, forced or remap, steps,
                        interval, forced)


def phase_d512(smi):
    """The trainer at the flagship's width over 4 heads of 512 (`d512`, 6
    steps): 8 K1 on the warpgroup forward flash_fwd_cols_sm90.cu, 8 K5 on
    flash_bwd_dq_cols_sm90.cu and 8 K6 on flash_bwd_cols_sm90.cu a step (at
    head_dim 512 the gate leaves the fused backward for the two-pass pair),
    and no other launch, and a falling loss. Returns the path's launches."""
    launches, records, _ = phase_main(smi, "d512")
    if not records[-1]["loss"] < records[0]["loss"]:
        fail(f"main_d512: the loss did not fall ({[r['loss'] for r in records]})")
    return launches


def phase_wide(smi):
    """The `wide` path as trained (phase_main's 6 steps) and again for 3
    steps with both directions forced to the plain-design kernels
    (flash_fwd.cu, flash_bwd.cu): its "was" reading, in the same run. The
    loss must fall over the 6 steps. Returns the path's launches."""
    launches, records, _ = phase_main(smi, "wide")
    if not records[-1]["loss"] < records[0]["loss"]:
        fail(f"main_wide: the loss did not fall ({[r['loss'] for r in records]})")
    new = records[-1]
    was = phase_main(smi, "wide", steps=3, interval=1, forced=PLAIN_DESIGN)[1][-1]
    emit(phase="main_wide", steps_per_sec=new["steps_per_sec"],
         plain_design_steps_per_sec=was["steps_per_sec"],
         speedup=new["steps_per_sec"] / was["steps_per_sec"], mfu=new.get("mfu"),
         plain_design_mfu=was.get("mfu"), card=smi)
    return launches


# The pipeline phase: each run's trainer flags (beside phase 4's flagship
# flags), its launches a layer a step, and the phase 4 path whose losses it
# must equal within LOSS_TOL. One stage and one rank: the schedule, the
# microbatch split and the collect run on one card; cli/tp_cards.py holds
# the splits across cards.
PIPELINE_RUNS = {
    "pp": (["--parallelism", "pp", "--model_parallel", "1", "--num_microbatches", "2"],
           {"flash_fwd": 2, "flash_bwd": 2}, "dp"),
    "3d": (["--parallelism", "3d", "--pipeline_parallel", "1", "--model_parallel", "1",
            "--num_microbatches", "2"], {"bhsd_fwd": 2, "bhsd_bwd": 2}, "tp"),
    "dp_remat": (["--remat"], {"flash_fwd": 2, "flash_bwd": 1}, "dp"),
}


def phase_pipeline(smi, base):
    """pp, 3d and dp under --remat at the flagship (:data:`PIPELINE_RUNS`),
    each by :func:`_trainer_run` (its exact launches on the warpgroup
    sources) and against ``base`` (phase 4's ``{path: (records, peak
    bytes)}``): losses within ``cli/tp_cards.py``'s LOSS_TOL (relative) of
    the base path's. Prints steps/s, tokens/s, MFU and the peak device
    memory beside the base path's. Returns each run's launches."""
    from distributed_tensorflow_tpu_torch.cli.tp_cards import LOSS_TOL

    out = {}
    for name, (flags, per_layer, against) in PIPELINE_RUNS.items():
        phase = f"pipeline_{name}"
        launches, records, peak = _trainer_run(smi, phase, FLAGSHIP, flags, per_layer)
        base_records, base_peak = base[against]
        losses, base_losses = [r["loss"] for r in records], [r["loss"] for r in base_records]
        worst = max(abs(a - b) / abs(b) for a, b in zip(losses, base_losses))
        last, base_last = records[-1], base_records[-1]
        emit(phase=phase, against=against, losses=losses, base_losses=base_losses,
             loss_rel_diff=worst, loss_tol=LOSS_TOL, steps_per_sec=last["steps_per_sec"],
             against_steps_per_sec=base_last["steps_per_sec"], max_memory_allocated=peak,
             against_max_memory_allocated=base_peak, card=smi)
        if len(losses) != len(base_losses) or not worst <= LOSS_TOL:
            fail(f"{phase}: losses {losses} against {against}'s {base_losses}: "
                 f"{worst} > {LOSS_TOL}")
        out[name] = launches
    return out


# The trainer at its own defaults (d_model 128 over 4 heads: head_dim 32, 4
# layers, seq 128, batch 8), at head_dim 80 (d_model 320, padded to 128) and
# at head_dim 256 (d_model 1024): extra flags, and the forward and backward
# sources each must run.
CLI_RUNS = {"cli_defaults_d32": ([], "flash_fwd", "flash_bwd"),
            "cli_d80_padded": (["--d_model", "320"], "flash_fwd_sm90", "flash_bwd_sm90"),
            "cli_d256": (["--d_model", "1024"], "flash_fwd_sm90", "flash_bwd_sm90")}
CLI_STEPS, CLI_LAYERS = 4, 4


def phase_cli_head_dims():
    """``cli/train_lm.py --attention flash`` on the card at head_dim 32, 80
    and 256 for CLI_STEPS steps: finite losses, falling at head_dim 256, one
    K1 and one K2 launch a layer a step and no other, each through its
    source. Returns each run's launches."""
    from distributed_tensorflow_tpu_torch.cli import train_lm

    runs = {}
    for name, (flags, fwd_source, bwd_source) in CLI_RUNS.items():
        _zero_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_lm.main(["--attention", "flash", "--device", "cuda", "--training_steps",
                           str(CLI_STEPS), "--eval_step_interval", "2", *flags])
        records = [json.loads(line) for line in buf.getvalue().splitlines()]
        n = CLI_STEPS * CLI_LAYERS
        want = {k: n if k in ("flash_fwd", "flash_bwd") else 0 for k in A.KERNEL_LAUNCHES}
        launches, sources = dict(A.KERNEL_LAUNCHES), dict(A.SOURCE_LAUNCHES)
        emit(phase="cli_head_dims", run=name, losses=[r["loss"] for r in records],
             launches=launches, expected=want, source_launches=sources)
        if [r["step"] for r in records] != [2, 4]:
            fail(f"{name}: unexpected boundaries {[r['step'] for r in records]}")
        if not all(abs(r["loss"]) < float("inf") for r in records):
            fail(f"{name}: non-finite loss")
        if name == "cli_d256" and not records[-1]["loss"] < records[0]["loss"]:
            fail(f"{name}: the loss did not fall ({[r['loss'] for r in records]})")
        want_sources = {src: n if src in (fwd_source, bwd_source) else 0 for src in sources}
        if launches != want or sources != want_sources:
            fail(f"{name}: launches {launches} by source {sources}, expected {want} on "
                 f"{fwd_source} and {bwd_source}")
        runs[name] = launches
    return runs


def _cfg(shape=FLAGSHIP, attention="flash", num_layers=None):
    from distributed_tensorflow_tpu_torch.models.transformer import TransformerConfig

    rope = "rope_theta" in shape
    return TransformerConfig(
        vocab_size=256, d_model=shape["d_model"], num_heads=shape["num_heads"],
        num_kv_heads=shape.get("num_kv_heads"), num_layers=num_layers or shape["num_layers"],
        d_ff=shape["d_ff"], max_seq_len=shape["seq_len"], use_bias=False, attention=attention,
        compute_dtype=torch.bfloat16, position="rope" if rope else "learned",
        rope_theta=shape.get("rope_theta", 10000.0),
    )


def _loss_and_backward(model, tokens):
    from distributed_tensorflow_tpu_torch.models.transformer import next_token_loss

    loss = next_token_loss(model(tokens), tokens)
    loss.backward()
    return loss.item()


# The long path's three backward routes, each forced through the trainer's
# own dispatch (the JAX package's gate), and each one's launches for a step
# of ROUTE_LAYERS layers.
ROUTE_LAYERS = 2
ROUTES = {
    "k8_segments": (None, False, {"flash_fwd": 1, "bshd_bwd": 4}),
    "k2_whole": (1 << 40, False, {"flash_fwd": 1, "flash_bwd": 1}),
    "k5_k6_two_pass": (None, True, {"flash_fwd": 1, "bwd_dkv": 1, "bwd_dq": 1}),
}


@contextlib.contextmanager
def backward_route(name):
    """Set the port's backward gate so that the long path takes route
    ``name``: the default (K8 on four q segments), the scratch limit raised
    (K2 in one call), or no segmentation (the two-pass K5/K6)."""
    limit, two_pass, _ = ROUTES[name]
    saved = A._FUSED_BWD_SCRATCH_LIMIT, A._fused_segment_rows
    A._FUSED_BWD_SCRATCH_LIMIT = limit
    if two_pass:
        A._fused_segment_rows = lambda *a: None
    try:
        yield
    finally:
        A._FUSED_BWD_SCRATCH_LIMIT, A._fused_segment_rows = saved


def phase_routes():
    """One long-context step (batch 1, ROUTE_LAYERS layers, full width) on
    the same weights and tokens through each backward route: the same loss,
    and the first layer's qkv weight gradient within 5e-2 of its largest
    value (bf16: the routes round dq and the dk/dv partial sums at
    different places)."""
    from distributed_tensorflow_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM(_cfg(LONG, num_layers=ROUTE_LAYERS), seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    tokens = torch.randint(0, 256, (1, LONG["seq_len"]), device="cuda", generator=gen)
    results, route_launches = {}, {}
    for name, (_, _, per_layer) in ROUTES.items():
        model.zero_grad(set_to_none=True)
        _zero_counts()
        with backward_route(name):
            loss = _loss_and_backward(model, tokens)
        launches = {k: v for k, v in A.KERNEL_LAUNCHES.items() if v}
        want = {k: n * ROUTE_LAYERS for k, n in per_layer.items()}
        sources, want_sources = dict(A.SOURCE_LAUNCHES), expected_sources(want)
        emit(phase="routes", route=name, loss=loss, launches=launches, expected=want,
             source_launches=sources, expected_sources=want_sources)
        if launches != want or sources != want_sources:
            fail(f"routes: {name} launched {launches} by source {sources}, expected {want} "
                 f"by source {want_sources}")
        results[name] = (loss, model.block_0.qkv.weight.grad.float().clone())
        route_launches[name] = launches
    del model
    torch.cuda.empty_cache()
    for name in ("k2_whole", "k5_k6_two_pass"):
        _parity("routes", name, results[name], "k8_segments", results["k8_segments"])
    route_launches["flash_attention_bshd"] = phase_bshd()
    return route_launches


def phase_bshd():
    """The public BSHD op, ``flash_attention_bshd``, forward and backward
    through autograd at one batch row of the long path's call (seq 8192, 16
    query heads on 4 kv heads of 128, bf16, causal): one K7 launch and K8 on
    four q segments, out and grads held against the plain versions (the
    backward's on the kernel's own forward results)."""
    s, h, kv = LONG["seq_len"], LONG["num_heads"], LONG["num_kv_heads"]
    d = LONG["d_model"] // h
    q, k, v, g = _long_operands(1, h, kv, s, s, d, torch.bfloat16, seed=40)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    _zero_counts()
    out = A.flash_attention_bshd(*leaves, causal=True)
    out.backward(g)
    torch.cuda.synchronize()
    launches = {name: n for name, n in A.KERNEL_LAUNCHES.items() if n}
    want = {"bshd_fwd": 1, "bshd_bwd": s // A._segment_rows(s, d)}
    emit(phase="routes", route="flash_attention_bshd", launches=launches, expected=want)
    if launches != want:
        fail(f"routes: flash_attention_bshd launched {launches}, expected {want}")
    V = lambda t: t.detach().transpose(1, 2)  # BSHD -> BHSD view
    _, lse = A.flash_forward_bshd(*(t.detach() for t in leaves), True)
    ref_out, _ = A.flash_forward_reference(V(q), V(k), V(v), True)
    ref = A.flash_backward_reference(V(q), V(k), V(v), V(out), lse, V(g), True)
    _check("bshd_api", "out", torch.bfloat16, V(out), ref_out, "out")
    for name, t, r in zip(("dq", "dk", "dv"), leaves, ref):
        if not torch.isfinite(t.grad).all():
            fail(f"bshd_api: non-finite {name}")
        _check("bshd_api", name, torch.bfloat16, V(t.grad), r, "dqkv")
    del q, k, v, g, leaves, out, lse, ref_out, ref
    torch.cuda.empty_cache()
    return want


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


# The flagship parity step's depth: 2 of its 8 layers (one layer's math is
# what it checks; the script's time went to the sequence-parallel phases).
PARITY_LAYERS = 2


def phase_parity():
    from distributed_tensorflow_tpu_torch.models.transformer import TransformerLM
    from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import TpTransformerLM

    fl = FLAGSHIP
    d = fl["d_model"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, 256, (2, fl["seq_len"]), device="cuda", generator=gen)
    results = {}
    for attention in ("flash", "dense"):
        model = TransformerLM(_cfg(attention=attention, num_layers=PARITY_LAYERS), seed=0,
                              device="cuda")
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
        model = TpTransformerLM(_cfg(attention=attention, num_layers=PARITY_LAYERS),
                                device="cuda")
        model.load_state_dict(tp_state)
        loss = _loss_and_backward(model, tokens)
        results[f"tp_{attention}"] = (loss, model.block_0.q.weight.grad.float().clone())
        del model
        torch.cuda.empty_cache()
    _parity("parity_tp", "tp_flash", results["tp_flash"], "dp_flash", results["flash"])
    _parity("parity_tp", "tp_flash", results["tp_flash"], "tp_dense", results["tp_dense"])


# `wide` cut for its parity step: 2 layers, batch 1, seq 2048 (the backward
# gate still segments it: K8 on two q segments of 1024 rows).
WIDE_PARITY = dict(WIDE, num_layers=2, batch_size=1, seq_len=2048)


def phase_parity_wide():
    """One step at the `wide` width (WIDE_PARITY) through the kernels and
    through plain dense attention, on the same weights and tokens, by the
    flagship parity check's limits; the flash step's launches must be K1
    and K8 on the warpgroup kernels."""
    from distributed_tensorflow_tpu_torch.models.transformer import TransformerLM

    shape, d = WIDE_PARITY, WIDE_PARITY["d_model"]
    gen = torch.Generator(device="cuda").manual_seed(8)
    tokens = torch.randint(0, 256, (shape["batch_size"], shape["seq_len"]), device="cuda",
                           generator=gen)
    n_seg = shape["seq_len"] // A._segment_rows(shape["seq_len"], d // shape["num_heads"])
    want = {"flash_fwd": shape["num_layers"], "bshd_bwd": n_seg * shape["num_layers"]}
    results = {}
    for attention in ("flash", "dense"):
        model = TransformerLM(_cfg(shape, attention=attention), seed=0, device="cuda")
        _zero_counts()
        loss = _loss_and_backward(model, tokens)
        launches = {k: n for k, n in A.KERNEL_LAUNCHES.items() if n}
        sources, want_sources = dict(A.SOURCE_LAUNCHES), expected_sources(
            want if attention == "flash" else {})
        emit(phase="parity_wide", attention=attention, loss=loss, launches=launches,
             source_launches={k: n for k, n in sources.items() if n})
        if launches != (want if attention == "flash" else {}) or sources != want_sources:
            fail(f"parity_wide: {attention} launched {launches} by source {sources}")
        results[attention] = (loss, model.block_0.qkv.weight.grad.float()[:d].clone())
        del model
        gc.collect()
        torch.cuda.empty_cache()
    _parity("parity_wide", "flash", results["flash"], "dense", results["dense"])


def _sdpa(q, k, v, g):
    """The library's calls on (B, H, S, D) tensors: forward, forward +
    backward, and backward alone (None without ``g``)."""
    import torch.nn.functional as F

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, is_causal=True)

    if g is None:
        return fwd, None, None
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def fwd_bwd():
        F.scaled_dot_product_attention(ql, kl, vl, is_causal=True).backward(g)

    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

    def bwd():
        torch.autograd.grad(ol, (ql, kl, vl), g, retain_graph=True)

    return fwd, fwd_bwd, bwd


@contextlib.contextmanager
def kernel_source(direction, name):
    """Send every launch of ``direction`` — "forward", "backward" (the fused
    backward), "backward_dq" (K5) or "pipe_forward" (K9) — to
    ``csrc/<name>.cu``, whatever :func:`attention.forward_kernel`,
    :func:`attention.backward_kernel`, :func:`attention.backward_dq_kernel`
    or :func:`attention.pipe_forward_kernel` would pick: the turns' old
    kernel."""
    attr = f"{direction}_kernel"
    saved = getattr(A, attr)
    setattr(A, attr, lambda *args: name)
    try:
        yield
    finally:
        setattr(A, attr, saved)


# Each new source's direction and the source it replaced, timed in turns
# (new, old, old, new).
TURNS = {"flash_fwd_sm90": ("forward", "flash_fwd"), "flash_bwd_sm90": ("backward", "flash_bwd"),
         "flash_bwd_dq_sm90": ("backward_dq", "flash_bwd_dq"),
         "flash_fwd_pipe_sm90": ("pipe_forward", "flash_fwd_pipe"),
         "flash_fwd_cols_sm90": ("forward", "flash_fwd_dstream"),
         "flash_bwd_cols_sm90": ("backward", "flash_bwd_dstream"),
         "flash_bwd_dq_cols_sm90": ("backward_dq", "flash_bwd_dq_dstream")}


def _turns(name, run, notes, phase="turns"):
    """``run`` on the new source of timing row ``name`` and on the one it
    replaced in turns (new, old, old, new); the readings go into ``name``'s
    notes."""
    new = SOURCES[name]
    direction, old = TURNS[new]
    order = (new, old, old, new)
    turns = []
    for source in order:
        with kernel_source(direction, source):
            turns.append(cuda_ms(run, 10))
    old_ms, new_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    emit(phase=phase, kernel=name, order=list(order), ms=turns, old_ms=old_ms, new_ms=new_ms)
    notes.setdefault(name, {}).update(
        turns_ms=dict(order=list(order), ms=turns),
        old_kernel=f"distributed_tensorflow_tpu_torch/csrc/{old}.cu", old_kernel_ms=old_ms)


def phase_turns(notes):
    """The warpgroup kernels against the bf16 instances of the kernels they
    replaced, flash_fwd.cu, flash_bwd.cu and flash_bwd_dq.cu, on the same
    inputs in turns (new, old, old, new) at each path's call: K1 and K2 on
    the dp path's packed qkv, K3 and K4 on the tp path's head views, K7 and
    K8 (one whole call) at the long shape, K1 with rope on the long path's
    packed qkv, K6 and K5 at the long shape, K1 and K2 at head_dim 256 at
    Gemma 7B's width, and K1 with rope and one K8 segment call at the
    `wide` call. Adds each kernel's turns and the old kernel's mean time to
    its row's notes."""
    from distributed_tensorflow_tpu_torch.ops.rope import rope_tables

    fl = FLAGSHIP
    b, s, h = fl["batch_size"], fl["seq_len"], fl["num_heads"]
    d = fl["d_model"] // h
    lb, ls, lh, lkv = LONG["batch_size"], LONG["seq_len"], LONG["num_heads"], \
        LONG["num_kv_heads"]

    def packed():
        qkv, g = _packed(b, s, h, h, d, torch.bfloat16, seed=3)
        out, lse = A.flash_forward_qkv_kernel(qkv, h, h, True, None, None, None, None)
        return {"flash_fwd": lambda: A.flash_forward_qkv_kernel(qkv, h, h, True, None, None,
                                                                None, None),
                "flash_bwd": lambda: A.flash_backward_qkv_kernel(qkv, out, lse, g, h, h, True,
                                                                 None, None, None, None)}

    def views():
        q, k, v, g = _bhsd(b, h, s, s, d, torch.bfloat16, seed=10, bshd=True)
        out, lse = A.flash_forward_kernel(q, k, v, True)
        return {"bhsd_fwd": lambda: A.flash_forward_kernel(q, k, v, True),
                "bhsd_bwd": lambda: A.flash_backward_kernel(q, k, v, out, lse, g, True)}

    def long_bshd():
        q, k, v, g = _long_operands(lb, lh, lkv, ls, ls, d, torch.bfloat16, seed=30)
        out, lse = A.flash_forward_bshd(q, k, v, True)
        V = lambda t: t.transpose(1, 2)
        _, _, delta = A.flash_backward_dkv_kernel(V(q), V(k), V(v), V(out), lse, V(g), True)
        return {"bshd_fwd": lambda: A.flash_forward_bshd(q, k, v, True),
                "bshd_bwd": lambda: A.flash_backward_bshd(q, k, v, out, lse, g, True),
                "bwd_dkv": lambda: A.flash_backward_dkv_kernel(V(q), V(k), V(v), V(out), lse,
                                                               V(g), True),
                "bwd_dq": lambda: A.flash_backward_dq_kernel(V(q), V(k), V(v), lse, V(g), delta,
                                                             True)}

    def long_rope():
        gen = torch.Generator(device="cuda").manual_seed(31)
        qkv = torch.randn(lb, ls, (lh + 2 * lkv) * d, device="cuda", generator=gen)
        qkv = qkv.to(torch.bfloat16)
        cos, sin = rope_tables(d, ls, LONG["rope_theta"], device="cuda")
        return {"flash_fwd_rope": lambda: A.flash_forward_qkv_kernel(qkv, lh, lkv, True, None,
                                                                     cos, sin, None)}

    def gemma():
        b, s, h, d = (GEMMA[key] for key in ("batch_size", "seq_len", "num_heads", "head_dim"))
        qkv, g = _packed(b, s, h, h, d, torch.bfloat16, seed=64)
        out, lse = A.flash_forward_qkv_kernel(qkv, h, h, True, None, None, None, None)
        return {"flash_fwd_d256": lambda: A.flash_forward_qkv_kernel(qkv, h, h, True, None, None,
                                                                     None, None),
                "flash_bwd_d256": lambda: A.flash_backward_qkv_kernel(qkv, out, lse, g, h, h,
                                                                      True, None, None, None,
                                                                      None)}

    def wide():
        ops = _wide_operands()
        return {"flash_fwd_rope_d256_wide": ops["forward"], "bshd_bwd_d256_wide": ops["segment"]}

    for make in (packed, views, long_bshd, long_rope, gemma, wide):
        for name, run in make().items():
            _turns(name, run, notes)
        torch.cuda.empty_cache()


def _wide_operands():
    """The `wide` path's attention call (batch 2, seq 8192, 16 heads of 256,
    packed qkv, rope θ 10000): its operands and its two launches as the
    trainer makes them — ``forward``, K1 with rope, and ``segment``, K8 on
    the last of its eight q segments (1024 rows at offset 7168 against all
    8192 keys, rope at the rows' positions), the heaviest of them."""
    from distributed_tensorflow_tpu_torch.ops.rope import rope_tables

    b, s, h = WIDE["batch_size"], WIDE["seq_len"], WIDE["num_heads"]
    d = WIDE["d_model"] // h
    gen = torch.Generator(device="cuda").manual_seed(83)
    qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen).to(torch.bfloat16)
    go = torch.randn(b, s, h * d, device="cuda", generator=gen).to(torch.bfloat16)
    cos, sin = rope_tables(d, s, WIDE["rope_theta"], device="cuda")
    out, lse = A.flash_forward_qkv_kernel(qkv, h, h, True, None, cos, sin, None)
    seg = A._segment_rows(s, d)
    a = s - seg
    q, k, v = A._packed_heads(qkv, h, h, d)
    rows = slice(a, s)
    q_seg = q[:, :, rows]
    out_seg, g_seg = A._heads(out, d)[:, :, rows], A._heads(go, d)[:, :, rows]
    lse_seg = lse[:, :, rows].contiguous()
    dq_seg = torch.empty(b, h, seg, d, dtype=qkv.dtype, device="cuda")
    dk_s, dv_s = (torch.empty(b, h, s, d, dtype=qkv.dtype, device="cuda") for _ in range(2))

    def segment():
        A._launch_backward("bshd_bwd", q_seg, k, v, out_seg, g_seg, lse_seg, dq_seg, dk_s, dv_s,
                           True, None, a, None, cos, sin)

    return dict(qkv=qkv, go=go, cos=cos, sin=sin, out=out, lse=lse, b=b, s=s, h=h, d=d, a=a,
                seg=seg, q=q, k=k, v=v, q_seg=q_seg, out_seg=out_seg, g_seg=g_seg,
                lse_seg=lse_seg, dq_seg=dq_seg, dk_s=dk_s, dv_s=dv_s, segment=segment,
                forward=lambda: A.flash_forward_qkv_kernel(qkv, h, h, True, None, cos, sin, None))


def phase_timing(launches, errs, notes):
    """K1/K2 at the dp path's call, K3/K4 at the tp path's, K1/K2 at head_dim
    256 (Gemma 7B's width) and at head_dim 32 (the CLI's call)."""
    from distributed_tensorflow_tpu_torch.utils.flops import chip_hbm_bandwidth, chip_peak_flops

    fl = FLAGSHIP
    b, s, h = fl["batch_size"], fl["seq_len"], fl["num_heads"]
    d = fl["d_model"] // h
    peak, bw = chip_peak_flops(), chip_hbm_bandwidth()
    if peak is None:
        fail(f"timing: no peak rates known for {torch.cuda.get_device_name(0)}")
    kernels = _time_packed_pair(("flash_fwd", "flash_bwd"), b, s, h, d, 3, launches, errs, peak,
                                bw, notes)

    # K3/K4 on the tp path's head-transposed views.
    fwd_flops = 4 * b * h * d * (s * (s + 1) // 2)  # q·kᵀ and p·v over the causal pairs
    q, k, v, g = _bhsd(b, h, s, s, d, torch.bfloat16, seed=10, bshd=True)
    out, lse = A.flash_forward_kernel(q, k, v, True)
    lib = _sdpa(q, k, v, g)
    t_bytes = q.numel() * q.element_size()  # one of q, k, v, out, dO, dq, dk, dv
    lse_bytes = lse.numel() * 4
    runs = {
        "bhsd_fwd": (
            (fwd_flops, 4 * t_bytes + lse_bytes),
            lambda: A.flash_forward_kernel(q, k, v, True),
            lambda: A.flash_forward_reference(q, k, v, True),
            lib[0], None,
        ),
        # reads q, k, v, out, dO, lse, writes dq, dk, dv: five products
        "bhsd_bwd": (
            (fwd_flops * 5 // 2, 8 * t_bytes + lse_bytes),
            lambda: A.flash_backward_kernel(q, k, v, out, lse, g, True),
            lambda: A.flash_backward_reference(q, k, v, out, lse, g, True),
            lib[1], lib[2],
        ),
    }
    kernels += _time_kernels(runs, launches, errs, peak, bw,
                             dict(B=b, S=s, H=h, D=d, dtype="bf16", causal=True,
                                  layout="BSHD views"), notes)
    del q, k, v, g, out, lse, lib
    torch.cuda.empty_cache()
    gm = GEMMA
    kernels += _time_packed_pair(("flash_fwd_d256", "flash_bwd_d256"), gm["batch_size"],
                                 gm["seq_len"], gm["num_heads"], gm["head_dim"], 64, launches,
                                 errs, peak, bw, notes)
    return kernels + _time_packed_pair(("flash_fwd_d32", "flash_bwd_d32"), 8, 128, 4, 32, 84,
                                       launches, errs, peak, bw, notes)


def _time_packed_pair(names, b, s, h, d, seed, launches, errs, peak, bw, notes):
    """K1 and K2 (rows ``names``) on packed bf16 qkv of batch ``b``, seq
    ``s``, ``h`` heads of ``d`` made from ``seed``, causal, against their
    plain versions, bounds and SDPA (its forward; its forward+backward and
    its backward alone)."""
    fwd_flops = 4 * b * h * d * (s * (s + 1) // 2)  # q·kᵀ and p·v over the causal pairs
    qkv, g = _packed(b, s, h, h, d, torch.bfloat16, seed=seed)
    args = (h, h, True, None, None, None)
    out, lse = A.flash_forward_qkv_kernel(qkv, *args, None)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in qkv.split(h * d, dim=-1))
    lib = _sdpa(q, k, v, g.reshape(b, s, h, d).transpose(1, 2))
    elt = qkv.element_size()
    qkv_bytes, o_bytes, lse_bytes = qkv.numel() * elt, out.numel() * elt, lse.numel() * 4
    runs = {
        names[0]: (
            (fwd_flops, qkv_bytes + o_bytes + lse_bytes),
            lambda: A.flash_forward_qkv_kernel(qkv, *args, None),
            lambda: A.flash_forward_qkv_reference(qkv, *args),
            lib[0], None,
        ),
        # reads qkv, out, lse, dO, writes dqkv: five products
        names[1]: (
            (fwd_flops * 5 // 2, 2 * qkv_bytes + 2 * o_bytes + lse_bytes),
            lambda: A.flash_backward_qkv_kernel(qkv, out, lse, g, *args, None),
            lambda: A.flash_backward_qkv_reference(qkv, out, lse, g, *args),
            lib[1], lib[2],
        ),
    }
    kernels = _time_kernels(runs, launches, errs, peak, bw,
                            dict(B=b, S=s, H=h, KV=h, D=d, dtype="bf16", causal=True), notes)
    del qkv, g, out, lse, q, k, v, lib
    torch.cuda.empty_cache()
    return kernels


def phase_timing_wide(launches, errs, notes):
    """The `wide` path's two launches at its call (_wide_operands): K1 with
    rope, and K8 on the last q segment. SDPA's operands are q and k rotated
    beforehand; for the segment its lower-right causal bias, which is our
    end-aligned mask there (the segment's last row sits at the last key)."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from distributed_tensorflow_tpu_torch.utils.flops import chip_hbm_bandwidth, chip_peak_flops

    peak, bw = chip_peak_flops(), chip_hbm_bandwidth()
    w = _wide_operands()
    b, s, h, d, a, seg = (w[key] for key in ("b", "s", "h", "d", "a", "seg"))
    qkv, cos, sin = w["qkv"], w["cos"], w["sin"]
    elt = qkv.element_size()
    table_bytes = 2 * cos.numel() * 4
    head_bytes = b * h * s * d * elt  # one of q, k, v, out over the whole sequence
    pairs = s * (s + 1) // 2
    q_rot = A._rotate(w["q"], cos, sin, 0)
    k_rot = A.rotate_k_reference(w["k"], cos, sin)
    lib = _sdpa(q_rot, k_rot, w["v"], None)
    runs = {"flash_fwd_rope_d256_wide": (
        # reads qkv and the tables, writes out and lse
        (4 * b * h * d * pairs, qkv.numel() * elt + head_bytes + b * h * s * 4 + table_bytes),
        w["forward"],
        lambda: [A.flash_forward_qkv_reference(qkv[i:i + 1], h, h, True, None, cos, sin)
                 for i in range(b)],
        lib[0], None)}
    kernels = _time_kernels(runs, launches, errs, peak, bw,
                            dict(B=b, S=s, H=h, KV=h, D=d, dtype="bf16", causal=True, rope=True,
                                 layout="packed qkv"), notes)
    del q_rot, lib

    # K8 on the segment: q rows [a, s) against keys [0, s).
    seg_pairs = seg * a + seg * (seg + 1) // 2
    q_seg_rot = A._rotate(w["q_seg"], cos, sin, a)
    g_seg = w["g_seg"]
    mask = causal_lower_right(seg, s)
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q_seg_rot, k_rot, w["v"]))

    def lib_fwd_bwd():
        F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask).backward(g_seg)

    o_lib = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)

    def lib_bwd():
        torch.autograd.grad(o_lib, (ql, kl, vl), g_seg, retain_graph=True)

    def plain(i):
        r = slice(i, i + 1)
        return A.flash_backward_reference(w["q_seg"][r], w["k"][r], w["v"][r], w["out_seg"][r],
                                          w["lse_seg"][r], g_seg[r], True, None, None, a, cos,
                                          sin)

    seg_bytes = b * h * seg * d * elt  # one of q, out, dO, dq over the segment
    runs = {"bshd_bwd_d256_wide": (
        # reads q, out, dO (the segment's rows), k, v, lse and the tables;
        # writes dq (the segment's rows) and the segment's dk, dv shares
        (4 * b * h * d * seg_pairs * 5 // 2,
         4 * seg_bytes + 4 * head_bytes + b * h * seg * 4 + table_bytes),
        w["segment"], lambda: [plain(i) for i in range(b)], lib_fwd_bwd, lib_bwd)}
    kernels += _time_kernels(runs, launches, errs, peak, bw,
                             dict(B=b, Sq=seg, Skv=s, q_pos_offset=a, H=h, KV=h, D=d, dtype="bf16",
                                  causal=True, rope=True, layout="packed qkv head views"), notes)
    del k_rot, q_seg_rot, ql, kl, vl, o_lib
    torch.cuda.empty_cache()
    time_wide_routes(w, peak)
    del w
    torch.cuda.empty_cache()
    return kernels


# The launches of one layer's backward at the `wide` call on each route:
# eight K8 segment calls (the gate's route), K2 in one call, or K6 + K5.
WIDE_ROUTES = {"k8_segments": {"bshd_bwd": 8}, "k2_whole": {"flash_bwd": 1},
               "k5_k6_two_pass": {"bwd_dkv": 1, "bwd_dq": 1}}


def time_wide_routes(w, peak):
    """One layer's backward at the `wide` call (_wide_operands: B 2, S 8192,
    16 heads of 256, rope θ 10000, packed qkv) through each route, forced
    through the gate's hooks (backward_route): its launches, which must be
    the route's (all on the warpgroup sources, K5 on
    flash_bwd_dq_sm90.cu), and its ms. A measurement only: the trainer's
    route stays the JAX gate's."""
    b, s, h, d = (w[key] for key in ("b", "s", "h", "d"))
    qkv, go, cos, sin, out, lse = (w[key] for key in ("qkv", "go", "cos", "sin", "out", "lse"))
    heads = A._packed_heads(qkv, h, h, d)
    want_sources = {"bshd_bwd": "flash_bwd_sm90", "flash_bwd": "flash_bwd_sm90",
                    "bwd_dkv": "flash_bwd_sm90", "bwd_dq": "flash_bwd_dq_sm90"}

    def route(name):
        def run():
            with backward_route(name):
                dqkv = torch.empty_like(qkv)
                A._backward_by_route("flash_bwd", "bshd_bwd", *heads, A._heads(out, d),
                                     A._heads(go, d), lse, *A._packed_heads(dqkv, h, h, d),
                                     True, None, 0, None, cos, sin)
        return run

    fwd_flops = 4 * b * h * d * (s * (s + 1) // 2)
    for name, want in WIDE_ROUTES.items():
        counts = dict(A.KERNEL_LAUNCHES), dict(A.SOURCE_LAUNCHES)
        route(name)()
        torch.cuda.synchronize()
        launches = {k: n - counts[0][k] for k, n in A.KERNEL_LAUNCHES.items() if n != counts[0][k]}
        sources = {k: n - counts[1][k] for k, n in A.SOURCE_LAUNCHES.items() if n != counts[1][k]}
        expected = {}
        for counter, n in want.items():
            expected[want_sources[counter]] = expected.get(want_sources[counter], 0) + n
        if launches != want or sources != expected:
            fail(f"timing_routes_wide: {name} launched {launches} by source {sources}, expected "
                 f"{want} by source {expected}")
        emit(phase="timing_routes_wide", route=name, ms=cuda_ms(route(name), 3), launches=launches,
             source_launches=sources, bound_ms=fwd_flops * 5 // 2 / peak * 1e3,
             shape=dict(B=b, S=s, H=h, KV=h, D=d, dtype="bf16", rope=True))


def phase_timing_long(launches, errs, notes):
    """K7, K8 (one whole call), K5 and K6 at the long-context call shape
    (batch 3, seq 8192, 16 query heads on 4 kv heads of 128, bf16, causal,
    BSHD operands), each beside its plain version (run one batch row at a
    time: the whole call's plain backward would need ~13 GB per S² tensor),
    its bound and SDPA (on kv heads repeated to 16 beforehand; forward for
    K7, forward+backward for K8, its backward alone — all three gradients —
    for K5 and K6). Then the three backward routes of one layer of the long
    path (packed qkv, rope) end to end."""
    from distributed_tensorflow_tpu_torch.ops.rope import rope_tables
    from distributed_tensorflow_tpu_torch.utils.flops import chip_hbm_bandwidth, chip_peak_flops

    b, s, h, kv = LONG["batch_size"], LONG["seq_len"], LONG["num_heads"], LONG["num_kv_heads"]
    d = LONG["d_model"] // h
    peak, bw = chip_peak_flops(), chip_hbm_bandwidth()
    fwd_flops = 4 * b * h * d * (s * (s + 1) // 2)  # q·kᵀ and p·v over the causal pairs
    q, k, v, g = _long_operands(b, h, kv, s, s, d, torch.bfloat16, seed=30)
    V = lambda t: t.transpose(1, 2)
    out, lse = A.flash_forward_bshd(q, k, v, True)
    _, _, delta = A.flash_backward_dkv_kernel(V(q), V(k), V(v), V(out), lse, V(g), True)
    kx, vx = (V(t).repeat_interleave(h // kv, dim=1) for t in (k, v))
    lib = _sdpa(V(q), kx, vx, V(g))
    qb, kvb, sb = q.numel() * q.element_size(), k.numel() * k.element_size(), lse.numel() * 4

    def rows(fn):  # the plain version, one batch row at a time
        return lambda: [fn(i) for i in range(b)]

    def plain_args(i):
        r = slice(i, i + 1)
        return V(q[r]), V(k[r]), V(v[r]), V(out[r]), lse[r], V(g[r])

    runs = {
        # reads q, k, v; writes out, lse
        "bshd_fwd": ((fwd_flops, 2 * qb + 2 * kvb + sb),
                     lambda: A.flash_forward_bshd(q, k, v, True),
                     rows(lambda i: A.flash_forward_reference(*plain_args(i)[:3], True)),
                     lib[0], None),
        # reads q, k, v, out, dO, lse; writes dq, dk, dv: five products
        "bshd_bwd": ((fwd_flops * 5 // 2, 4 * qb + 4 * kvb + sb),
                     lambda: A.flash_backward_bshd(q, k, v, out, lse, g, True),
                     rows(lambda i: A.flash_backward_reference(*plain_args(i), True)),
                     lib[1], lib[2]),
        # reads q, k, v, dO, lse, delta; writes dq: three products
        "bwd_dq": ((fwd_flops * 3 // 2, 3 * qb + 2 * kvb + 2 * sb),
                   lambda: A.flash_backward_dq_kernel(V(q), V(k), V(v), lse, V(g), delta, True),
                   rows(lambda i: A.flash_backward_dq_reference(*plain_args(i), True)),
                   lib[2], None),
        # reads q, k, v, out, dO, lse; writes dk, dv, delta: four products
        "bwd_dkv": ((fwd_flops * 2, 3 * qb + 4 * kvb + 2 * sb),
                    lambda: A.flash_backward_dkv_kernel(V(q), V(k), V(v), V(out), lse, V(g),
                                                        True),
                    rows(lambda i: A.flash_backward_dkv_reference(*plain_args(i), True)),
                    lib[2], None),
    }
    kernels = _time_kernels(runs, launches, errs, peak, bw,
                            dict(B=b, S=s, H=h, KV=kv, D=d, dtype="bf16", causal=True,
                                 layout="BSHD"), notes)
    del q, k, v, g, out, lse, delta, kx, vx, lib
    torch.cuda.empty_cache()

    # One layer's backward on the long path through each route.
    gen = torch.Generator(device="cuda").manual_seed(31)
    qkv = torch.randn(b, s, (h + 2 * kv) * d, device="cuda", generator=gen).to(torch.bfloat16)
    go = torch.randn(b, s, h * d, device="cuda", generator=gen).to(torch.bfloat16)
    cos, sin = rope_tables(d, s, LONG["rope_theta"], device="cuda")
    out, lse = A.flash_forward_qkv_kernel(qkv, h, kv, True, None, cos, sin, None)
    heads = A._packed_heads(qkv, h, kv, d)

    def route(name):
        def run():
            with backward_route(name):
                dqkv = torch.empty_like(qkv)
                A._backward_by_route("flash_bwd", "bshd_bwd", *heads, A._heads(out, d),
                                     A._heads(go, d), lse, *A._packed_heads(dqkv, h, kv, d),
                                     True, None, 0, None, cos, sin)
        return run

    shape = dict(B=b, S=s, H=h, KV=kv, D=d, dtype="bf16")
    for name in ROUTES:
        emit(phase="timing_routes", route=name, ms=cuda_ms(route(name), 5),
             bound_ms=fwd_flops * 5 // 2 / peak * 1e3, shape=dict(shape, rope=True))
    # What rope costs K1 on this path: the same call without it.
    for tables in ((cos, sin), (None, None)):
        ms = cuda_ms(lambda t=tables: A.flash_forward_qkv_kernel(qkv, h, kv, True, None, *t,
                                                                 None), 10)
        emit(phase="timing_rope", kernel="flash_fwd", rope=tables[0] is not None, ms=ms,
             bound_ms=fwd_flops / peak * 1e3, shape=shape)
    # K1 with rope, the long path's forward, as a row of its own: reads qkv
    # and the tables, writes out and lse. The library's call is SDPA's
    # forward on q and k rotated beforehand (kv heads repeated).
    del go, out, lse
    q_rot = A._rotate(heads[0], cos, sin, 0)
    kx, vx = (t.repeat_interleave(h // kv, dim=1)
              for t in (A.rotate_k_reference(heads[1], cos, sin), heads[2]))
    lib = _sdpa(q_rot, kx, vx, None)
    nbytes = (qkv.numel() + b * s * h * d) * qkv.element_size() + b * h * s * 4 \
        + 2 * cos.numel() * 4
    runs = {"flash_fwd_rope": (
        (fwd_flops, nbytes),
        lambda: A.flash_forward_qkv_kernel(qkv, h, kv, True, None, cos, sin, None),
        lambda: [A.flash_forward_qkv_reference(qkv[i:i + 1], h, kv, True, None, cos, sin)
                 for i in range(b)],
        lib[0], None)}
    kernels += _time_kernels(runs, launches, errs, peak, bw,
                             dict(shape, causal=True, rope=True, layout="packed qkv"), notes)
    return kernels


def _device_ms(fn, n=20):
    """One call of ``fn`` as torch.profiler sees it over ``n`` calls: the
    summed device time of its kernels (memsets and copies included) per
    call, in ms, and each kernel's device ms per call, by name. Unlike
    cuda_ms's events, which time the calls back to back, this leaves out the
    host's dispatch between them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        fail("profiler: no device events")
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    return (sum(by_name.values()) / 1e3 / n,
            {name: by_name[name] / 1e3 / n for name in sorted(by_name)})


def _profile_row(name, run, notes, n=20):
    """A call of timing row ``name`` by the profiler (:func:`_device_ms`):
    its device ms and each kernel's (the main kernel and its passes), into
    its notes."""
    ms, kernels = _device_ms(run, n)
    emit(phase="timing_device", kernel=name, profiler_device_ms=ms, kernels=kernels)
    notes.setdefault(name, {}).update(profiler_device_ms=ms, profiler_kernels=kernels)


def d32_device_times(notes):
    """K1 and K2 at head_dim 32 (the CLI's call: batch 8, seq 128, 4 heads,
    the timing rows' inputs): each call's device time by the profiler beside
    the rows' back-to-back reading, which at this size is mostly the
    wrapper's host dispatch."""
    b, s, h, d = 8, 128, 4, 32
    qkv, g = _packed(b, s, h, h, d, torch.bfloat16, seed=84)
    args = (h, h, True, None, None, None)
    out, lse = A.flash_forward_qkv_kernel(qkv, *args, None)
    for name, fn in (("flash_fwd_d32", lambda: A.flash_forward_qkv_kernel(qkv, *args, None)),
                     ("flash_bwd_d32", lambda: A.flash_backward_qkv_kernel(qkv, out, lse, g,
                                                                           *args, None))):
        _profile_row(name, fn, notes)


DISPATCH_CALLS = 1000


def _host_ns(fn, n=DISPATCH_CALLS):
    """Host nanoseconds a call of ``fn`` takes, over ``n`` calls back to back
    (``time.perf_counter_ns``); the card is drained before and after, and
    what the calls enqueue runs beside the loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    ns = (time.perf_counter_ns() - t0) / n
    torch.cuda.synchronize()
    return ns


def _dispatch_pieces(b, s, h, d):
    """The host pieces of one K1 and one K2 call at head_dim ``d`` (packed
    bf16 qkv, causal, no rope) as the wrappers make them, each timed alone
    by :func:`_host_ns`: the plan (source pick, key, cached lookup and the
    per-call layout check, ``_packed_plan``), the allocations, the pointers
    (qkv's base plus the plan's offsets), the bound function's lookup, the
    current card's check and raw stream, and the ctypes call, which
    launches the real kernel. Returns {"K1": ..., "K2": ...} in ns per
    call, with their sum."""
    bf = torch.bfloat16
    qkv, g = _packed(b, s, h, h, d, bf, seed=84)
    out, lse = A.flash_forward_qkv_kernel(qkv, h, h, True, None, None, None, None)
    dqkv = A.flash_backward_qkv_kernel(qkv, out, lse, g, h, h, True, None, None, None, None)
    torch.cuda.synchronize()
    dev = qkv.get_device()
    q0, d0 = qkv.data_ptr(), dqkv.data_ptr()
    dq_acc = torch.empty(b, h, s, d, dtype=torch.float32, device=dev)
    delta = torch.empty(b, h, s, dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    result = {}
    for kernel in ("K1", "K2"):
        if kernel == "K1":
            others = ()
            allocs = lambda: (torch.empty(b, s, h * d, dtype=bf, device=dev),
                              torch.empty(b, h, s, dtype=torch.float32, device=dev))
        else:
            others = (out, lse, g)
            allocs = lambda: (torch.empty(qkv.shape, dtype=bf, device=dev),
                              torch.empty(b, h, s, d, dtype=torch.float32, device=dev),
                              torch.empty(b, h, s, dtype=torch.float32, device=dev))
        direction = "fwd" if kernel == "K1" else "bwd"
        plan = A._packed_plan(direction, qkv, h, h, True, None, None, None, None, *others)
        offsets, fn = plan.offsets, A._kernel_fn(plan.source)
        if kernel == "K1":
            ptrs = lambda: (q0 + offsets[0], q0 + offsets[1], q0 + offsets[2], out.data_ptr(),
                            lse.data_ptr(), None, None)
        else:
            ptrs = lambda: (q0 + offsets[0], q0 + offsets[1], q0 + offsets[2], out.data_ptr(),
                            g.data_ptr(), lse.data_ptr(), None, None, d0 + offsets[0],
                            d0 + offsets[1], d0 + offsets[2], dq_acc.data_ptr(),
                            delta.data_ptr())
        pieces = {
            "plan": lambda: A._packed_plan(direction, qkv, h, h, True, None, None, None, None,
                                           *others),
            "allocations": allocs,
            "pointers": ptrs,
            "function_lookup": lambda: A._kernel_fn(plan.source),
            "device_check_and_stream": lambda: (dev == torch.cuda.current_device(),
                                                torch._C._cuda_getCurrentRawStream(dev)),
            "ctypes_call": lambda: fn(*ptrs(), *plan.args, stream),
        }
        ns = {name: _host_ns(piece) for name, piece in pieces.items()}
        ns["sum"] = sum(ns.values())
        result[kernel] = ns
    return result


def phase_host_dispatch(notes):
    """The wrappers' host dispatch at the CLI's call (K1/K2 at head_dim 32,
    B 8, S 128, 4 heads, bf16): each piece of a call
    (:func:`_dispatch_pieces`) beside one whole call's host time, and its
    back-to-back time on the card in turns with SDPA's on the same inputs;
    and K1 at head_dim 320 (padded in the launch) back to back. The readings
    go into the D 32 rows' notes as fields of their own; the rows' ``ms``
    and ``library_ms`` stay :func:`_time_kernels`' readings."""
    pieces = _dispatch_pieces(8, 128, 4, 32)
    whole = dispatch_times()
    for kernel, row in (("K1", "flash_fwd_d32"), ("K2", "flash_bwd_d32")):
        emit(phase="host_dispatch", kernel=kernel, ns_per_piece=pieces[kernel], **whole[row])
        notes.setdefault(row, {}).update(
            host_ns_per_piece=pieces[kernel], whole_call_host_ns=whole[row]["host_ns"],
            ms_turns_median=whole[row]["ms"],
            turns_how=f"median of {2 * DISPATCH_ROUNDS} readings of 200 calls back to back, "
                      "in turns with SDPA's call")
    notes["flash_fwd_d32"]["library_ms_turns_median"] = whole["flash_fwd_d32"]["sdpa_ms"]
    notes["flash_bwd_d32"]["library_bwd_only_ms_turns_median"] = \
        whole["flash_bwd_d32"]["sdpa_ms"]
    emit(phase="host_dispatch", kernel="K1 D 320", back_to_back_ms=whole["flash_fwd_d320"]["ms"])


DISPATCH_ROUNDS = 5


def _in_turns(fn, other, iters=200):
    """``fn`` and ``other`` back to back on the card (ms a call, CUDA events
    over ``iters`` calls) in DISPATCH_ROUNDS rounds of turns (fn, other,
    other, fn): the median of each, as the card's host is shared and its
    readings spread."""
    import statistics

    mine, theirs = [], []
    for _ in range(DISPATCH_ROUNDS):
        mine.append(cuda_ms(fn, iters))
        theirs += [cuda_ms(other, iters), cuda_ms(other, iters)]
        mine.append(cuda_ms(fn, iters))
    return statistics.median(mine), statistics.median(theirs)


def dispatch_times():
    """Whole calls through the public wrappers only (so that another
    checkout's package can be timed the same way, ``--dispatch --tree``):
    K1 and K2 at the CLI's call (head_dim 32, B 8, S 128, 4 heads, packed
    bf16 qkv, causal) — host ns a call over DISPATCH_CALLS calls; ms a call
    back to back on the card in turns with SDPA's forward (K1) and backward
    alone (K2) on the same inputs (:func:`_in_turns`), and one reading of
    10 calls of each as :func:`_time_kernels` takes a row's (``ms_10``,
    ``sdpa_ms_10``) — and K1 at head_dim 320 (B 2, S 2048, 4 heads) back to
    back."""
    b, s, h, d = 8, 128, 4, 32
    qkv, g = _packed(b, s, h, h, d, torch.bfloat16, seed=84)
    args = (h, h, True, None, None, None)
    out, lse = A.flash_forward_qkv_kernel(qkv, *args, None)
    fwd = lambda: A.flash_forward_qkv_kernel(qkv, *args, None)
    bwd = lambda: A.flash_backward_qkv_kernel(qkv, out, lse, g, *args, None)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in qkv.split(h * d, dim=-1))
    lib = _sdpa(q, k, v, g.reshape(b, s, h, d).transpose(1, 2))
    times = {}
    for row, fn, other in (("flash_fwd_d32", fwd, lib[0]), ("flash_bwd_d32", bwd, lib[2])):
        ms, sdpa_ms = _in_turns(fn, other)
        times[row] = dict(host_ns=_host_ns(fn), ms=ms, sdpa_ms=sdpa_ms,
                          ms_10=cuda_ms(fn, 10), sdpa_ms_10=cuda_ms(other, 10))
    qkv320, _ = _packed(2, 2048, 4, 4, 320, torch.bfloat16, seed=118)
    times["flash_fwd_d320"] = dict(ms=cuda_ms(
        lambda: A.flash_forward_qkv_kernel(qkv320, 4, 4, True, None, None, None, None), 20))
    return times


def dispatch_main(tree):
    """``chip_smoke.py --dispatch [--tree DIR]``: the package's host dispatch
    by whole calls (:func:`dispatch_times`) and the trainer at its own
    defaults (head_dim 32) for 400 steps, its steps/s over the windows of
    100 steps after the first; with ``--tree`` the package of checkout DIR
    (e.g. the parent commit's), so that two trees are compared on one card
    in one call."""
    from distributed_tensorflow_tpu_torch.cli import train_lm

    smi = nvidia_smi()
    times = dispatch_times()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_lm.main(["--attention", "flash", "--device", "cuda", "--training_steps", "400",
                       "--eval_step_interval", "100"])
    records = [json.loads(line) for line in buf.getvalue().splitlines()]
    emit(phase="dispatch", tree=tree or ".", card=smi, times=times,
         cli_defaults_d32_steps_per_sec=[r.get("steps_per_sec") for r in records],
         losses=[r["loss"] for r in records])


def phase_timing_dstream(launches, errs, notes):
    """The kernels above head_dim 256 at head_dim 512 — K1 (on
    flash_fwd_cols_sm90.cu, against flash_fwd_dstream.cu in turns) and K2
    (packed qkv, B 2, S 2048, 4 heads of 512, bf16, causal: phase 3's
    ds_packed_d512_call inputs), K5 and K6 on the same call's head views —
    K5 on flash_bwd_dq_cols_sm90.cu and K6 on flash_bwd_cols_sm90.cu
    against the column-group kernels in turns, and both again at head_dim
    384; K8 at head_dim 320 (padded to 384) on the last of its two q segments
    (1024 rows against 2048 keys), K1 at head_dim 320 (time_k1_d320); then
    K5 at head_dim 256 (Gemma 7B's width, on flash_bwd_dq_sm90.cu, against
    flash_bwd_dq.cu in turns). Each beside its plain version, its bound (the
    work the function needs, at the real head dim, not the recompute of the
    column groups) and SDPA, whose kernels' names are recorded (no flash
    backend above 256). K5's and K6's outputs at this call (phase 3 holds
    them at the d512 path's B 12) and K8's are held against their plain
    versions here."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from distributed_tensorflow_tpu_torch.utils.flops import chip_hbm_bandwidth, chip_peak_flops

    peak, bw = chip_peak_flops(), chip_hbm_bandwidth()
    bf = torch.bfloat16
    b, s, h, d = 2, 2048, 4, 512
    qkv, g = _packed(b, s, h, h, d, bf, seed=101)
    q, k, v = A._packed_heads(qkv, h, h, d)
    go = A._heads(g, d)
    lib = _sdpa(q, k, v, go)
    for name, fn in (("flash_fwd_d512", lib[0]), ("flash_bwd_d512", lib[1])):
        notes.setdefault(name, {})["library_kernels"] = _device_ms(fn, 3)[1]
    del lib
    # K1 on flash_fwd_cols_sm90.cu against flash_fwd_dstream.cu, in turns.
    _turns("flash_fwd_d512", lambda: A.flash_forward_qkv_kernel(qkv, h, h, True, None, None, None,
                                                                None), notes)
    kernels = _time_packed_pair(("flash_fwd_d512", "flash_bwd_d512"), b, s, h, d, 101, launches,
                                errs, peak, bw, notes)
    del qkv, g, q, k, v, go
    _, (q, k, v, o4, lse, go, delta) = compare_two_pass("ds_packed_d512_call two-pass", b, s, h,
                                                        d, seed=101)
    lib = _sdpa(q, k, v, go)
    bwd_kernels = _device_ms(lib[2], 3)[1]
    for name in ("bwd_dq_d512", "bwd_dkv_d512"):
        notes.setdefault(name, {}).update(library_call="SDPA backward alone (all three gradients)",
                                          library_kernels=bwd_kernels)
    fwd_flops = 4 * b * h * d * (s * (s + 1) // 2)
    qb, sb = q.numel() * q.element_size(), lse.numel() * 4  # one of q, k, v, dO, out
    runs = {
        # reads q, k, v, dO, lse, delta; writes dq: three products
        "bwd_dq_d512": ((fwd_flops * 3 // 2, 5 * qb + 2 * sb),
                        lambda: A.flash_backward_dq_kernel(q, k, v, lse, go, delta, True),
                        lambda: A.flash_backward_dq_reference(q, k, v, o4, lse, go, True),
                        lib[2], None),
        # reads q, k, v, out, dO, lse; writes dk, dv, delta: four products
        "bwd_dkv_d512": ((fwd_flops * 2, 7 * qb + 2 * sb),
                         lambda: A.flash_backward_dkv_kernel(q, k, v, o4, lse, go, True),
                         lambda: A.flash_backward_dkv_reference(q, k, v, o4, lse, go, True),
                         lib[2], None),
    }
    shape = dict(B=b, S=s, H=h, KV=h, D=d, dtype="bf16", causal=True,
                 layout="packed qkv head views")
    # K6 on flash_bwd_cols_sm90.cu against flash_bwd_dstream.cu and K5 on
    # flash_bwd_dq_cols_sm90.cu against flash_bwd_dq_dstream.cu, in turns.
    _turns("bwd_dkv_d512", runs["bwd_dkv_d512"][1], notes)
    _turns("bwd_dq_d512", runs["bwd_dq_d512"][1], notes)
    _profile_row("bwd_dq_d512", runs["bwd_dq_d512"][1], notes)
    kernels += _time_kernels(runs, launches, errs, peak, bw, shape, notes)
    del q, k, v, go, lse, o4, delta, lib
    torch.cuda.empty_cache()
    # K6 and K5 at head_dim 384, the same call otherwise: held against their
    # plain versions, then timed in turns and beside their bounds and SDPA's
    # backward.
    d = 384
    errs384, (q, k, v, o4, lse, go, delta) = compare_two_pass("ds_packed_d384_call two-pass", b,
                                                              s, h, d, seed=117)
    errs["bwd_dkv_d384"], errs["bwd_dq_d384"] = errs384["dkv"], errs384["dq"]
    lib = _sdpa(q, k, v, go)
    bwd_kernels = _device_ms(lib[2], 3)[1]
    for name in ("bwd_dq_d384", "bwd_dkv_d384"):
        notes.setdefault(name, {}).update(library_call="SDPA backward alone (all three gradients)",
                                          library_kernels=bwd_kernels)
    fwd_flops = 4 * b * h * d * (s * (s + 1) // 2)
    qb = q.numel() * q.element_size()
    runs = {"bwd_dq_d384": ((fwd_flops * 3 // 2, 5 * qb + 2 * sb),
                            lambda: A.flash_backward_dq_kernel(q, k, v, lse, go, delta, True),
                            lambda: A.flash_backward_dq_reference(q, k, v, o4, lse, go, True),
                            lib[2], None),
            "bwd_dkv_d384": ((fwd_flops * 2, 7 * qb + 2 * sb),
                             lambda: A.flash_backward_dkv_kernel(q, k, v, o4, lse, go, True),
                             lambda: A.flash_backward_dkv_reference(q, k, v, o4, lse, go, True),
                             lib[2], None)}
    for name in runs:
        _turns(name, runs[name][1], notes)
    _profile_row("bwd_dq_d384", runs["bwd_dq_d384"][1], notes)
    kernels += _time_kernels(runs, launches, errs, peak, bw, dict(shape, D=d), notes)
    del q, k, v, go, lse, o4, delta, lib
    torch.cuda.empty_cache()

    # K8 at head_dim 320 (padded to 384 in the launch) on its last q segment.
    d = 320
    seg = A._segment_rows(s, d)
    a = s - seg
    qkv, g = _packed(b, s, h, h, d, bf, seed=102)
    q, k, v = A._packed_heads(qkv, h, h, d)
    out, lse = A.flash_forward_qkv_kernel(qkv, h, h, True, None, None, None, None)
    rows = slice(a, s)
    q_seg, out_seg, g_seg = q[:, :, rows], A._heads(out, d)[:, :, rows], A._heads(g, d)[:, :, rows]
    lse_seg = lse[:, :, rows].contiguous()
    dq_seg = torch.empty(b, h, seg, d, dtype=bf, device="cuda")
    dk_s, dv_s = (torch.empty(b, h, s, d, dtype=bf, device="cuda") for _ in range(2))

    def segment():
        A._launch_backward("bshd_bwd", q_seg, k, v, out_seg, g_seg, lse_seg, dq_seg, dk_s, dv_s,
                           True, None, a, None)

    before = A.SOURCE_LAUNCHES["flash_bwd_dstream"]
    segment()
    torch.cuda.synchronize()
    if A.SOURCE_LAUNCHES["flash_bwd_dstream"] != before + 1:
        fail("timing: K8 at head_dim 320 did not run flash_bwd_dstream.cu")
    plain = lambda: A.flash_backward_reference(q_seg, k, v, out_seg, lse_seg, g_seg, True, None,
                                               None, a)
    case = "ds_packed_d320_last_segment"
    errs["bshd_bwd_d320"] = max(_check(case, n, bf, t, r, "dqkv")
                                for n, t, r in zip(("dq", "dk", "dv"), (dq_seg, dk_s, dv_s),
                                                   plain()))
    mask = causal_lower_right(seg, s)
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q_seg, k, v))

    def lib_fwd_bwd():
        F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask).backward(g_seg)

    o_lib = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)

    def lib_bwd():
        torch.autograd.grad(o_lib, (ql, kl, vl), g_seg, retain_graph=True)

    notes.setdefault("bshd_bwd_d320", {}).update(
        call="the last of the two q segments at head_dim 320 (padded to 384 in the launch)",
        library_call="SDPA forward+backward, lower-right causal",
        library_kernels=_device_ms(lib_fwd_bwd, 3)[1])
    seg_pairs = seg * a + seg * (seg + 1) // 2
    elt = qkv.element_size()
    seg_bytes, head_bytes = b * h * seg * d * elt, b * h * s * d * elt
    runs = {"bshd_bwd_d320": (
        # reads q, out, dO (the segment's rows), k, v, lse; writes dq (the
        # segment's rows) and the segment's dk, dv shares
        (4 * b * h * d * seg_pairs * 5 // 2, 4 * seg_bytes + 4 * head_bytes + b * h * seg * 4),
        segment, plain, lib_fwd_bwd, lib_bwd)}
    kernels += _time_kernels(runs, launches, errs, peak, bw,
                             dict(B=b, Sq=seg, Skv=s, q_pos_offset=a, H=h, KV=h, D=d,
                                  dtype="bf16", causal=True, layout="packed qkv head views"),
                             notes)
    del qkv, g, q, k, v, out, lse, q_seg, out_seg, g_seg, dq_seg, dk_s, dv_s, ql, kl, vl, o_lib
    torch.cuda.empty_cache()

    kernels += time_k1_d320(b, s, h, launches, errs, peak, bw, notes)

    # K5 at head_dim 256 (Gemma 7B's width, packed head views) on
    # flash_bwd_dq_sm90.cu, against flash_bwd_dq.cu in turns.
    b, s, h, d = (GEMMA[key] for key in ("batch_size", "seq_len", "num_heads", "head_dim"))
    qkv, g = _packed(b, s, h, h, d, bf, seed=64)
    q, k, v = A._packed_heads(qkv, h, h, d)
    go = A._heads(g, d)
    out, lse = A.flash_forward_qkv_kernel(qkv, h, h, True, None, None, None, None)
    o4 = A._heads(out, d)
    _, _, delta = A.flash_backward_dkv_kernel(q, k, v, o4, lse, go, True)
    before = A.SOURCE_LAUNCHES["flash_bwd_dq_sm90"]
    dq5 = A.flash_backward_dq_kernel(q, k, v, lse, go, delta, True)
    torch.cuda.synchronize()
    if A.SOURCE_LAUNCHES["flash_bwd_dq_sm90"] != before + 1:
        fail("timing: K5 at head_dim 256 did not run flash_bwd_dq_sm90.cu")
    errs["bwd_dq_d256"] = _check("packed_d256_gemma_width two-pass", "k5_dq", bf, dq5,
                                 A.flash_backward_dq_reference(q, k, v, o4, lse, go, True),
                                 "dqkv")
    del dq5
    lib = _sdpa(q, k, v, go)
    notes.setdefault("bwd_dq_d256", {}).update(
        library_call="SDPA backward alone (all three gradients)",
        library_kernels=_device_ms(lib[2], 3)[1])
    fwd_flops = 4 * b * h * d * (s * (s + 1) // 2)
    qb, sb = q.numel() * qkv.element_size(), lse.numel() * 4
    run5 = lambda: A.flash_backward_dq_kernel(q, k, v, lse, go, delta, True)
    _turns("bwd_dq_d256", run5, notes)
    runs = {"bwd_dq_d256": (
        (fwd_flops * 3 // 2, 5 * qb + 2 * sb), run5,
        lambda: A.flash_backward_dq_reference(q, k, v, o4, lse, go, True),
        lib[2], None)}
    kernels += _time_kernels(runs, launches, errs, peak, bw,
                             dict(B=b, S=s, H=h, KV=h, D=d, dtype="bf16", causal=True,
                                  layout="packed qkv head views"), notes)
    del qkv, g, q, k, v, go, out, lse, o4, delta, lib
    torch.cuda.empty_cache()
    return kernels


def time_k1_d320(b, s, h, launches, errs, peak, bw, notes):
    """K1 at head_dim 320 (padded to 384 in the launch, on
    flash_fwd_cols_sm90.cu; B ``b``, S ``s``, ``h`` heads, packed bf16 qkv,
    causal): held against its plain version, timed in turns against
    flash_fwd_dstream.cu, its device time by the profiler, and beside its
    bound (at the real 320) and SDPA's forward (its kernels' names
    recorded)."""
    bf, d = torch.bfloat16, 320
    qkv, _ = _packed(b, s, h, h, d, bf, seed=118)
    args = (h, h, True, None, None, None)
    run = lambda: A.flash_forward_qkv_kernel(qkv, *args, None)
    before = A.SOURCE_LAUNCHES["flash_fwd_cols_sm90"]
    out, lse = run()
    torch.cuda.synchronize()
    if A.SOURCE_LAUNCHES["flash_fwd_cols_sm90"] != before + 1:
        fail("timing: K1 at head_dim 320 did not run flash_fwd_cols_sm90.cu")
    ref_out, ref_lse = A.flash_forward_qkv_reference(qkv, *args)
    case = "ds_packed_d320_call"
    errs["flash_fwd_d320"] = _check(case, "out", bf, A._heads(out, d), A._heads(ref_out, d),
                                    "out")
    _check(case, "lse", bf, lse, ref_lse, "lse")
    del ref_out, ref_lse
    lib = _sdpa(*A._packed_heads(qkv, h, h, d), None)
    # The call's device time by the profiler beside the back-to-back reading,
    # which the wrapper's pad and copy-back dispatch can hold up on the host.
    device_ms, device_kernels = _device_ms(run)
    notes.setdefault("flash_fwd_d320", {}).update(
        call="K1 at head_dim 320, padded to 384 in the launch (pad and copy back included)",
        library_kernels=_device_ms(lib[0], 3)[1], profiler_device_ms=device_ms,
        profiler_kernels=device_kernels)
    emit(phase="timing_device", kernel="flash_fwd_d320", profiler_device_ms=device_ms,
         kernels=device_kernels)
    _turns("flash_fwd_d320", run, notes)
    elt = qkv.element_size()
    runs = {"flash_fwd_d320": (
        # reads qkv, writes out and lse
        (4 * b * h * d * (s * (s + 1) // 2),
         qkv.numel() * elt + out.numel() * elt + lse.numel() * 4),
        run, lambda: A.flash_forward_qkv_reference(qkv, *args), lib[0], None)}
    kernels = _time_kernels(runs, launches, errs, peak, bw,
                            dict(B=b, S=s, H=h, KV=h, D=d, dtype="bf16", causal=True,
                                 layout="packed qkv"), notes)
    del qkv, out, lse, lib
    torch.cuda.empty_cache()
    return kernels


def compare_pipe(case, b, h, sq, skv, d, dtype, causal=True, seed=0, controls=False,
                 vs_k3=False):
    """K9 against its plain version on the same (B, H, S, D) inputs, one
    launch on the source attention.pipe_forward_kernel names for the call's
    instance: out by the max-based and blockwise limits, lse by its absolute
    limit, and rows that attend nothing exactly 0. With ``controls`` the
    last attended 64-key tile of the last q tile (the diagonal one, which
    the kernel's flush step multiplies) is dropped from out as a planted
    fault that must be caught. With ``vs_k3`` out is held within PARITY_TOL
    of K3's on the same inputs, and whether the two agree bit for bit is
    recorded. Returns out's max abs error."""
    from distributed_tensorflow_tpu_torch.tools import pipeline_probe as pp

    q, k, v, _ = _bhsd(b, h, sq, skv, d, dtype, seed)
    source = A.pipe_forward_kernel(dtype, A._pipe_instance_dim(d))
    before = A.SOURCE_LAUNCHES[source]
    out, lse = pp.pipe_flash_forward_kernel(q, k, v, causal)
    torch.cuda.synchronize()
    if A.SOURCE_LAUNCHES[source] != before + 1:
        fail(f"{case}: K9 did not run {source}.cu")
    ref_out, ref_lse = A.flash_forward_reference(q, k, v, causal)
    if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
        fail(f"{case}: non-finite out or lse")
    dead = _masked_rows(case, lse, ref_lse, out)
    err = _check(case, "out", dtype, out, ref_out, "out")
    _check(case, "lse", dtype, lse[~dead], ref_lse[~dead], "lse")
    if controls:
        fault_controls(case, q, k, v, None, out, lse, None, ref_out, None,
                       products=("out: P.V",), keys=slice(sq - BLOCK_ROWS, sq))
    if vs_k3:
        out3 = A.flash_forward_kernel(q, k, v, causal)[0]
        torch.cuda.synchronize()
        diff = (out.float() - out3.float()).abs().max().item()
        emit(phase="kernels", case=case, k9_source=source,
             k3_source=A.forward_kernel(dtype, A._instance_dim(d)),
             bitwise_equal_k3=bool(torch.equal(out, out3)), max_abs_diff_k3=diff,
             tol=pp.PARITY_TOL)
        if not diff < pp.PARITY_TOL:
            fail(f"{case}: K9 and K3 differ by {diff}")
    return err


def phase_pipe_head_dims():
    """K9 at the head dims it used to refuse, in bf16 and f32: 80 (padded to
    128), 256 (an instance: two warpgroups and 32-key tiles in bf16, two
    blocks a tile in f32) and 320 (above 256, where the call runs the
    shipped forward at its instance 384), each against its plain version and
    against K3 on the same inputs (bit for bit or not, recorded); at 256
    also with rows that attend nothing, non-causal, and a dropped kv tile in
    the flush step."""
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        for i, d in enumerate((80, 256, 320)):
            compare_pipe(f"k9_d{d}_{tag}", 2, 4, 200, 200, d, dtype, seed=112 + i, vs_k3=True)
        compare_pipe(f"k9_d256_fully_masked_rows_{tag}", 2, 4, 200, 72, 256, dtype, seed=115)
        compare_pipe(f"k9_d256_noncausal_{tag}", 1, 4, 136, 200, 256, dtype, causal=False,
                     seed=116)
    compare_pipe("k9_d256_controls", 1, 4, 1024, 1024, 256, torch.bfloat16, seed=117,
                 controls=True, vs_k3=True)
    torch.cuda.empty_cache()


def _probe_entry(module, counter):
    """``python -m distributed_tensorflow_tpu_torch.tools.<module>``: exit 0,
    its JSON records, and its last record's launches of ``counter`` > 0
    (a fresh process counts from 0). Returns that count."""
    res = subprocess.run(
        [sys.executable, "-m", f"distributed_tensorflow_tpu_torch.tools.{module}"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    if res.returncode != 0:
        fail(f"probes: {module} exited {res.returncode}: {res.stderr[-2000:]}")
    records = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    for r in records:
        emit(phase="probes", entry=module, **r)
    launches = records[-1].get("launches", {}) if records else {}
    if launches.get(counter, 0) < 1:
        fail(f"probes: {module} launched no {counter} kernel ({launches})")
    return launches[counter]


def phase_probes():
    """K9 and K10, the two kernel probes: each against its plain version,
    K10 bit for bit against K3, each timed at its probe shape like phase 6
    (beside K3 on the same inputs), and each probe's main() run as a user
    runs it. No main path launches either kernel; a probe call launches
    one."""
    from distributed_tensorflow_tpu_torch.utils.flops import chip_hbm_bandwidth, chip_peak_flops

    peak, bw = chip_peak_flops(), chip_hbm_bandwidth()
    kernels = _probe_pipe(peak, bw) + _probe_bshd(peak, bw)
    entry = {"pipe_fwd": _probe_entry("pipeline_probe", "pipe_fwd"),
             "probe_bshd_fwd": _probe_entry("bshd_probe", "probe_bshd_fwd")}
    for rec in kernels:
        if rec["name"] in entry:  # the probes' entries run at their own shapes
            rec["launches_by_probe_entry"] = entry[rec["name"]]
    return kernels


# Timing rows of the probes: bound = max(2·b·h·s²·d over the peak, bytes of
# q, k, v read and out, lse written over the memory rate); library = SDPA's
# causal forward (Sq == Skv, so its top-left alignment agrees).
PROBE_NOTE = {"launches_note": "0 on every main path; one a call of the probe function"}


def _probe_pipe(peak, bw):
    """K9 against its plain version at the probe's shapes and cases, then,
    at each probe shape (row pipe_fwd) and at Gemma 7B's width (B 2, 16
    heads of 256, S 2048: row pipe_fwd_d256, the instance that raised
    before it was built), within PARITY_TOL of K3 on the same inputs (bit
    for bit or not), in turns against the kernel it replaced (at 64 and 128
    only: no old kernel took 256) and against K3 — the probe's verdict on
    which issue order wins — and timed like phase 6."""
    import torch.nn.functional as F

    from distributed_tensorflow_tpu_torch.tools import pipeline_probe as pp

    gm = GEMMA
    rows = [("pipe_fwd", tag, shape) for tag, shape in pp.SHAPES.items()]
    rows.append(("pipe_fwd_d256", "gemma_d256",
                 tuple(gm[key] for key in ("batch_size", "num_heads", "seq_len", "head_dim"))))
    errs = {}
    for _, tag, (b, h, s, d) in rows:
        errs[tag] = compare_pipe(f"k9_{tag}", b, h, s, s, d, torch.bfloat16, seed=50,
                                 controls=tag == "flagship_2k")
        torch.cuda.empty_cache()
    compare_pipe("k9_ragged_f32_d64", 2, 4, 200, 200, 64, torch.float32, seed=51)
    compare_pipe("k9_cross_72_200_d128", 2, 4, 72, 200, 128, torch.bfloat16, seed=52)
    compare_pipe("k9_fully_masked_rows_200_72_d64", 2, 4, 200, 72, 64, torch.float32, seed=53)
    compare_pipe("k9_noncausal_f32_d128", 1, 4, 136, 200, 128, torch.float32, causal=False,
                 seed=54)
    # The warpgroup K9 (bf16) at a ragged length, with fully masked rows and
    # non-causal.
    compare_pipe("k9_ragged_bf16_d64", 2, 4, 200, 200, 64, torch.bfloat16, seed=58)
    compare_pipe("k9_fully_masked_rows_200_72_bf16_d128", 2, 4, 200, 72, 128, torch.bfloat16,
                 seed=59)
    compare_pipe("k9_noncausal_bf16_d64", 1, 4, 136, 200, 64, torch.bfloat16, causal=False,
                 seed=56)
    kernels = []
    for name, tag, (b, h, s, d) in rows:
        q, k, v, _ = _bhsd(b, h, s, s, d, torch.bfloat16, seed=57)
        out3 = A.flash_forward_kernel(q, k, v, True)[0]
        before = A.SOURCE_LAUNCHES["flash_fwd_pipe_sm90"]
        out9 = pp.pipe_flash_forward_kernel(q, k, v, True)[0]
        torch.cuda.synchronize()
        if A.SOURCE_LAUNCHES["flash_fwd_pipe_sm90"] != before + 1:
            fail(f"probes: K9 at {tag} did not run flash_fwd_pipe_sm90.cu")
        bitwise = bool(torch.equal(out9, out3))
        diff = (out9.float() - out3.float()).abs().max().item()
        emit(phase="probes", case=f"k9_vs_k3_{tag}", bitwise_equal=bitwise, max_abs_diff=diff,
             tol=pp.PARITY_TOL)
        if not diff < pp.PARITY_TOL:
            fail(f"probes: K9 and K3 differ by {diff} at {tag}")
        del out3, out9
        nbytes = 4 * q.numel() * q.element_size() + b * h * s * 4
        run9 = lambda: pp.pipe_flash_forward_kernel(q, k, v, True)
        run3 = lambda: A.flash_forward_kernel(q, k, v, True)
        runs = {name: ((2 * b * h * s * s * d, nbytes), run9,
                       lambda: pp.pipe_flash_forward_reference(q, k, v, True),
                       lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), None)}
        notes = {name: dict(PROBE_NOTE, probe_shape=tag, bitwise_equal_k3=bitwise)}
        # The new K9 against the kernel it replaced, then the probe's question:
        # K9 (S_{n+1} issued before the softmax of S_n) against K3 (the
        # softmax of S_n under P_{n-1}·V_{n-1}) on the same inputs, in turns.
        if name == "pipe_fwd":
            _turns(name, run9, notes, phase="probes")
        else:
            notes[name]["was"] = "no kernel: K9 raised at head_dim 256"
        t = [cuda_ms(f, 10) for f in (run9, run3, run3, run9)]
        k9_ms, k3_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        ratio = k9_ms / k3_ms
        verdict = (f"the probe's order is {'faster' if ratio < 1 else 'slower'} than K3's by "
                   f"{abs(1 - ratio):.1%} at {tag}")
        emit(phase="probes", case=f"k9_vs_k3_turns_{tag}", order=["K9", "K3", "K3", "K9"], ms=t,
             k9_over_k3=ratio, verdict=verdict)
        notes[name].update(k3_same_inputs_ms=k3_ms, k9_vs_k3_turns_ms=t, k9_over_k3=ratio,
                           verdict=verdict)
        kernels += _time_kernels(runs, {name: 0}, {name: errs[tag]}, peak, bw,
                                 dict(B=b, H=h, S=s, D=d, dtype="bf16", causal=True), notes)
        del q, k, v
        torch.cuda.empty_cache()
    return kernels


def _probe_bshd(peak, bw):
    """K10 on (B, S, H·dh) operands at the probe's shape: equal bit for bit
    to K3 on a contiguous BHSD copy of the same values, within limits of
    its plain version there and at a small ragged f32 case, then timed."""
    import torch.nn.functional as F

    from distributed_tensorflow_tpu_torch.tools import bshd_probe as bp

    b, s, h, dh = bp.B, bp.S, bp.H, bp.DH
    gen = torch.Generator(device="cuda").manual_seed(55)
    x = (0.1 * torch.randn(b, s, h * dh, device="cuda", generator=gen)).to(torch.bfloat16)
    xh = A._heads(x, dh).contiguous()
    out10, lse10 = bp.bshd_forward(x, x, x, h)
    out3, lse3 = A.flash_forward_kernel(xh, xh, xh, True)
    torch.cuda.synchronize()
    same = {"out": torch.equal(A._heads(out10, dh), out3),
            "lse": torch.equal(lse10.reshape(b, h, s), lse3)}
    emit(phase="probes", case="k10_vs_k3", bitwise_equal=same)
    if not all(same.values()):
        fail(f"probes: K10 and K3 differ on the same values ({same})")
    ref_out, ref_lse = bp.bshd_forward_reference(x, x, x, h)
    err = _check("k10_probe_shape", "out", torch.bfloat16, A._heads(out10, dh),
                 A._heads(ref_out, dh), "out")
    _check("k10_probe_shape", "lse", torch.bfloat16, lse10, ref_lse, "lse")
    del out3, lse3, out10, lse10, ref_out, ref_lse
    xs = [torch.randn(2, 200, 4 * 64, device="cuda", generator=gen) for _ in range(3)]
    (got, got_lse), (want, want_lse) = bp.bshd_forward(*xs, 4), bp.bshd_forward_reference(*xs, 4)
    case = "k10_ragged_f32_d64"
    _check(case, "out", torch.float32, A._heads(got, 64), A._heads(want, 64), "out")
    _check(case, "lse", torch.float32, got_lse, want_lse, "lse")

    xv = A._heads(x, dh)
    runs = {"probe_bshd_fwd": ((2 * b * h * s * s * dh, 4 * x.numel() * x.element_size()
                                + b * h * s * 4),
                               lambda: bp.bshd_forward(x, x, x, h),
                               lambda: bp.bshd_forward_reference(x, x, x, h),
                               lambda: F.scaled_dot_product_attention(xv, xv, xv, is_causal=True),
                               None)}
    k3_ms = cuda_ms(lambda: A.flash_forward_kernel(xh, xh, xh, True), 10)
    notes = {"probe_bshd_fwd": dict(PROBE_NOTE, probe_shape="flagship_2k",
                                    k3_same_inputs_ms=k3_ms)}
    kernels = _time_kernels(runs, {"probe_bshd_fwd": 0}, {"probe_bshd_fwd": err}, peak, bw,
                            dict(B=b, S=s, H=h, D=dh, dtype="bf16", causal=True,
                                 layout="(B, S, H·dh)"), notes)
    del x, xh, xv
    torch.cuda.empty_cache()
    return kernels


def _time_kernels(runs, launches, errs, peak, bw, shape, notes=None):
    """Time each kernel, its plain version and the library's call; ``notes``
    adds fields to a kernel's record."""
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
            "ms": cuda_ms(kernel, 10),
            "plain_ms": cuda_ms(plain, 3, warmup=1),
            "bound_ms": max(t_flops, t_bytes),
            "bound_by": "operations" if t_flops >= t_bytes else "bytes",
            "library_ms": cuda_ms(library, 10),
            **(notes or {}).get(name, {}),
        }
        extra = {} if library_bwd is None else {"library_bwd_only_ms": cuda_ms(library_bwd, 10)}
        emit(phase="timing", shape=shape, flops=flops, bytes=nbytes, **rec, **extra)
        kernels.append(rec)
    return kernels


# Kernel-name substrings → class, checked in order (cuBLAS's Hopper GEMMs
# are named nvjet_*, sm90_xmma_* or *gemm*): K5's classes come before the
# fused backward's, whose substring its warpgroup kernel's name contains;
# no other kernel name of one class contains another class's substring.
# Each profiled step runs one path, so
# attn_fwd is K1 in the dp, long and wide steps (with its rotate pass,
# dtt::flash_fwd_rotate_k, on the long and wide paths) and K3 in the tp
# step, all on dtt::flash_fwd_sm90_kernel, and attn_bwd is K2, K4 and K8 (K8
# on four q segments on the long path, eight on wide) in them, on
# dtt::flash_bwd_sm90_kernel (wide: dtt::flash_bwd_sm90_cols_kernel). The
# d512 step runs attn_fwd as K1 on dtt::flash_fwd_cols_sm90_kernel (its
# prepare pass, dtt::dstream_prep_kernel, under other), attn_bwd_dq K5 on
# dtt::flash_bwd_dq_cols_sm90_kernel (its prepare pass under other, its dq
# rotate-back under attn_bwd) and attn_bwd K6 (and its delta pre-pass and
# dk rotate-back) on dtt::flash_bwd_cols_sm90_kernel.
KERNEL_CLASSES = (
    ("attn_fwd", ("dtt::flash_fwd",)),
    ("attn_bwd_dq", ("dtt::two_pass_dq", "dtt::flash_bwd_dq_sm90",
                     "dtt::flash_bwd_dq_dstream", "dtt::flash_bwd_dq_cols_sm90")),  # K5
    ("attn_bwd", ("dtt::flash_bwd",)),  # delta pre-pass, main kernel, dq pass
    ("matmul", ("nvjet", "gemm", "xmma", "cutlass")),
    ("layer_norm", ("layer_norm",)),
    ("optimizer", ("multi_tensor", "foreach", "adam")),
    ("cross_entropy", ("softmax", "nll_loss")),
)


def phase_profile(path):
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_tpu_torch.models.transformer import TransformerLM
    from distributed_tensorflow_tpu_torch.parallel.data_parallel import build_lm_train_step
    from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
        TpTransformerLM,
        build_tp_lm_train_step,
    )
    from distributed_tensorflow_tpu_torch.train.optimizers import make_optimizer

    shape = SHAPES[path]
    if path == "tp":
        model = TpTransformerLM(_cfg(), seed=0, device="cuda")
        build = build_tp_lm_train_step
    else:
        model = TransformerLM(_cfg(shape), seed=0, device="cuda")
        build = build_lm_train_step
    step = build(model, make_optimizer("adam", model.parameters(), 3e-3, 10))
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, 256, (shape["batch_size"], shape["seq_len"]), device="cuda",
                           generator=gen)
    for _ in range(2):
        step(tokens)
    torch.cuda.synchronize()
    # A step ends with the optimizer's kernels, and its device work lies
    # inside its wall time: a trace that breaks either lost or mixed in
    # events (seen once in the third profile of one process), and is taken
    # again.
    for attempt in range(3):
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
        span_ms = (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e3 if spans else 0.0
        if spans and by_class["optimizer"] > 0 and span_ms <= wall_ms:
            break
        emit(phase=f"profile_{path}", incomplete_trace=True, attempt=attempt, kernels=len(spans),
             device_span_ms=span_ms, step_wall_ms=wall_ms)
    else:
        fail(f"profile_{path}: every trace lacks the step's optimizer kernels")
    # Busy time is the union of the kernels' intervals (they may overlap).
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    first, last = min(s for s, _ in spans), max(e for _, e in spans)
    emit(phase=f"profile_{path}", step_wall_ms=wall_ms,
         device_span_ms=(last - first) / 1e3, device_busy_ms=busy_us / 1e3,
         idle_share=1.0 - busy_us / (last - first), kernels=len(spans),
         device_ms_by_class={k: round(v, 3) for k, v in by_class.items()})
    del model, step
    torch.cuda.empty_cache()


def _train_dir_argv(text):
    """phase_train_dir's trainer flags: the flagship on ``text``, flash
    attention, TRAIN_DIR_LR."""
    shape = FLAGSHIP
    return [
        "--d_model", str(shape["d_model"]), "--num_heads", str(shape["num_heads"]),
        "--num_layers", str(shape["num_layers"]), "--d_ff", str(shape["d_ff"]),
        "--seq_len", str(shape["seq_len"]), "--batch_size", str(shape["batch_size"]),
        "--use_bias", "0", "--attention", "flash", "--device", "cuda",
        "--text_file", text, "--eval_step_interval", "4", "--learning_rate", str(TRAIN_DIR_LR),
    ]


# phase_train_dir: the flagship (batch 12, seq 2048) trained byte-level on a
# file of the repo's own text, checkpointed (run A, 8 steps), resumed and
# exported (run B, to step 12), against an uninterrupted run (C).
TRAIN_DIR_STEPS, TRAIN_DIR_RESUMED = 8, 12
TRAIN_DIR_TOL = 1e-2  # B's step-12 loss against C's, relative (dq's atomics)
# The learning rate of every train_dir run. At the trainer's default (3e-3)
# the flagship's first steps diverge (losses 10-14 against ln 256 = 5.5), and
# two uninterrupted runs of one seed, which differ only in the order in which
# the backward kernels' atomics add into dq, can end a sizeable share of
# TRAIN_DIR_TOL apart. At 1e-4 the loss falls below ln 256 within six steps
# and such runs end some 1e-5 apart. ``chip_smoke.py --spread`` measures
# both; PERF.md §6 has readings.
TRAIN_DIR_LR = 1e-4
EVAL_TOL = 2e-2  # eval_lm's nll on the card (bf16) against the CPU's (f32), relative


def _repo_text(path):
    """The repo's Markdown and the port's Python sources, concatenated in
    name order, as one byte file at ``path``; returns its size."""
    root = os.path.dirname(os.path.abspath(__file__))
    files = sorted(f for f in os.listdir(root) if f.endswith(".md"))
    pkg = os.path.join(root, "distributed_tensorflow_tpu_torch")
    for d, _, names in sorted(os.walk(pkg)):
        files += sorted(os.path.relpath(os.path.join(d, n), root) for n in names
                        if n.endswith(".py"))
    with open(path, "wb") as out:
        for f in files:
            with open(os.path.join(root, f), "rb") as fh:
                out.write(fh.read())
    return os.path.getsize(path)


def _run_cli(module, argv):
    """``module.main(argv)`` with stdout captured: (return value, JSON
    records, other lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = module.main(argv)
    lines = buf.getvalue().splitlines()
    return (ret, [json.loads(x) for x in lines if x.startswith("{")],
            [x for x in lines if not x.startswith("{")])


def _manager_round_trip(smi, work, tokens):
    """A flagship model and its fused Adam, one step in, saved through
    CheckpointManager and restored into fresh objects: every parameter,
    every moment, ``step`` and the schedule's count bitwise equal. Then the
    restored model exported as a bundle. Returns the timings."""
    from distributed_tensorflow_tpu_torch.models.convert import transformer_params_to_jax
    from distributed_tensorflow_tpu_torch.models.transformer import TransformerLM
    from distributed_tensorflow_tpu_torch.parallel.data_parallel import build_lm_train_step
    from distributed_tensorflow_tpu_torch.train import checkpoint as ck
    from distributed_tensorflow_tpu_torch.train.optimizers import make_optimizer

    def build(seed):
        model = TransformerLM(_cfg(), seed=seed, device="cuda")
        return model, make_optimizer("adam", model.parameters(), 3e-3, total_steps=10)

    model, opt = build(0)
    build_lm_train_step(model, opt)(tokens)
    torch.cuda.synchronize()
    mngr = ck.CheckpointManager(os.path.join(work, "manager"), save_interval_secs=0)
    mngr.save(1, ck.train_state(model, opt, 1))
    fresh, fresh_opt = build(1)
    step, tree = mngr.restore_latest()
    t0 = time.perf_counter()
    global_step = ck.restore_train_state(step, tree, fresh, fresh_opt)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del tree
    if (step, global_step, fresh_opt.scheduler.last_epoch) != (1, 1, opt.scheduler.last_epoch):
        fail(f"train_dir: restored step {step}, global step {global_step}, schedule count "
             f"{fresh_opt.scheduler.last_epoch} (saved 1, 1, {opt.scheduler.last_epoch})")
    moments = 0
    for (name, p), q in zip(model.named_parameters(), fresh.parameters()):
        if not torch.equal(p, q):
            fail(f"train_dir: parameter {name} differs after the round trip")
        saved, got = opt.optimizer.state[p], fresh_opt.optimizer.state[q]
        if sorted(saved) != sorted(got) or not all(torch.equal(saved[k], got[k]) for k in saved):
            fail(f"train_dir: optimizer state of {name} differs after the round trip")
        moments += len(saved)
    if fresh_opt.optimizer.param_groups[0]["lr"] != opt.optimizer.param_groups[0]["lr"]:
        fail("train_dir: the restored learning rate differs")
    bundle = os.path.join(work, "manager.msgpack")
    t0 = time.perf_counter()
    bundle_bytes = ck.export_inference_bundle(bundle, transformer_params_to_jax(fresh))
    export_s = time.perf_counter() - t0
    out = dict(save_s=round(mngr.last_save_seconds, 3), save_bytes=mngr.last_save_bytes,
               restore_read_s=round(mngr.last_restore_seconds, 3), restore_load_s=round(load_s, 3),
               stall_s=round(mngr.stall_seconds, 3), export_s=round(export_s, 3),
               bundle_bytes=bundle_bytes, state_entries_checked=moments, card=smi)
    emit(phase="train_dir", check="manager_round_trip_bitwise", **out)
    del model, opt, fresh, fresh_opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_dir(smi):
    """Checkpoints, resume and export on the card, through the trainer's
    flags, at the flagship's full width with --text_file: run A trains 8
    steps with --train_dir (only the forced final save fires); run B, the
    same command to step 12 with --output, restores step 8 (the state
    restored equal to the step's tree bitwise) and launches
    exactly 4 steps x 8 layers of K1 and K2 on the warpgroup kernels, then
    commits step 12 and writes the bundle; run C trains 12 steps straight,
    its loss within TRAIN_DIR_TOL of B's. Then the manager's round trip
    (bitwise) with its save, restore and export timings, and
    cli/eval_lm.py on the bundle on the card and on the CPU (two holdout
    windows each, nll within EVAL_TOL). Removes what it wrote."""
    from distributed_tensorflow_tpu_torch.cli import eval_lm, train_lm
    from distributed_tensorflow_tpu_torch.train.checkpoint import list_committed_steps

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, ".scratch", "chip_smoke_train_dir")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        text, d, bundle = (os.path.join(work, n) for n in ("text.bin", "train", "lm.msgpack"))
        size = _repo_text(text)
        shape = FLAGSHIP
        argv = _train_dir_argv(text)
        ckpt = ["--train_dir", d, "--save_secs", "1000000"]
        _zero_counts()
        t0 = time.perf_counter()
        _, rec_a, _ = _run_cli(train_lm, [*argv, *ckpt, "--training_steps",
                                          str(TRAIN_DIR_STEPS)])
        wall_a = time.perf_counter() - t0
        if list_committed_steps(d) != [TRAIN_DIR_STEPS]:
            fail(f"train_dir: run A committed {list_committed_steps(d)}, expected "
                 f"[{TRAIN_DIR_STEPS}]")
        gc.collect()
        torch.cuda.empty_cache()

        _zero_counts()
        t0 = time.perf_counter()
        with _managers() as (_, _, checked):
            loss_b, rec_b, lines_b = _run_cli(train_lm, [
                *argv, *ckpt, "--training_steps", str(TRAIN_DIR_RESUMED), "--output", bundle])
        wall_b = time.perf_counter() - t0
        if len(checked) != 1 or checked[0][1]:
            fail(f"train_dir: the state restored from step {TRAIN_DIR_STEPS} differs from the "
                 f"step's tree in {checked}")
        launches, sources = dict(A.KERNEL_LAUNCHES), dict(A.SOURCE_LAUNCHES)
        n = (TRAIN_DIR_RESUMED - TRAIN_DIR_STEPS) * shape["num_layers"]
        want = {k: n if k in ("flash_fwd", "flash_bwd") else 0 for k in A.KERNEL_LAUNCHES}
        want_sources = expected_sources(want)
        emit(phase="train_dir", run="B", records=rec_b, lines=lines_b, launches=launches,
             expected=want, source_launches=sources, expected_sources=want_sources,
             restored_leaves_bitwise=checked[0][0])
        if lines_b != [f"restored checkpoint at step {TRAIN_DIR_STEPS} from {d}",
                       f"exported {bundle}"]:
            fail(f"train_dir: run B printed {lines_b}")
        if [r["step"] for r in rec_b] != [TRAIN_DIR_RESUMED]:
            fail(f"train_dir: run B's records {rec_b}")
        if launches != want or sources != want_sources:
            fail(f"train_dir: run B launched {launches} by source {sources}, expected {want} "
                 f"by source {want_sources}")
        if list_committed_steps(d) != [TRAIN_DIR_STEPS, TRAIN_DIR_RESUMED]:
            fail(f"train_dir: run B left committed steps {list_committed_steps(d)}")
        if not os.path.getsize(bundle) > 0:
            fail("train_dir: no bundle")
        train_dir_bytes = sum(os.path.getsize(os.path.join(p, f))
                              for p, _, fs in os.walk(os.path.join(d, str(TRAIN_DIR_RESUMED)))
                              for f in fs)
        shutil.rmtree(d)
        gc.collect()
        torch.cuda.empty_cache()

        _zero_counts()
        loss_c, rec_c, _ = _run_cli(train_lm, [*argv, "--training_steps",
                                               str(TRAIN_DIR_RESUMED)])
        gc.collect()
        torch.cuda.empty_cache()
        rel = abs(loss_b - loss_c) / abs(loss_c)
        emit(phase="train_dir", run="A", records=rec_a, wall_s=round(wall_a, 2))
        emit(phase="train_dir", check="resume_vs_uninterrupted", loss_resumed=loss_b,
             loss_uninterrupted=loss_c, rel=rel, tol=TRAIN_DIR_TOL, wall_b_s=round(wall_b, 2),
             step_dir_bytes=train_dir_bytes, text_bytes=size, card=smi)
        if not rel <= TRAIN_DIR_TOL:
            fail(f"train_dir: resumed loss {loss_b} against uninterrupted {loss_c}")

        gen = torch.Generator(device="cuda").manual_seed(21)
        tokens = torch.randint(0, 256, (shape["batch_size"], shape["seq_len"]), device="cuda",
                               generator=gen)
        timings = _manager_round_trip(smi, work, tokens)
        _zero_counts()

        # Two holdout windows: the tail that int(size * (1 - f)) leaves is
        # between 2 and 3 windows long.
        seq = shape["seq_len"]
        fraction = (2.5 * seq) / size
        tail = size - int(size * (1 - fraction))
        if not 2 * seq <= tail < 3 * seq:
            fail(f"train_dir: holdout of {tail} bytes is not two windows")
        evals = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            _, (rec,), _ = _run_cli(eval_lm, ["--model", bundle, "--text_file", text,
                                             "--holdout_fraction", repr(fraction),
                                             "--batch_size", "1", "--device", device])
            evals[device] = rec
            emit(phase="train_dir", eval_device=device, wall_s=round(time.perf_counter() - t0, 2),
                 **rec)
            if rec["tokens_scored"] != 2 * (seq - 1):
                fail(f"train_dir: eval_lm on {device} scored {rec['tokens_scored']} tokens")
        gc.collect()
        torch.cuda.empty_cache()
        card, cpu = evals["cuda"]["nll_per_byte"], evals["cpu"]["nll_per_byte"]
        rel = abs(card - cpu) / abs(cpu)
        emit(phase="train_dir", check="eval_card_vs_cpu", nll_card=card, nll_cpu=cpu, rel=rel,
             tol=EVAL_TOL, card=smi)
        if not rel <= EVAL_TOL:
            fail(f"train_dir: eval_lm's nll on the card {card} against the CPU's {cpu}")
        emit(phase="train_dir", **timings,
             save_stall_share_of_600s=round(timings["save_s"] / 600, 5))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _zero_counts()


# phase_seq_parallel: the modes that attend without a flash kernel — dp with
# --attention blockwise, sp and sp_tp in a world of one (the ring as one hop)
# — at the flagship, byte-level on the repo's text, each run's launch counts
# flat; then sp at the long recipe. Each run's first-step loss against the
# uninterrupted forward of the same seed's weights on K1 (dp's
# TransformerLM for blockwise and sp, tp's TpTransformerLM for sp_tp).
SEQ_RUNS = {
    "blockwise": (["--attention", "blockwise"], "dp"),
    "sp": (["--parallelism", "sp", "--model_parallel", "1"], "dp"),
    "sp_tp": (["--parallelism", "sp_tp", "--pipeline_parallel", "1", "--model_parallel", "1"],
              "tp"),
}
SEQ_TOL = 1e-2  # first-step loss against flash's, relative (bf16 logits, dense blocks)
SEQ_LONG_BATCHES = (3, 2, 1)  # the long recipe's batch, cut in turn if it does not fit


def _text_flags(text):
    return ["--text_file", text, "--holdout_fraction", "0.05"]


def _first_step_loss(kind, text):
    """The trainer's first-step loss, computed apart: the forward of
    ``TransformerLM`` (``kind`` "dp") or ``TpTransformerLM`` ("tp") from seed
    0 at the flagship, flash attention, on the trainer's first text batch."""
    from distributed_tensorflow_tpu_torch.data.text import ByteTextDataset, load_byte_tokens
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerLM,
        next_token_loss,
    )
    from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import TpTransformerLM

    data = ByteTextDataset(load_byte_tokens(text), FLAGSHIP["seq_len"], holdout_fraction=0.05,
                           seed=0)
    tokens = torch.from_numpy(data.train_batch(FLAGSHIP["batch_size"], step=0)).cuda()
    cls = TransformerLM if kind == "dp" else TpTransformerLM
    model = cls(_cfg(), seed=0, device="cuda")
    with torch.no_grad():
        loss = float(next_token_loss(model(tokens), tokens))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return loss


def phase_seq_parallel(smi, text, long_base=None):
    """dp --attention blockwise, sp and sp_tp (a world of one) at the
    flagship for 6 steps each on ``text`` (:data:`SEQ_RUNS`), by
    :func:`_trainer_run` with no launch allowed: every KERNEL_LAUNCHES and
    SOURCE_LAUNCHES count stays 0 while they train. Each run's first-step
    loss within SEQ_TOL of the flash forward's on the same weights and
    batch; steps/s, tokens/s, MFU and peak memory printed beside each other.
    Then sp at the long recipe (seq 8192, rope θ 500000, 4 kv heads, batch 3
    cut to 2 or 1 if it does not fit, the cut printed), its losses within
    LOSS_TOL of ``long_base`` (phase 4's long records) when the batch is
    whole."""
    from distributed_tensorflow_tpu_torch.cli.tp_cards import LOSS_TOL

    t0 = time.perf_counter()
    first = {kind: _first_step_loss(kind, text) for kind in ("dp", "tp")}
    for name, (flags, against) in SEQ_RUNS.items():
        phase = f"seq_parallel_{name}"
        _, records, peak = _trainer_run(smi, phase, FLAGSHIP, [*flags, *_text_flags(text)], {},
                                        interval=1)
        rel = abs(records[0]["loss"] - first[against]) / abs(first[against])
        emit(phase=phase, first_step_loss=records[0]["loss"], flash_first_step_loss=first[against],
             flash_model=against, rel=rel, tol=SEQ_TOL, max_memory_allocated=peak, card=smi)
        if not rel <= SEQ_TOL:
            fail(f"{phase}: first-step loss {records[0]['loss']} against flash's {first[against]}")
    flags = ["--parallelism", "sp", "--model_parallel", "1", *MAIN_PATHS["long"][0]]
    for batch in SEQ_LONG_BATCHES:
        shape = dict(LONG, batch_size=batch)
        error = None
        try:
            _, records, peak = _trainer_run(smi, "seq_parallel_sp_long", shape, flags, {})
        except torch.OutOfMemoryError as e:
            error = str(e).splitlines()[0]
        if error is not None:  # the traceback's tensors are gone here
            gc.collect()
            torch.cuda.empty_cache()
            emit(phase="seq_parallel_sp_long", batch_size=batch, fits=False, error=error,
                 card=smi)
            continue
        cut = batch != LONG["batch_size"]
        emit(phase="seq_parallel_sp_long", batch_size=batch, fits=True,
             batch_cut_from=LONG["batch_size"] if cut else None, max_memory_allocated=peak,
             card=smi)
        if long_base is not None and not cut:
            losses = [r["loss"] for r in records]
            base = [r["loss"] for r in long_base]
            worst = max(abs(a - b) / abs(b) for a, b in zip(losses, base))
            emit(phase="seq_parallel_sp_long", losses=losses, long_flash_losses=base,
                 loss_rel_diff=worst, loss_tol=LOSS_TOL)
            if len(losses) != len(base) or not worst <= LOSS_TOL:
                fail(f"seq_parallel_sp_long: losses {losses} against long's {base}")
        break
    else:
        fail("seq_parallel_sp_long: no batch of the long recipe fits one card")
    emit(phase="seq_parallel", phase_s=round(time.perf_counter() - t0, 2))


# phase_train_dir, extended: --train_dir in the pipeline and sequence modes at
# the flagship's width on the repo's text, depth cut to TRAIN_DIR_MODE_LAYERS
# of its 8 layers (a full-depth save and restore take 6-7 s and 8-11 s each,
# four modes 191 s, measured on one H100; dp's run above saves the whole
# flagship). Run A trains TRAIN_DIR_MODE_SAVE steps (its forced final save
# commits them), run B resumes to TRAIN_DIR_MODE_STEPS, run C trains them
# straight. Each mode's flags and launches a layer a step.
TRAIN_DIR_MODE_SAVE, TRAIN_DIR_MODE_STEPS, TRAIN_DIR_MODE_LAYERS = 3, 6, 2
TRAIN_DIR_MODES = {
    "pp": (PIPELINE_RUNS["pp"][0], PIPELINE_RUNS["pp"][1]),
    "3d": (PIPELINE_RUNS["3d"][0], PIPELINE_RUNS["3d"][1]),
    "sp": (SEQ_RUNS["sp"][0], {}),
    "sp_tp": (SEQ_RUNS["sp_tp"][0], {}),
}


def _restored_diff(tree, step, model, opt, mesh):
    """(leaves compared, keys that differ): the tree ``train_state`` makes
    of a model and optimizer just restored from ``tree`` (a step as read)
    against ``tree``, leaf by leaf and bitwise; a block against its bounds
    in the whole leaf. A key the step holds that the restored state does
    not write counts as differing."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.train import checkpoint as ck

    saved = {ck._keystr(t): v for t, v in ck._flatten(tree)}
    seen, bad = set(), []
    for tokens, leaf in ck._flatten(ck.train_state(model, opt, step, mesh)):
        key = ck._keystr(tokens)
        seen.add(key)
        want = saved.get(key)
        if want is None:
            bad.append(key)
            continue
        want = np.asarray(want)
        if isinstance(leaf, ck.Shard):
            got = ck._host(leaf.value)
            want = want[tuple(slice(a, b) for a, b in leaf.index)]
        else:
            got = ck._host(leaf)
        if want.shape != got.shape or not np.array_equal(want, got):
            bad.append(key)
    return len(seen), bad + sorted(set(saved) - seen)


@contextlib.contextmanager
def _managers():
    """Every CheckpointManager the trainer makes inside, in a list, the
    seconds its restore_train_state took, and for each restore
    :func:`_restored_diff` of what it loaded (outside the timing)."""
    from distributed_tensorflow_tpu_torch.train import checkpoint as ck

    made, load_s, checked = [], [], []
    init, restore = ck.CheckpointManager.__init__, ck.restore_train_state

    def tracked_init(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    def timed_restore(step, tree, model, opt, mesh=None):
        t0 = time.perf_counter()
        try:
            global_step = restore(step, tree, model, opt, mesh)
        finally:
            torch.cuda.synchronize()
            load_s.append(time.perf_counter() - t0)
        checked.append(_restored_diff(tree, global_step, model, opt, mesh))
        return global_step

    ck.CheckpointManager.__init__, ck.restore_train_state = tracked_init, timed_restore
    try:
        yield made, load_s, checked
    finally:
        ck.CheckpointManager.__init__, ck.restore_train_state = init, restore


def phase_train_dir_modes(smi, text):
    """pp and 3d (one stage, one rank), sp and sp_tp (a world of one) with
    --train_dir at the flagship's width (TRAIN_DIR_MODE_LAYERS layers): run
    A commits step TRAIN_DIR_MODE_SAVE, run B restores it and trains to
    TRAIN_DIR_MODE_STEPS with exactly the mode's launches for those steps
    (none for sp and sp_tp) and commits it; the state B restored, saved
    again, equals the step's tree bitwise (:func:`_restored_diff`); B's
    loss within TRAIN_DIR_TOL of run C's, the same steps uninterrupted.
    Prints save seconds and bytes
    and restore seconds (the read, then the load into the model and
    optimizer)."""
    from distributed_tensorflow_tpu_torch.cli import train_lm
    from distributed_tensorflow_tpu_torch.train.checkpoint import list_committed_steps

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, ".scratch", "chip_smoke_train_dir_modes")
    shape, n = FLAGSHIP, TRAIN_DIR_MODE_LAYERS
    argv = [
        "--d_model", str(shape["d_model"]), "--num_heads", str(shape["num_heads"]),
        "--num_layers", str(n), "--d_ff", str(shape["d_ff"]),
        "--seq_len", str(shape["seq_len"]), "--batch_size", str(shape["batch_size"]),
        "--use_bias", "0", "--attention", "flash", "--device", "cuda", *_text_flags(text),
        "--eval_step_interval", str(TRAIN_DIR_MODE_SAVE),
        "--learning_rate", str(TRAIN_DIR_LR),
    ]
    t0 = time.perf_counter()
    for mode, (flags, per_layer) in TRAIN_DIR_MODES.items():
        shutil.rmtree(work, ignore_errors=True)
        d = os.path.join(work, "train")
        ckpt = ["--train_dir", d, "--save_secs", "1000000"]
        with _managers() as (made, _, _):
            _, rec_a, _ = _run_cli(train_lm, [*argv, *flags, *ckpt, "--training_steps",
                                              str(TRAIN_DIR_MODE_SAVE)])
        save_a = made[-1]
        if list_committed_steps(d) != [TRAIN_DIR_MODE_SAVE]:
            fail(f"train_dir {mode}: run A committed {list_committed_steps(d)}")
        step_bytes = sum(os.path.getsize(os.path.join(p, f))
                         for p, _, fs in os.walk(os.path.join(d, str(TRAIN_DIR_MODE_SAVE)))
                         for f in fs)
        gc.collect()
        torch.cuda.empty_cache()
        _zero_counts()
        with _managers() as (made, load_s, checked):
            loss_b, rec_b, lines_b = _run_cli(train_lm, [*argv, *flags, *ckpt, "--training_steps",
                                                         str(TRAIN_DIR_MODE_STEPS)])
        mngr_b = made[-1]
        launches, sources = dict(A.KERNEL_LAUNCHES), dict(A.SOURCE_LAUNCHES)
        steps = TRAIN_DIR_MODE_STEPS - TRAIN_DIR_MODE_SAVE
        want = {k: per_layer.get(k, 0) * n * steps for k in A.KERNEL_LAUNCHES}
        want_sources = expected_sources(want)
        gc.collect()
        torch.cuda.empty_cache()
        if lines_b != [f"restored checkpoint at step {TRAIN_DIR_MODE_SAVE} from {d}"]:
            fail(f"train_dir {mode}: run B printed {lines_b}")
        if len(checked) != 1 or checked[0][1]:
            fail(f"train_dir {mode}: the state restored from step {TRAIN_DIR_MODE_SAVE} differs "
                 f"from the step's tree in {checked}")
        if launches != want or sources != want_sources:
            fail(f"train_dir {mode}: run B launched {launches} by source {sources}, expected "
                 f"{want} by source {want_sources}")
        if list_committed_steps(d) != [TRAIN_DIR_MODE_SAVE, TRAIN_DIR_MODE_STEPS]:
            fail(f"train_dir {mode}: run B left committed steps {list_committed_steps(d)}")
        straight, _, _ = _run_cli(train_lm, [*argv, *flags, "--training_steps",
                                             str(TRAIN_DIR_MODE_STEPS)])
        gc.collect()
        torch.cuda.empty_cache()
        rel = abs(loss_b - straight) / abs(straight)
        emit(phase="train_dir", mode=mode, num_layers=n, records_a=rec_a, records_b=rec_b,
             launches=launches, expected=want, loss_resumed=loss_b, loss_uninterrupted=straight,
             rel=rel, tol=TRAIN_DIR_TOL, save_s=round(save_a.last_save_seconds, 3),
             save_bytes=save_a.last_save_bytes, step_dir_bytes=step_bytes,
             restore_read_s=round(mngr_b.last_restore_seconds, 3),
             restore_load_s=round(load_s[0], 3), restored_leaves_bitwise=checked[0][0],
             card=smi)
        if not rel <= TRAIN_DIR_TOL:
            fail(f"train_dir {mode}: resumed loss {loss_b} against uninterrupted {straight}")
    shutil.rmtree(work, ignore_errors=True)
    _zero_counts()
    emit(phase="train_dir", modes_phase_s=round(time.perf_counter() - t0, 2))


@contextlib.contextmanager
def _seq_text():
    """The repo's text (:func:`_repo_text`) in a file for the phase, removed after."""
    root = os.path.dirname(os.path.abspath(__file__))
    text = os.path.join(root, ".scratch", "chip_smoke_seq_text.bin")
    os.makedirs(os.path.dirname(text), exist_ok=True)
    _repo_text(text)
    try:
        yield text
    finally:
        os.remove(text)


def seq_main():
    """``chip_smoke.py --seq``: the card line, phase seq_parallel and the
    extended train_dir modes alone (no phase 4 records to hold the long
    run's losses against)."""
    smi = phase_card()
    with _seq_text() as text:
        phase_seq_parallel(smi, text)
        phase_train_dir_modes(smi, text)
    print(smi, flush=True)


def spread_main():
    """``chip_smoke.py --spread``: how far apart two uninterrupted runs of
    one seed end, in the commands the train_dir phases give run C, by
    learning rate, mode and seed: the modes' (2 layers, 6 steps; 3d and pp
    at the trainer's default 3e-3, 3d at 3e-4 and TRAIN_DIR_LR, seeds 1-6)
    and dp's (8 layers, 12 steps, 3e-3 and TRAIN_DIR_LR, seeds 1-3). The
    two runs differ only in the order in which the backward kernels'
    atomics add into dq."""
    from distributed_tensorflow_tpu_torch.cli import train_lm

    smi = phase_card()
    shape = FLAGSHIP
    with _seq_text() as text:
        modes = [
            "--d_model", str(shape["d_model"]), "--num_heads", str(shape["num_heads"]),
            "--num_layers", str(TRAIN_DIR_MODE_LAYERS), "--d_ff", str(shape["d_ff"]),
            "--seq_len", str(shape["seq_len"]), "--batch_size", str(shape["batch_size"]),
            "--use_bias", "0", "--attention", "flash", "--device", "cuda", *_text_flags(text),
            "--eval_step_interval", "1", "--training_steps", str(TRAIN_DIR_MODE_STEPS),
        ]
        dp = [*_train_dir_argv(text), "--training_steps", str(TRAIN_DIR_RESUMED)]
        runs = [(lr, mode, modes + TRAIN_DIR_MODES[mode][0], range(1, 7))
                for lr, names in ((3e-3, ("3d", "pp")), (3e-4, ("3d",)), (TRAIN_DIR_LR, ("3d",)))
                for mode in names]
        runs += [(lr, "dp", dp, range(1, 4)) for lr in (3e-3, TRAIN_DIR_LR)]
        for lr, mode, argv, seeds in runs:
            for seed in seeds:
                run = [*argv, "--learning_rate", str(lr), "--seed", str(seed)]
                losses = []
                for _ in range(2):
                    last, rec, _ = _run_cli(train_lm, run)
                    losses.append([r["loss"] for r in rec[:-1]] + [last])
                    gc.collect()
                    torch.cuda.empty_cache()
                emit(phase="spread", learning_rate=lr, mode=mode, seed=seed, losses=losses,
                     rel=abs(losses[0][-1] - losses[1][-1]) / abs(losses[0][-1]), card=smi)
    print(smi, flush=True)


# phase_serve: the serving core (cli/serve_lm.py's stack) at the flagship's
# width. Its path reaches no flash kernel (the cached branch attends by two
# matmuls); its reference does: the uncached forward with flash attention
# (K1) over each request's prompt and emitted tokens.
SERVE_SEED = 5
SERVE = dict(slots=8, serve_max_len=2048, prefill_len=1024, page_size=16,
             prefill_chunk_tokens=512, steps_per_sync=1, max_queue_depth=64,
             request_timeout_s=300.0)
SERVE_BUCKETS = (64, 256)  # with prefill_len 1024; chunk 512 keeps {64, 256, 512}
SERVE_NEW = 64
SERVE_PREFIX = 512
# Cached logits (bf16 weights, f32 attention) against the K1 forward's (bf16
# P·V), as max |cached - reference| / max |reference| over each request's
# emitted positions; a token may differ from the reference's argmax only
# where the reference's top two are closer than SERVE_TOL · max |reference|.
SERVE_TOL = 3e-2
# The long recipe's check: 2 layers of LONG, one 6,000-token prompt.
SERVE_LONG_PROMPT, SERVE_LONG_NEW = 6000, 16


def _serve_prompts():
    """16 requests: prompts of 16-1,500 tokens, the first 8 sharing a
    512-token prefix; 4 sampled (top_k 20, top_p 0.9), 2 streaming."""
    import numpy as np

    rng = np.random.default_rng(SERVE_SEED)
    prefix = rng.integers(0, 256, SERVE_PREFIX).tolist()
    reqs = []
    for i in range(16):
        if i < 8:
            prompt = prefix + rng.integers(0, 256, int(rng.integers(16, 989))).tolist()
        else:
            prompt = rng.integers(0, 256, int(rng.integers(16, 1501))).tolist()
        body = {"prompt": prompt, "max_new_tokens": SERVE_NEW, "request_id": f"s{i}"}
        if i % 4 == 3:
            body.update(temperature=0.8, top_k=20, top_p=0.9, seed=100 + i)
        if i in (1, 7):
            body["stream"] = True
        reqs.append(body)
    return reqs


def _http(url, body=None, timeout=300):
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers.get("Content-Type", ""), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type", ""), err.read()


def _serve_outcome(status, ctype, raw):
    """The completion JSON of a /generate answer (the SSE done frame's for
    a stream), with the streamed tokens beside it."""
    if not ctype.startswith("text/event-stream"):
        return status, json.loads(raw), None
    frames = [dict(line.split(": ", 1) for line in f.splitlines())
              for f in raw.decode().split("\n\n") if f.strip()]
    streamed = [t for f in frames if f["event"] == "token" for t in json.loads(f["data"])["tokens"]]
    return status, json.loads(frames[-1]["data"]), streamed


def _traced_requests(trace, results):
    """Each request's candidate traces [[(token index, logits row)]] out of
    the engine's logit trace of the HTTP run: a slot's picks split at each
    token index 0, each run matched by the tokens it picked. Requests that
    emitted the same stream (a random model may) share one list holding
    every such run; _hold_against_reference takes the run its prompt's
    reference fits best out of it."""
    runs = {}
    for slot, i, tok, lg in trace:
        if i == 0:
            runs.setdefault(slot, []).append([])
        runs[slot][-1].append((i, tok, lg))
    by_tokens = {}
    for run in (r for rs in runs.values() for r in rs):
        by_tokens.setdefault(tuple(t for _, t, _ in run), []).append(
            [(i, lg) for i, _, lg in run])
    wanted = {}
    for res in results:
        key = tuple(res[1]["tokens"])
        wanted[key] = wanted.get(key, 0) + 1
    if any(len(by_tokens.get(key, ())) != n for key, n in wanted.items()):
        fail("serve: the trace's runs do not match the requests' streams")
    return [by_tokens[tuple(res[1]["tokens"])] for res in results]


def _traced_replay(engine, body):
    """One request alone through the engine's own API with its logit trace
    on: (tokens, [(token index, logits row)])."""
    engine.logit_trace = []
    slot = engine.acquire_slot()
    first, finished = engine.start(
        slot, body["prompt"], max_new_tokens=body["max_new_tokens"],
        temperature=body.get("temperature", 0.0), top_k=body.get("top_k", 0),
        top_p=body.get("top_p", 0.0), seed=body.get("seed", 0))
    toks = [] if first is None else [first]
    while not finished:
        t, v, done = engine.step()
        toks += [int(x) for x in t[v[:, slot], slot]]
        finished = bool(done[slot])
    engine.release(slot)
    trace = sorted(((i, lg) for s, i, _, lg in engine.logit_trace if s == slot),
                   key=lambda x: x[0])
    engine.logit_trace = None
    return toks, trace


def _hold_against_reference(name, ref_model, prompt, toks, traces, top=None, tol=SERVE_TOL):
    """The engine's logits at each emitted position against the uncached
    K1 forward over prompt + emitted tokens, within ``tol`` of its largest;
    greedy tokens equal to the reference's argmax but at near-ties (top two
    closer than ``tol``); a sampled token (``top`` = its top_k, top_p)
    inside the filtered support of the engine's own logits. ``traces``
    holds the candidate runs of this stream: the best fit is held and taken
    out of the list. Returns the error and the near-tie count."""
    from distributed_tensorflow_tpu_torch.models.decoding import filter_logits_batched

    for trace in traces:
        if [i for i, _ in trace] != list(range(len(toks))):
            fail(f"serve: {name}: the trace holds tokens {[i for i, _ in trace]}")
    seq = torch.tensor([list(prompt) + list(toks)], device="cuda")
    with torch.no_grad():
        ref = ref_model(seq)[0, len(prompt) - 1: len(prompt) - 1 + len(toks)].float()
    scale = ref.abs().max().item()
    errs = [(torch.stack([lg for _, lg in t]).cuda() - ref).abs().max().item() / scale
            for t in traces]
    best = min(range(len(traces)), key=errs.__getitem__)
    cached, err = torch.stack([lg for _, lg in traces.pop(best)]).cuda(), errs[best]
    if not err <= tol:
        fail(f"serve: {name}: cached logits {err:.3e} from the reference's (tol {tol})")
    ties = 0
    if top is None:
        two = torch.topk(ref, 2, dim=-1).values
        near = (two[:, 0] - two[:, 1]) < tol * scale
        picked = torch.tensor(toks, device="cuda")
        wrong = (picked != ref.argmax(-1)) & ~near
        if wrong.any():
            fail(f"serve: {name}: tokens {torch.nonzero(wrong).flatten().tolist()} differ from "
                 "the reference's argmax where its top two are apart")
        ties = int(((picked != ref.argmax(-1)) & near).sum())
    else:
        k, p = top
        n = len(toks)
        filt = filter_logits_batched(cached, torch.full((n,), 0.8), torch.full((n,), k),
                                     torch.full((n,), p))
        support = filt[torch.arange(n), torch.tensor(toks)] > -1e29
        topk = torch.topk(cached, k, dim=-1).indices
        in_topk = (topk == torch.tensor(toks, device="cuda")[:, None]).any(-1)
        if not (support.all() and in_topk.all()):
            fail(f"serve: {name}: sampled tokens outside their top_k/top_p support")
    return err, ties


def _decode_rate(engine, n_slots, rounds=32):
    """Emitted tokens/s and ms per round with ``n_slots`` greedy requests
    (256-token prompts), timed over ``rounds`` rounds after two (a verify
    round emits up to spec_k + 1 tokens a slot)."""
    import numpy as np

    rng = np.random.default_rng(SERVE_SEED + n_slots)
    budget = (rounds + 8) * (engine.spec_k + 1)
    slots = []
    for _ in range(n_slots):
        s = engine.acquire_slot()
        engine.start(s, rng.integers(0, 256, 256).tolist(), max_new_tokens=budget)
        slots.append(s)
    engine.step()
    engine.step()
    t0 = time.perf_counter()
    emitted = 0
    for _ in range(rounds):
        _, valid, _ = engine.step()
        emitted += int(valid.sum())
    dt = time.perf_counter() - t0
    for s in slots:
        engine.release(s)
    return emitted / dt, 1e3 * dt / rounds


def _ttft_direct(engine, prompt):
    """Seconds from ``start`` to the request's first token (the chunked
    path's comes out of a later step), greedy, the request alone."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slot = engine.acquire_slot()
    first, _ = engine.start(slot, prompt, max_new_tokens=2)
    while first is None:
        t, v, _ = engine.step()
        if v[:, slot].any():
            first = int(t[v[:, slot], slot][0])
    dt = time.perf_counter() - t0
    engine.release(slot)
    return dt


def _serve_cli_subprocess(smi):
    """python -m ...cli.serve_lm --demo on the card: one /generate, one
    /healthz, then SIGTERM and a clean exit."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.serve_lm", "--demo",
         "--port", "0", "--d_model", "256", "--num_heads", "4", "--num_layers", "2",
         "--d_ff", "1024", "--seq_len", "256", "--slots", "2"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        if not line.startswith("serving on http://"):
            fail(f"serve: cli/serve_lm printed {line!r}")
        base = line.split()[2]
        status, _, raw = _http(base + "/generate", {"prompt": "Hello", "max_new_tokens": 8})
        body = json.loads(raw)
        health, _, hraw = _http(base + "/healthz")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    emit(phase="serve", check="cli_serve_lm", serving_line=line.strip(), generate_status=status,
         tokens=body.get("tokens"), text=body.get("text"), healthz=health,
         exit_code=proc.returncode, card=smi)
    if (status, health, proc.returncode) != (200, 200, 0) or len(body["tokens"]) != 8:
        fail(f"serve: cli/serve_lm answered {status}/{health}, exited {proc.returncode}: {out}")
    if "shut down cleanly" not in out:
        fail(f"serve: cli/serve_lm did not shut down cleanly: {out}")


def phase_serve(smi):
    """The serving core on the card, at the flagship's width (SERVE):
    weights from SERVE_SEED exported to a bundle and served by
    cli/serve_lm.py's build_stack; 16 concurrent HTTP requests; every
    greedy request's cached logits and tokens against the K1 forward's,
    every sampled token inside its support; compile_count flat and every
    page freed; the long recipe's 6,000-token prompt through chunked
    prefill; cli/serve_lm.py as a subprocess; the readings."""
    import threading

    import numpy as np

    from distributed_tensorflow_tpu_torch.cli.serve_lm import build_stack
    from distributed_tensorflow_tpu_torch.config import ServeConfig
    from distributed_tensorflow_tpu_torch.models.convert import transformer_params_to_jax
    from distributed_tensorflow_tpu_torch.models.transformer import TransformerLM
    from distributed_tensorflow_tpu_torch.obs.export import parse_prometheus_text
    from distributed_tensorflow_tpu_torch.serve.engine import SlotEngine
    from distributed_tensorflow_tpu_torch.train.checkpoint import (
        export_inference_bundle,
        load_lm_bundle,
    )

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, ".scratch", "chip_smoke_serve")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        cfg = _cfg(attention="flash")
        ref = TransformerLM(cfg, seed=SERVE_SEED, device="cuda")  # K1: the reference
        bundle = os.path.join(work, "serve.msgpack")
        meta = {"model": "TransformerLM", "parallelism": "dp", "config": {
            "vocab_size": 256, "d_model": cfg.d_model, "num_heads": cfg.num_heads,
            "num_kv_heads": 0, "attention_window": 0, "use_bias": 0, "rope": 0,
            "num_layers": cfg.num_layers, "d_ff": cfg.d_ff, "max_seq_len": cfg.max_seq_len}}
        export_inference_bundle(bundle, transformer_params_to_jax(ref), metadata=meta)
        scfg, model, _ = load_lm_bundle(bundle, device="cuda")
        t0 = time.perf_counter()
        engine, sched, metrics, server = build_stack(ServeConfig(port=0, **SERVE), scfg, model,
                                                     prefill_buckets=SERVE_BUCKETS)
        warm_s = time.perf_counter() - t0
        compiled = engine.compile_count()
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        sched.start(poll_s=0.0005)
        base = "http://%s:%d" % server.server_address
        reqs = _serve_prompts()
        results = [None] * len(reqs)
        engine.logit_trace = []  # one more small copy back a round
        _zero_counts()

        def call(i):
            results[i] = _serve_outcome(*_http(base + "/generate", reqs[i]))

        t0 = time.perf_counter()
        callers = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
        for c in callers:
            c.start()
        for c in callers:
            c.join(timeout=600)
        http_s = time.perf_counter() - t0
        health = json.loads(_http(base + "/healthz")[2])
        prom = _http(base + "/metrics")[2].decode()
        served_launches = dict(A.KERNEL_LAUNCHES)
        server.shutdown()
        server.server_close()
        sched.stop()
        if any(served_launches.values()):
            fail(f"serve: the serving path launched flash kernels: {served_launches}")
        for i, res in enumerate(results):
            if res is None or res[0] != 200 or len(res[1]["tokens"]) != SERVE_NEW:
                fail(f"serve: request {i} answered {res and res[:2]}")
            if res[2] is not None and res[2] != res[1]["tokens"]:
                fail(f"serve: request {i}'s stream differs from its done frame")
        samples = {x["name"]: x["value"] for x in parse_prometheus_text(prom)}
        if samples.get("recompile_events_total") != 0:
            fail(f"serve: /metrics reports {samples.get('recompile_events_total')} "
                 "recompile events after warmup")

        # Each request's picks as the batched run made them, against the
        # reference (bf16 batches of other sizes may break near-ties
        # differently, so a replay need not repeat them).
        traces = _traced_requests(engine.logit_trace, results)
        engine.logit_trace = None
        errs, ties, hits = [], 0, engine.prefix_hit_rate
        for i, (body, cands) in enumerate(zip(reqs, traces)):
            toks = results[i][1]["tokens"]
            top = (body["top_k"], body["top_p"]) if "top_k" in body else None
            err, tie = _hold_against_reference(f"request {i}", ref, body["prompt"], toks,
                                               cands, top)
            errs.append(err)
            ties += tie
        ref_launches = A.KERNEL_LAUNCHES["flash_fwd"]
        if ref_launches != len(reqs) * cfg.num_layers:
            fail(f"serve: the reference made {ref_launches} K1 launches")
        emit(phase="serve", check="greedy_and_sampled_against_k1", max_rel_logit_err=max(errs),
             tol=SERVE_TOL, near_ties=ties, greedy_requests=12, sampled_requests=4,
             reference_k1_launches=ref_launches, serving_path_launches=served_launches, card=smi)

        # Readings straight from the engine (the scheduler is stopped).
        rng = np.random.default_rng(SERVE_SEED + 1)
        cold, hit = [], []
        for _ in range(3):
            shared = rng.integers(0, 256, SERVE_PREFIX).tolist()
            cold.append(_ttft_direct(engine, shared + rng.integers(0, 256, 88).tolist()))
            hit.append(_ttft_direct(engine, shared + rng.integers(0, 256, 88).tolist()))
        rate1, round1 = _decode_rate(engine, 1)
        rate8, round8 = _decode_rate(engine, 8)
        if engine.compile_count() != compiled:
            fail(f"serve: compile_count {engine.compile_count()} after warmup's {compiled}")
        if engine.active.any() or engine.prefilling.any() or engine.free_slots != engine.slots:
            fail("serve: slots still held after the last release")
        held = engine.pool.pages_allocatable - engine.pool.pages_free
        cached_pages = len(engine.prefix)
        engine.prefix.clear()
        if engine.pool.pages_free != engine.pool.pages_allocatable:
            fail(f"serve: {engine.pool.pages_allocatable - engine.pool.pages_free} pages "
                 "leaked after the prefix cache's eviction")
        if held != cached_pages:
            fail(f"serve: {held} pages held after release, the prefix cache indexes "
                 f"{cached_pages}")
        percall = SlotEngine(scfg, model, slots=8, max_len=2048, prefill_len=1024,
                             page_size=16, device="cuda", hold_compute_weights=False)
        pc_rate1, pc_round1 = _decode_rate(percall, 1)
        pc_rate8, pc_round8 = _decode_rate(percall, 8)
        del percall
        ttft = sorted(r[1]["ttft_ms"] for r in results)
        per_tok = sorted((r[1]["latency_ms"] - r[1]["ttft_ms"]) / (SERVE_NEW - 1) for r in results)
        emit(phase="serve", reading="latency", ttft_ms_p50=float(np.percentile(ttft, 50)),
             ttft_ms_p90=float(np.percentile(ttft, 90)),
             ms_per_output_token_p50=float(np.percentile(per_tok, 50)),
             ms_per_output_token_p90=float(np.percentile(per_tok, 90)),
             http_wall_s=round(http_s, 3), requests=len(reqs), card=smi)
        emit(phase="serve", reading="decode", tokens_per_s_1_slot=rate1,
             tokens_per_s_8_slots=rate8, ms_per_round_1_slot=round1, ms_per_round_8_slots=round8,
             per_call_casts_ms_per_round_1_slot=pc_round1,
             per_call_casts_ms_per_round_8_slots=pc_round8,
             per_call_casts_tokens_per_s_1_slot=pc_rate1,
             per_call_casts_tokens_per_s_8_slots=pc_rate8,
             cast_share_1_slot=1 - round1 / pc_round1, cast_share_8_slots=1 - round8 / pc_round8,
             card=smi)
        emit(phase="serve", reading="prefix", prompt_tokens=SERVE_PREFIX + 88,
             ttft_cold_ms=[round(1e3 * x, 3) for x in cold],
             ttft_prefix_hit_ms=[round(1e3 * x, 3) for x in hit],
             http_prefix_hit_rate=hits, card=smi)
        emit(phase="serve", reading="pool", pool_bytes=engine.pool.hbm_bytes,
             bytes_per_token=engine.kv_bytes_per_token,
             weight_bytes_served=engine.weight_bytes_per_device, buckets=engine.prefill_buckets,
             chunk=engine.prefill_chunk_tokens, compile_count=compiled, warmup_s=round(warm_s, 3),
             healthz_pages_total=health.get("pages_total"), card=smi)
        del engine, sched, metrics, server, model, ref
        gc.collect()
        torch.cuda.empty_cache()

        # The long recipe at 2 layers: one 6,000-token prompt through chunked
        # prefill, rope at absolute positions over the unexpanded GQA cache.
        lcfg = _cfg(dict(LONG, seq_len=8192), attention="flash", num_layers=2)
        lref = TransformerLM(lcfg, seed=SERVE_SEED, device="cuda")
        long_engine = SlotEngine(lcfg, lref, slots=1, max_len=8192, prefill_len=1024,
                                 prefill_chunk_tokens=512, page_size=16, device="cuda")
        long_engine.warmup()
        prompt = np.random.default_rng(SERVE_SEED + 2).integers(0, 256, SERVE_LONG_PROMPT)
        _zero_counts()
        t0 = time.perf_counter()
        toks, trace = _traced_replay(long_engine, {"prompt": prompt.tolist(),
                                                   "max_new_tokens": SERVE_LONG_NEW})
        long_s = time.perf_counter() - t0
        chunks = long_engine.stats["prefill_chunks"]
        if any(A.KERNEL_LAUNCHES.values()):
            fail(f"serve: the long engine launched flash kernels: {dict(A.KERNEL_LAUNCHES)}")
        err, tie = _hold_against_reference("long", lref, prompt.tolist(), toks, [trace])
        emit(phase="serve", check="long_recipe_chunked_prefill", prompt_tokens=SERVE_LONG_PROMPT,
             new_tokens=len(toks), prefill_chunks=chunks, rel_logit_err=err, tol=SERVE_TOL,
             near_ties=tie, wall_s=round(long_s, 3), card=smi)
        del long_engine, lref
        gc.collect()
        torch.cuda.empty_cache()
        _serve_cli_subprocess(smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _zero_counts()
    emit(phase="serve", seconds=round(time.perf_counter() - t_phase, 2), card=smi)


# phase_serve_variants: the deployed serving modes at SERVE's flagship. Like
# phase serve, no path here reaches a flash kernel; the references do (K1).
VARIANTS = {  # name: (target bundle, ServeConfig fields)
    "int8_weights": ("int8", {}),
    "int4_weights_g64": ("int4", {}),
    "int8_kv": ("native", {"kv_dtype": "int8"}),
    "ngram_k4": ("native", {"spec_k": 4}),
    "tree_k4_b3": ("native", {"spec_k": 4, "spec_branches": 3}),
    "drafter_l2_k4_w16": ("native", {"spec_k": 4, "draft_window": 16}),
}
DRAFT_LAYERS = 2
# The int8 cache against K1 on the unquantized weights: tests/test_
# sampling_kv_cache.py bounds the int8 cache by 5% of the largest exact
# logit (plus 5% of each); this holds the largest gap to 5% of the largest.
KV8_TOL = 5e-2


def _serve_variant(smi, name, cfg, model, fields, ref, tol, qtree_bytes=None):
    """One deployed mode through cli/serve_lm.py's build_stack: 16 HTTP
    requests with the logit trace on, the checks against ``ref`` (K1), and
    the engine's readings. Returns the record emitted."""
    import threading

    import numpy as np

    from distributed_tensorflow_tpu_torch.cli.serve_lm import build_stack
    from distributed_tensorflow_tpu_torch.config import ServeConfig

    t0 = time.perf_counter()
    engine, sched, metrics, server = build_stack(ServeConfig(port=0, **SERVE, **fields), cfg,
                                                 model, prefill_buckets=SERVE_BUCKETS)
    warm_s = time.perf_counter() - t0
    compiled = engine.compile_count()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    sched.start(poll_s=0.0005)
    base = "http://%s:%d" % server.server_address
    reqs = _serve_prompts()
    results = [None] * len(reqs)
    engine.logit_trace = []
    _zero_counts()

    def call(i):
        results[i] = _serve_outcome(*_http(base + "/generate", reqs[i]))

    t0 = time.perf_counter()
    callers = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
    for c in callers:
        c.start()
    for c in callers:
        c.join(timeout=600)
    http_s = time.perf_counter() - t0
    launched = {k: n for k, n in A.KERNEL_LAUNCHES.items() if n}
    server.shutdown()
    server.server_close()
    sched.stop()
    if launched:
        fail(f"serve_variants: {name} launched flash kernels: {launched}")
    for i, res in enumerate(results):
        if res is None or res[0] != 200 or len(res[1]["tokens"]) != SERVE_NEW:
            fail(f"serve_variants: {name}: request {i} answered {res and res[:2]}")
        if res[2] is not None and res[2] != res[1]["tokens"]:
            fail(f"serve_variants: {name}: request {i}'s stream differs from its done frame")
    traces = _traced_requests(engine.logit_trace, results)
    engine.logit_trace = None
    errs, ties = [], 0
    for i, (body, cands) in enumerate(zip(reqs, traces)):
        toks = results[i][1]["tokens"]
        top = (body["top_k"], body["top_p"]) if "top_k" in body else None
        if top is None and any(int(lg.argmax()) != t for trace in cands
                               for (_, lg), t in zip(trace, toks)):
            fail(f"serve_variants: {name}: request {i} emitted a token that is not its "
                 "traced logits' argmax")
        err, tie = _hold_against_reference(f"{name} request {i}", ref, body["prompt"], toks,
                                           cands, top, tol=tol)
        errs.append(err)
        ties += tie
    if A.KERNEL_LAUNCHES["flash_fwd"] != len(reqs) * cfg.num_layers:
        fail(f"serve_variants: {name}: the reference made {A.KERNEL_LAUNCHES['flash_fwd']} "
             "K1 launches")
    _zero_counts()
    http_stats = dict(engine.stats)
    rate1, round1 = _decode_rate(engine, 1, rounds=16)
    rate8, round8 = _decode_rate(engine, 8, rounds=16)
    if engine.compile_count() != compiled:
        fail(f"serve_variants: {name}: compile_count {engine.compile_count()} after warmup's "
             f"{compiled}")
    if any(A.KERNEL_LAUNCHES.values()):
        fail(f"serve_variants: {name}: the decode readings launched flash kernels")
    if engine.active.any() or engine.prefilling.any() or engine.free_slots != engine.slots:
        fail(f"serve_variants: {name}: slots still held after the last release")
    if engine.pool.pages_allocatable - engine.pool.pages_free != len(engine.prefix):
        fail(f"serve_variants: {name}: pages held beyond the prefix cache's")
    engine.prefix.clear()
    if engine.pool.pages_free != engine.pool.pages_allocatable:
        fail(f"serve_variants: {name}: pages leaked")
    if qtree_bytes is not None and engine.weight_bytes_per_device != qtree_bytes:
        fail(f"serve_variants: {name}: weight_bytes_per_device {engine.weight_bytes_per_device} "
             f"!= the quantized tree's {qtree_bytes}")
    ttft = sorted(r[1]["ttft_ms"] for r in results)
    record = dict(
        phase="serve_variants", variant=name, weight_dtype=engine.weight_dtype,
        draft_weight_dtype=engine.draft_weight_dtype, kv_dtype=engine.kv_dtype,
        spec_k=engine.spec_k, spec_branches=engine.spec_branches, drafter=engine.drafter,
        max_rel_logit_err=max(errs), tol=tol, near_ties=ties,
        ms_per_round_1_slot=round1, ms_per_round_8_slots=round8,
        tokens_per_s_1_slot=rate1, tokens_per_s_8_slots=rate8,
        spec_accept_rate_http=(http_stats["spec_drafts_accepted"]
                               / max(1, http_stats["spec_drafts_proposed"])),
        spec_accept_per_verify_http=(http_stats["spec_drafts_accepted"]
                                     / max(1, http_stats["spec_verifies"])),
        spec_accept_rate_all=engine.spec_accept_rate_for(engine.drafter) if engine.spec_k else None,
        spec_accept_per_verify_all=engine.spec_accept_per_verify if engine.spec_k else None,
        kv_bytes_per_token=engine.kv_bytes_per_token, pool_bytes=engine.pool.hbm_bytes,
        weight_bytes_per_device=engine.weight_bytes_per_device, quantized_tree_bytes=qtree_bytes,
        ttft_ms_p50=float(np.percentile(ttft, 50)), http_wall_s=round(http_s, 3),
        compile_count=compiled, warmup_s=round(warm_s, 3), card=smi)
    emit(**record)
    del engine, sched, metrics, server
    gc.collect()
    torch.cuda.empty_cache()
    return record


def _loadgen_readings(smi, bundle):
    """The port's tools/loadgen.py self-serving ``bundle`` (8 slots, n-gram
    spec k 4 by its default): closed loop at 8 concurrent for 32 requests,
    then open loop at 1.5x the closed loop's completed req/s, --smoke."""
    from distributed_tensorflow_tpu_torch.tools import loadgen

    shape = ["--model", bundle, "--slots", "8", "--seq_len", "2048", "--prompt_len", "256",
             "--max_new_tokens", "64", "--num_requests", "32", "--smoke", "--report_file", ""]
    reports = {}
    for mode, extra in (("closed", ["--concurrency", "8"]), ("open", None)):
        if extra is None:
            rate = 1.5 * reports["closed"]["completed"] / reports["closed"]["wall_s"]
            extra = ["--rate", f"{rate:.4f}"]
        rc, records, _ = _run_cli(loadgen, [*shape, *extra])
        report = records[-1]
        if rc != 0 or report["outcomes"]["errored"] or report["dropped_without_shed"]:
            fail(f"serve_variants: loadgen {mode} exited {rc}: {report}")
        reports[mode] = report
        emit(phase="serve_variants", reading=f"loadgen_{mode}", completed=report["completed"],
             shed=report["shed"], errored=report["outcomes"]["errored"],
             rate=report["rate"], wall_s=report["wall_s"],
             throughput_tok_s=report["throughput_tok_s"], ttft_ms=report["ttft_ms"],
             spec_accept_rate=report["serve_spec_accept_rate"],
             recompile_events_total=report["recompile_events_total"], card=smi)
        gc.collect()
        torch.cuda.empty_cache()
    return reports


def phase_serve_variants(smi):
    """The deployed serving modes on the card at SERVE's flagship (VARIANTS):
    the weights of phase serve's seed exported, quantized by
    cli/quantize_lm.py to int8 and to int4 at group 64, and a 2-layer
    drafter bundle from init_draft_params; each variant through build_stack
    with 16 HTTP requests, checked against K1 and read (_serve_variant);
    then the port's loadgen self-served."""
    from distributed_tensorflow_tpu_torch.cli import quantize_lm
    from distributed_tensorflow_tpu_torch.models.convert import (
        model_from_tree,
        transformer_params_to_jax,
    )
    from distributed_tensorflow_tpu_torch.models.decoding import init_draft_params
    from distributed_tensorflow_tpu_torch.models.quant import dequantize_lm_params, tree_bytes
    from distributed_tensorflow_tpu_torch.models.transformer import TransformerLM
    from distributed_tensorflow_tpu_torch.train.checkpoint import (
        export_inference_bundle,
        load_inference_bundle,
        load_lm_bundle,
    )

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, ".scratch", "chip_smoke_serve_variants")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        cfg = _cfg(attention="flash")
        ref = TransformerLM(cfg, seed=SERVE_SEED, device="cuda")  # K1: the reference
        config = {"vocab_size": 256, "d_model": cfg.d_model, "num_heads": cfg.num_heads,
                  "num_kv_heads": 0, "attention_window": 0, "use_bias": 0, "rope": 0,
                  "num_layers": cfg.num_layers, "d_ff": cfg.d_ff, "max_seq_len": cfg.max_seq_len}
        bundles = {"native": os.path.join(work, "lm.msgpack")}
        export_inference_bundle(bundles["native"], transformer_params_to_jax(ref), metadata={
            "model": "TransformerLM", "parallelism": "dp", "config": config})
        t0 = time.perf_counter()
        for mode, gs in (("int8", 0), ("int4", 64)):
            bundles[mode] = os.path.join(work, f"lm.{mode}.msgpack")
            _run_cli(quantize_lm, ["--model", bundles["native"], "--out", bundles[mode],
                                   "--mode", mode, "--group_size", str(gs)])
        quantize_s = time.perf_counter() - t0
        scfg, native, _ = load_lm_bundle(bundles["native"], device="cuda")
        draft = init_draft_params(scfg, native, DRAFT_LAYERS)
        bundles["draft"] = os.path.join(work, "draft.msgpack")
        export_inference_bundle(bundles["draft"], transformer_params_to_jax(draft), metadata={
            "model": "TransformerLM", "parallelism": "dp",
            "config": {**config, "num_layers": DRAFT_LAYERS}})
        del draft
        records = {}
        for name, (target, fields) in VARIANTS.items():
            if name.startswith("drafter"):
                fields = dict(fields, draft_model=bundles["draft"])
            if target == "native":
                records[name] = _serve_variant(smi, name, scfg, native, fields, ref,
                                               KV8_TOL if "kv_dtype" in fields else SERVE_TOL)
                continue
            qcfg, qmodel, _ = load_lm_bundle(bundles[target], device="cuda")
            qtree = load_inference_bundle(bundles[target])[0]
            qref = model_from_tree(_cfg(attention="flash"), dequantize_lm_params(
                qtree, qcfg.weight_dtype, qcfg.quant_group_size), "cuda")
            records[name] = _serve_variant(smi, name, qcfg, qmodel, fields, qref, SERVE_TOL,
                                           qtree_bytes=tree_bytes(qtree))
            del qmodel, qref, qtree
            gc.collect()
            torch.cuda.empty_cache()
        del native, ref
        gc.collect()
        torch.cuda.empty_cache()
        _zero_counts()
        _loadgen_readings(smi, bundles["native"])
        if any(A.KERNEL_LAUNCHES.values()):
            fail(f"serve_variants: loadgen launched flash kernels: {dict(A.KERNEL_LAUNCHES)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _zero_counts()
    emit(phase="serve_variants", quantize_s=round(quantize_s, 3),
         seconds=round(time.perf_counter() - t_phase, 2), card=smi)


def serve_main():
    """``chip_smoke.py --serve``: the card line and the serve phases alone."""
    smi = phase_card()
    phase_serve(smi)
    phase_serve_variants(smi)
    print(smi, flush=True)


class _Clock:
    """Seconds between marks, by the name of the phases each span ran."""

    def __init__(self):
        self.t, self.spans = time.perf_counter(), {}

    def mark(self, name):
        now = time.perf_counter()
        self.spans[name] = round(now - self.t, 2)
        self.t = now


def main():
    clock = _Clock()
    smi = phase_card()
    phase_build()
    clock.mark("build")
    errs = phase_kernels()
    errs.update(phase_kernels_long())
    errs.update(phase_head_dims())
    errs.update(phase_head_dims_above_256())
    phase_pipe_head_dims()
    clock.mark("kernels")
    main_runs = {path: phase_main(smi, path) for path in ("dp", "tp", "long")}
    by_path = {path: run[0] for path, run in main_runs.items()}
    by_path["wide"] = phase_wide(smi)
    cli_runs = phase_cli_head_dims()
    d512 = phase_d512(smi)
    pipeline = phase_pipeline(smi, {p: main_runs[p][1:] for p in ("dp", "tp")})
    clock.mark("main_paths")
    phase_train_dir(smi)
    with _seq_text() as text:
        phase_seq_parallel(smi, text, long_base=main_runs["long"][1])
        clock.mark("seq_parallel")
        phase_train_dir_modes(smi, text)
    clock.mark("train_dir")
    phase_serve(smi)
    clock.mark("serve")
    phase_serve_variants(smi)
    clock.mark("serve_variants")
    # A kernel's launches are those of the first path of by_path it serves
    # (`d512`'s launches run the column-group sources and go to their own
    # rows); the record lists every path's, and the routes phase's for the
    # kernels no such path takes (K5/K6 at head_dim 128 run only where no q
    # segmentation exists, K7 only under flash_attention_bshd).
    launches = {k: next((c[k] for c in by_path.values() if k in c), 0)
                for k in A.KERNEL_LAUNCHES}
    notes = {k: {"launches_by_path": {p: c[k] for p, c in by_path.items() if k in c}}
             for k in A.KERNEL_LAUNCHES}
    # Rows of their own: K1 with rope on the long path, K1 with rope and K8
    # on `wide`, and K1/K2 at head_dim 256 and 32 — the launches of the
    # trainer's runs at d_model 1024 over 4 heads and at its defaults (phase
    # 4, CLI_LAYERS layers x CLI_STEPS steps).
    rows = {"flash_fwd_rope": ("long", "flash_fwd"),
            "flash_fwd_rope_d256_wide": ("wide", "flash_fwd"),
            "bshd_bwd_d256_wide": ("wide", "bshd_bwd")}
    for name, (path, counter) in rows.items():
        launches[name] = by_path[path][counter]
        notes[name] = {"launches_by_path": {path: launches[name]}}
    for name in ("flash_fwd_rope", "flash_fwd_rope_d256_wide"):
        notes[name]["library_call"] = "SDPA forward on q and k rotated beforehand"
    notes["bshd_bwd_d256_wide"].update(
        call="the last of the path's eight q segments a layer",
        library_call="SDPA forward+backward on q and k rotated beforehand, lower-right causal")
    for tag, run in (("d256", "cli_d256"), ("d32", "cli_defaults_d32")):
        for name, counter in ((f"flash_fwd_{tag}", "flash_fwd"), (f"flash_bwd_{tag}", "flash_bwd")):
            launches[name] = cli_runs[run][counter]
            notes[name] = {"launches_by_path": {run: launches[name]}}
    # The rows above 256: `d512`'s K1, K5 and K6 launches, with the errors
    # of phase 3's check at the path's call; K2 at 512, K8 and K1 at 320 and
    # K5 at 256 run on no path of this script.
    for name, counter in (("flash_fwd_d512", "flash_fwd"), ("bwd_dq_d512", "bwd_dq"),
                          ("bwd_dkv_d512", "bwd_dkv")):
        launches[name] = d512[counter]
        notes[name] = {"launches_by_path": {"d512": launches[name]},
                       "max_abs_err_call": "the d512 path's: B 12, S 2048, 4 heads of 512"}
    for name, where in (("flash_bwd_d512", "the fused backward at head_dim 512: the gate's "
                                           "route for sequences up to 819 rows"),
                        ("bshd_bwd_d320", "K8 at head_dim 320: the gate's route at seq 2048 "
                                          "and 8192"),
                        ("bwd_dq_d256", "K5 at head_dim 256: the two-pass route only"),
                        ("bwd_dkv_d384", "K6 at head_dim 384: the two-pass route only, where "
                                         "the gate finds no q segmentation"),
                        ("bwd_dq_d384", "K5 at head_dim 384: the two-pass route only, where "
                                        "the gate finds no q segmentation"),
                        ("flash_fwd_d320", "K1 at head_dim 320 (padded to 384): the trainer "
                                           "at --d_model 1280 --num_heads 4")):
        launches[name] = 0
        notes[name] = {"launches_note": f"0 on every path driven here; {where}"}
    # pp, 3d and remat run the dp/tp kernels at other launch counts: listed
    # beside their paths (each row's launches stay its first path's).
    for run, counts in pipeline.items():
        for k, n in counts.items():
            notes[k]["launches_by_path"][run] = n
    for name, route_launches in phase_routes().items():
        for k in ("bshd_fwd", "bwd_dq", "bwd_dkv"):
            if k in route_launches:
                notes[k]["launches_by_route"] = {name: route_launches[k]}
    for k in ("bwd_dq", "bwd_dkv"):
        notes[k]["library_call"] = "SDPA backward alone (all three gradients)"
    clock.mark("routes")
    phase_parity()
    phase_parity_wide()
    clock.mark("parity")
    phase_turns(notes)
    d32_device_times(notes)
    phase_host_dispatch(notes)
    clock.mark("turns_dispatch")
    kernels = phase_timing(launches, errs, notes) + phase_timing_long(launches, errs, notes)
    kernels += phase_timing_wide(launches, errs, notes)
    kernels += phase_timing_dstream(launches, errs, notes)
    clock.mark("timing")
    kernels += phase_probes()
    clock.mark("probes")
    for path in MAIN_PATHS:
        phase_profile(path)
    clock.mark("profile")
    emit(phase="seconds", **clock.spans)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if "--dispatch" in sys.argv:
        dispatch_main(TREE)
    elif "--serve" in sys.argv:
        serve_main()
    elif "--seq" in sys.argv:
        seq_main()
    elif "--spread" in sys.argv:
        spread_main()
    else:
        main()
