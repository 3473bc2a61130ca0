"""Export a weight-quantized serving bundle from a TransformerLM bundle —
the port of ``tools/quantize_lm.py``.

Post-training weight-only quantization (``models/quant.py``): the matmul
kernels become int8 (symmetric per output channel) or int4 (group-wise
along the reduction axis, nibble-packed); embeddings, norms, biases and
``lm_head`` stay high precision (bf16 by default). The bundle's metadata
carries ``weight_dtype``/``quant_group_size`` (and ``kv_cache_dtype`` with
``--kv_dtype int8``), so either package's ``load_lm_bundle`` rebuilds the
quantized model; its bytes equal the JAX tool's on the same input. The work
is host numpy on the bundle's tree: no device is used.

The drafter is quantized harder than the target (int4): its rounding only
costs acceptance, never output quality.

    python -m distributed_tensorflow_tpu_torch.cli.quantize_lm --model lm.msgpack \\
        --out lm.int8.msgpack --mode int8
    python -m distributed_tensorflow_tpu_torch.cli.quantize_lm --model lm.msgpack \\
        --out lm.int8.msgpack --draft_model draft.msgpack --draft_out draft.int4.msgpack
    python -m distributed_tensorflow_tpu_torch.cli.serve_lm --model lm.int8.msgpack \\
        --spec_k 4 --draft_model draft.int4.msgpack
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _config_meta(cfg, mode, group_size, kv_dtype=""):
    """The metadata ``config`` dict ``load_lm_bundle`` reads: every shape key
    and the quantization mode (``kv_dtype`` stamps the KV format)."""
    return {
        **({"kv_cache_dtype": kv_dtype} if kv_dtype else {}),
        "vocab_size": int(cfg.vocab_size),
        "d_model": int(cfg.d_model),
        "num_heads": int(cfg.num_heads),
        "num_kv_heads": int(cfg.num_kv_heads or 0),
        "attention_window": int(cfg.attention_window or 0),
        "use_bias": int(cfg.use_bias),
        "rope": int(cfg.position == "rope"),
        "rope_theta": float(cfg.rope_theta),
        "num_layers": int(cfg.num_layers),
        "d_ff": int(cfg.d_ff),
        "max_seq_len": int(cfg.max_seq_len),
        "weight_dtype": mode,
        "quant_group_size": int(group_size),
    }


def quantize_bundle(src, dst, mode, group_size, hp_dtype_name="bfloat16", kv_dtype=""):
    """Read ``src``, quantize, write ``dst``; returns (orig bytes, new bytes)
    of the trees."""
    from distributed_tensorflow_tpu_torch.models.quant import (
        quantize_lm_params,
        tree_bytes,
        validate_weight_quant,
    )
    from distributed_tensorflow_tpu_torch.parallel.pipeline_parallel import unstack_stage_params
    from distributed_tensorflow_tpu_torch.train.checkpoint import (
        export_inference_bundle,
        lm_config_from_meta,
        load_inference_bundle,
    )

    params, meta = load_inference_bundle(src)
    if "stages" in params:
        params = unstack_stage_params(params)
    cfg = lm_config_from_meta(meta)
    if cfg.weight_dtype:
        raise SystemExit(
            f"{src} is already quantized ({cfg.weight_dtype}) — quantize "
            "from the high-precision training bundle, not a quantized one "
            "(requantizing compounds rounding error)")
    validate_weight_quant(mode, group_size, int(cfg.d_model), int(cfg.d_ff))
    hp_dtype = "bfloat16" if hp_dtype_name == "bfloat16" else np.float32
    qparams = quantize_lm_params(params, mode, group_size=group_size, hp_dtype=hp_dtype)
    metadata = {k: v for k, v in meta.items() if k != "format"}
    metadata["config"] = _config_meta(cfg, mode, group_size, kv_dtype=kv_dtype)
    metadata["quantized_from"] = os.path.basename(src)
    export_inference_bundle(dst, qparams, metadata=metadata)
    return tree_bytes(params), tree_bytes(qparams)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", required=True, help="high-precision bundle to quantize (the target)")
    p.add_argument("--out", required=True, help="output path for the quantized target bundle")
    p.add_argument("--mode", default="int8", choices=("int8", "int4"), help="target weight dtype")
    p.add_argument("--group_size", type=int, default=0,
                   help="int4 group size along the reduction axis (default 64; ignored for int8)")
    p.add_argument("--hp_dtype", default="bfloat16", choices=("bfloat16", "float32"),
                   help="dtype for the high-precision leaves (embeddings/norms/lm_head)")
    p.add_argument("--kv_dtype", default="", choices=("", "int8"),
                   help="stamp the KV format into the metadata: 'int8' makes serve_lm default "
                        "to quantize-on-write int8 KV pages for this bundle")
    p.add_argument("--draft_model", default="",
                   help="optionally also quantize this draft bundle (harder: int4)")
    p.add_argument("--draft_out", default="", help="output path for the quantized draft bundle")
    p.add_argument("--draft_group_size", type=int, default=0,
                   help="int4 group size for the drafter (default: --group_size or 64)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    gs = args.group_size or (64 if args.mode == "int4" else 0)
    orig, new = quantize_bundle(args.model, args.out, args.mode, gs, args.hp_dtype,
                                kv_dtype=args.kv_dtype)
    print(f"quantize_lm: {args.model} -> {args.out} mode={args.mode} "
          f"group_size={gs} kv_dtype={args.kv_dtype or 'native'} "
          f"bytes {orig} -> {new} ({new / max(1, orig):.3f}x)", flush=True)
    if bool(args.draft_model) != bool(args.draft_out):
        raise SystemExit("--draft_model and --draft_out go together")
    if args.draft_model:
        dgs = args.draft_group_size or args.group_size or 64
        orig, new = quantize_bundle(args.draft_model, args.draft_out, "int4", dgs, args.hp_dtype)
        print(f"quantize_lm: {args.draft_model} -> {args.draft_out} "
              f"mode=int4 group_size={dgs} bytes {orig} -> {new} "
              f"({new / max(1, orig):.3f}x)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
