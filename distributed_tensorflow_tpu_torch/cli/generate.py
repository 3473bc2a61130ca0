"""Sample from a TransformerLM bundle — the port of ``tools/generate.py``.

Loads a bundle of either package (``train/checkpoint.py::load_lm_bundle``;
older bundles: pass the training shape flags), prefills the prompt in one
cached forward and samples greedily or with temperature / top-k / top-p
(``models/decoding.py::build_generate_fn``). It runs on the card in bf16
unless ``--device cpu`` is asked for (f32); with no card it raises. Greedy
tokens equal the JAX tool's on the same bundle; sampled tokens come from a
torch generator seeded by ``--seed``, not from ``jax.random``.

    python -m distributed_tensorflow_tpu_torch.cli.generate --model lm.msgpack \\
        --prompt 7,8,9,10 --max_new_tokens 16 [--device cpu]
    python -m distributed_tensorflow_tpu_torch.cli.generate --model lm.msgpack \\
        --text "Once upon" --temperature 0.8 --top_k 40 --seed 3
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="lm.msgpack")
    p.add_argument("--prompt", default="", help="comma-separated token ids")
    p.add_argument("--text", default="",
                   help="UTF-8 text prompt for byte-level (vocab 256) models; output is "
                        "decoded back to text")
    p.add_argument("--max_new_tokens", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_k", type=int, default=0,
                   help="sample from the k highest-probability tokens only (0 = no filter; "
                        "needs --temperature > 0)")
    p.add_argument("--top_p", type=float, default=0.0,
                   help="nucleus sampling: smallest token set with cumulative probability "
                        ">= p (0 = no filter; needs --temperature > 0)")
    p.add_argument("--kv_cache_dtype", default="", choices=("", "int8"),
                   help="int8 is not ported yet")
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--vocab_size", type=int, default=256)
    p.add_argument("--d_model", type=int, default=128)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--d_ff", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> np.ndarray:
    """Generate; prints the prompt and the output, returns the (1, P + N)
    tokens."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.kv_cache_dtype:
        parser.error(f"--kv_cache_dtype {args.kv_cache_dtype}: the int8 KV cache is not "
                     "ported yet")
    from distributed_tensorflow_tpu_torch.data.text import decode_tokens, encode_text
    from distributed_tensorflow_tpu_torch.models.decoding import build_generate_fn
    from distributed_tensorflow_tpu_torch.train.checkpoint import load_lm_bundle
    from distributed_tensorflow_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    try:
        cfg, model, _ = load_lm_bundle(
            args.model,
            fallback_shapes={"vocab_size": args.vocab_size, "d_model": args.d_model,
                             "num_heads": args.num_heads, "num_layers": args.num_layers,
                             "d_ff": args.d_ff, "max_seq_len": args.seq_len},
            device=device,
        )
    except ValueError as e:
        sys.exit(str(e))

    if args.text:
        if cfg.vocab_size != 256:
            sys.exit(f"--text needs a byte-level model (vocab exactly 256); bundle has vocab "
                     f"{cfg.vocab_size} — ids outside 0-255 would alias to wrong bytes")
        prompt = encode_text(args.text).astype(np.int32)[None]
        if prompt.shape[1] == 0:
            sys.exit("--text encoded to zero bytes")
    elif args.prompt:
        prompt = np.asarray([[int(t) for t in args.prompt.split(",")]], np.int32)
        bad = prompt[(prompt < 0) | (prompt >= cfg.vocab_size)]
        if bad.size:
            sys.exit(f"prompt ids {sorted(set(bad.tolist()))} outside [0, {cfg.vocab_size}) — "
                     "the embedding would silently clamp them")
    else:
        prompt = np.random.default_rng(args.seed).integers(2, cfg.vocab_size, (1, 8),
                                                           dtype=np.int32)

    gen = build_generate_fn(cfg, args.max_new_tokens, temperature=args.temperature,
                            top_k=args.top_k or None, top_p=args.top_p or None)
    out = gen(model, prompt, torch.Generator().manual_seed(args.seed)).cpu().numpy()
    if args.text:
        print("prompt :", args.text)
        print("output :", decode_tokens(out[0]))
    else:
        print("prompt :", ",".join(map(str, prompt[0])))
        print("output :", ",".join(map(str, out[0])))
    return out


if __name__ == "__main__":
    main()
