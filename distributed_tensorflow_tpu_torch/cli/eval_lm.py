"""Perplexity of an exported TransformerLM bundle on a text file — the port
of ``tools/eval_lm.py``.

    python -m distributed_tensorflow_tpu_torch.cli.eval_lm --model lm.msgpack \\
        --text_file corpus.txt [--device cpu]

Sequential non-overlapping byte windows over the file's holdout tail (the
split ``cli/train_lm.py --text_file`` kept out of training; pass
``--holdout_fraction 0`` to score the whole file), the mean next-token NLL
summed exactly over every window, printed as one JSON line with the JAX
tool's keys. Bundles of either package load (``train/checkpoint.py::
load_lm_bundle``); the model runs dense attention, as the JAX tool builds
it from the bundle's metadata. It runs on the card in bf16 unless
``--device cpu`` is asked for (f32); with no card it raises.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="lm.msgpack")
    p.add_argument("--text_file", required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--holdout_fraction", type=float, default=0.05,
                   help="score only this tail fraction (match the training flag); 0 scores "
                        "the whole file")
    # Shape fallbacks for bundles predating embedded config metadata.
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--d_model", type=int, default=128)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--d_ff", type=int, default=512)
    p.add_argument("--vocab_size", type=int, default=256)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> float:
    """Score the file; returns the mean NLL per byte."""
    args = build_parser().parse_args(argv)
    from distributed_tensorflow_tpu_torch.data.text import ByteTextDataset, load_byte_tokens
    from distributed_tensorflow_tpu_torch.train.checkpoint import load_lm_bundle
    from distributed_tensorflow_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    try:
        cfg, model, _ = load_lm_bundle(
            args.model,
            fallback_shapes={"d_model": args.d_model, "num_heads": args.num_heads,
                             "num_layers": args.num_layers, "d_ff": args.d_ff,
                             "max_seq_len": args.seq_len, "vocab_size": args.vocab_size},
            device=device,
        )
    except ValueError as e:
        sys.exit(str(e))

    tokens = load_byte_tokens(args.text_file)
    data = ByteTextDataset(tokens, cfg.max_seq_len, holdout_fraction=args.holdout_fraction)
    if args.holdout_fraction == 0:
        data.eval_tokens = tokens  # score the whole file

    total, count = 0.0, 0
    with torch.no_grad():
        for batch in data.eval_batches(args.batch_size):
            ids = torch.from_numpy(batch).to(device)
            lp = torch.log_softmax(model(ids)[:, :-1], dim=-1)
            nll = -lp.gather(-1, ids[:, 1:, None].long())[..., 0]
            total += float(nll.sum())
            count += nll.numel()
    if count == 0:
        sys.exit("holdout too short for one eval batch — lower --batch_size or "
                 "--holdout_fraction")
    mean_nll = total / count
    print(json.dumps({
        "text_file": args.text_file,
        "tokens_scored": count,
        "nll_per_byte": round(mean_nll, 4),
        "perplexity": round(float(np.exp(mean_nll)), 4),
        "bits_per_byte": round(mean_nll / np.log(2), 4),
    }), flush=True)
    return mean_nll


if __name__ == "__main__":
    main()
