"""Run the tp, dp, pp, 3d, sp and sp_tp trainers on one card and across the
cards of one host, and compare.

    python -m distributed_tensorflow_tpu_torch.cli.tp_cards [--cards 4] [--only pp,3d]
        [trainer flags]
    python -m distributed_tensorflow_tpu_torch.cli.tp_cards --only sp [the long recipe's flags]

Runs of ``cli/train_lm.py`` with the same flags, seed and global batch
(default: the bench flagship, 6 steps). tp: ``--parallelism tp
--model_parallel 1`` on one card, then under ``torchrun --standalone
--nproc_per_node N`` with ``--model_parallel N`` and with
``--model_parallel N/2`` (data 2 x model N/2). dp: ``--parallelism dp`` on
one card, then under the same ``torchrun`` over N cards (each rank its rows
of the batch, the gradients averaged in one all-reduce). pp: N pipeline
stages (``--model_parallel N --num_microbatches N``) against the one-card
dp run. 3d: data 1 x pipe 2 x model N/2 (``--pipeline_parallel 2
--model_parallel N/2``) against the one-card tp run. sp: the sequence over N
cards (``--model_parallel N``, ring attention) against the one-card dp run.
sp_tp: data 1 x seq 2 x model N/2 (``--pipeline_parallel 2
--model_parallel N/2``) against the one-card tp run. Every split trains the
same whole model, so its losses must agree with its one-card run's up to
bf16 rounding (relative ``LOSS_TOL``). ``--only`` runs the named modes and
the one-card runs they are held against. Prints each run's command and its
chief's JSON records, then one summary line; exits non-zero when a run
fails or the losses disagree. The summary names the cards as
``nvidia-smi --query-gpu=name,power.limit`` gives them.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys

import torch

FLAGSHIP = [
    "--attention", "flash", "--d_model", "2048", "--num_heads", "16", "--num_layers", "8",
    "--d_ff", "8192", "--seq_len", "2048", "--batch_size", "12", "--use_bias", "0",
    "--training_steps", "6", "--eval_step_interval", "2",
]
TRAINER = ["-m", "distributed_tensorflow_tpu_torch.cli.train_lm"]
LOSS_TOL = 1e-2  # bf16 compute: splits sum partial products in other orders
MODES = ("tp", "dp", "pp", "3d", "sp", "sp_tp")


def run(cmd: list[str]) -> list[dict]:
    print(json.dumps({"command": " ".join(cmd)}), flush=True)
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=1200)
    if res.returncode != 0:
        sys.exit(f"tp_cards: {' '.join(cmd)} exited {res.returncode}\n{res.stderr[-4000:]}")
    records = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    for r in records:
        print(json.dumps(r), flush=True)
    return records


def nvidia_smi() -> list[str]:
    """Each card's name and power limit, or [] where there is no nvidia-smi."""
    if shutil.which("nvidia-smi") is None:
        return []
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, default=torch.cuda.device_count())
    p.add_argument("--only", default=",".join(MODES),
                   help="comma-separated modes to run, each with its one-card run")
    args, flags = p.parse_known_args(argv)
    if args.cards < 2 or args.cards % 2:
        sys.exit(f"tp_cards: needs an even number of cards >= 2, got {args.cards}")
    modes = args.only.split(",")
    if set(modes) - set(MODES):
        sys.exit(f"tp_cards: --only takes modes of {MODES}, got {args.only}")
    flags = flags or FLAGSHIP
    n, half = str(args.cards), str(args.cards // 2)
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", n]
    trainer = lambda mode: [*TRAINER, "--parallelism", mode, *flags]  # noqa: E731
    # Each run and the one-card run of its mode that it is held against.
    runs = {}
    if {"tp", "3d", "sp_tp"} & set(modes):
        runs["tp1_one_card"] = (run([sys.executable, *trainer("tp"), "--model_parallel", "1"]),
                                "tp1_one_card")
    if "tp" in modes:
        runs[f"tp{n}"] = (run([*torchrun, *trainer("tp"), "--model_parallel", n]),
                          "tp1_one_card")
        runs[f"data2_tp{half}"] = (run([*torchrun, *trainer("tp"), "--model_parallel", half]),
                                   "tp1_one_card")
    if {"dp", "pp", "sp"} & set(modes):
        runs["dp1_one_card"] = (run([sys.executable, *trainer("dp")]), "dp1_one_card")
    if "dp" in modes:
        runs[f"dp{n}"] = (run([*torchrun, *trainer("dp")]), "dp1_one_card")
    if "pp" in modes:
        runs[f"pp{n}"] = (run([*torchrun, *trainer("pp"), "--model_parallel", n,
                               "--num_microbatches", n]), "dp1_one_card")
    if "3d" in modes:
        runs[f"3d_pipe2_tp{half}"] = (run([*torchrun, *trainer("3d"), "--pipeline_parallel",
                                           "2", "--model_parallel", half]), "tp1_one_card")
    if "sp" in modes:
        runs[f"sp{n}"] = (run([*torchrun, *trainer("sp"), "--model_parallel", n]),
                          "dp1_one_card")
    if "sp_tp" in modes:
        runs[f"sp_tp_seq2_tp{half}"] = (run([*torchrun, *trainer("sp_tp"), "--pipeline_parallel",
                                             "2", "--model_parallel", half]), "tp1_one_card")
    summary = {"cards": args.cards, "nvidia_smi": nvidia_smi()}
    ok = True
    for name, (records, base_name) in runs.items():
        base = [r["loss"] for r in runs[base_name][0]]
        losses = [r["loss"] for r in records]
        worst = max(abs(a - b) / abs(b) for a, b in zip(losses, base)) if losses else None
        agree = len(losses) == len(base) and worst is not None and worst <= LOSS_TOL
        ok &= agree
        last = records[-1] if records else {}
        summary[name] = {"losses": losses, "against": base_name, "loss_rel_diff": worst,
                         "agree": agree,
                         **{k: last.get(k) for k in ("steps_per_sec", "tokens_per_sec", "mfu")}}
    summary["ok"] = ok
    print(json.dumps(summary), flush=True)
    if not ok:
        sys.exit("tp_cards: the splits' losses disagree")


if __name__ == "__main__":
    main()
