"""Transformer-LM training CLI — the port of ``tools/train_lm.py`` in its
``dp`` mode (data parallelism) and ``tp`` mode (Megatron tensor
parallelism).

    python -m distributed_tensorflow_tpu_torch.cli.train_lm \\
        --d_model 2048 --num_heads 16 --num_layers 8 --d_ff 8192 \\
        --seq_len 2048 --batch_size 12 --use_bias 0 --attention flash
    torchrun --nproc_per_node N -m distributed_tensorflow_tpu_torch.cli.train_lm \\
        --parallelism dp --attention flash ...
    torchrun --nproc_per_node N -m distributed_tensorflow_tpu_torch.cli.train_lm \\
        --parallelism tp --model_parallel N --attention flash ...

Flags keep the JAX trainer's names and defaults. It runs on the card
(``--device cuda``, the default) in bf16, or on the CPU in f32 when asked
with ``--device cpu``; with no card it raises rather than fall back. Both
modes join a process group (``parallel/distributed.py``: ``torchrun``'s
environment, else ``--worker_hosts``/``--task_index``, else a world of one
in-process). ``dp`` gives each rank its rows of the global ``--batch_size``
and averages the loss and gradients over the world in one all-reduce (none
in a world of one); after training in a world of more than one it checks
that every rank holds bitwise-equal parameters, as the JAX trainer does.
``tp`` splits the world into data x model groups of ``--model_parallel``
ranks and gives each data group's ranks their slice of the global
``--batch_size``. Data: ``--text_file`` trains byte-level (vocab 256) on
random windows of a file; without it, the JAX trainer's synthetic copy task
from ``np.random.default_rng(seed)``. One JSON record per eval boundary,
printed by the chief (rank 0): step, loss, parallelism and, after the first
(warm-up) window, steps/s, tokens/s and MFU (over the peak of every rank's
card), timed over windows drained by ``torch.cuda.synchronize()``.

Checkpoints (``--train_dir``, ``train/checkpoint.py``): before the loop the
newest committed step is restored (parameters, optimizer state, the
schedule's count and the global step) and training goes on from there;
the state is saved when ``--save_secs`` have passed (checked every step in
a world of one, at eval boundaries over a group) and always at the last
step. The chief also writes each boundary's loss, steps/s and MFU as
TensorBoard scalars there. A run resumed at its last step trains nothing
and returns NaN. With ``--text_file`` a resumed run draws the windows an
uninterrupted run would have drawn (they are keyed by step); the synthetic
copy task's generator restarts from ``--seed``, as in the JAX trainer.
``--output`` exports the final parameters as an inference bundle from the
chief (not for tp over several processes, whose parameters are split
across them), with the JAX trainer's metadata.
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np
import torch


def synthetic_tokens(rng, batch, seq_len, vocab):
    """Copy task: the second half repeats the first half."""
    half = seq_len // 2
    first = rng.integers(2, vocab, (batch, half))
    return np.concatenate([first, first], axis=1).astype(np.int32)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parallelism", choices=("dp", "tp"), default="dp",
                   help="dp: data parallelism over every rank; tp: tensor parallelism over "
                        "--model_parallel ranks, data parallelism across the rest (other "
                        "modes are not ported yet)")
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--training_steps", type=int, default=100)
    p.add_argument("--eval_step_interval", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--text_file", default="",
                   help="train byte-level (vocab 256) on this file instead of the "
                        "synthetic copy task")
    p.add_argument("--holdout_fraction", type=float, default=0.05)
    p.add_argument("--vocab_size", type=int, default=256)
    p.add_argument("--d_model", type=int, default=128)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_kv_heads", type=int, default=0,
                   help="grouped-query attention kv heads (0 = multi-head)")
    p.add_argument("--attention_window", type=int, default=0,
                   help="sliding-window causal attention width (0 = full causal)")
    p.add_argument("--position", default="learned", choices=("learned", "rope"))
    p.add_argument("--rope_theta", type=float, default=10000.0)
    p.add_argument("--use_bias", type=int, default=1, choices=(0, 1))
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--d_ff", type=int, default=512)
    p.add_argument("--learning_rate", type=float, default=3e-3)
    p.add_argument("--optimizer", default="adam",
                   choices=("adam", "adamw", "sgd", "momentum"))
    p.add_argument("--lr_schedule", default="constant",
                   choices=("constant", "cosine", "warmup_cosine", "linear"))
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--grad_clip_norm", type=float, default=0.0)
    p.add_argument("--attention", default="dense", choices=("dense", "flash"))
    p.add_argument("--output", default="", help="optional params bundle path")
    p.add_argument("--train_dir", default="",
                   help="checkpoint dir: timed autosave + resume")
    p.add_argument("--save_secs", type=int, default=600)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # Reference-style cluster flags: worker_hosts[0] is the rendezvous,
    # task_index this process's rank (torchrun's environment wins).
    p.add_argument("--worker_hosts", default="localhost:12355")
    p.add_argument("--task_index", type=int, default=0)
    return p


def main(argv=None) -> float:
    """Train; returns the last step's loss."""
    args = build_parser().parse_args(argv)

    from distributed_tensorflow_tpu_torch.utils.device import resolve_device

    from distributed_tensorflow_tpu_torch.parallel.distributed import process_group

    with process_group(resolve_device(args.device), args.worker_hosts, args.task_index) as c:
        return _train(args, c.device, c)


def _train(args, device, cluster) -> float:
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from distributed_tensorflow_tpu_torch.parallel.data_parallel import build_lm_train_step
    from distributed_tensorflow_tpu_torch.train.optimizers import make_optimizer
    from distributed_tensorflow_tpu_torch.utils.device import compute_dtype
    from distributed_tensorflow_tpu_torch.utils.flops import (
        chip_peak_flops,
        transformer_train_flops,
    )
    from distributed_tensorflow_tpu_torch.utils.timer import StepTimer

    text_data = None
    if args.text_file:
        from distributed_tensorflow_tpu_torch.data.text import ByteTextDataset, load_byte_tokens

        text_data = ByteTextDataset(load_byte_tokens(args.text_file), args.seq_len,
                                    holdout_fraction=args.holdout_fraction, seed=args.seed)
        args.vocab_size = 256

    cfg = TransformerConfig(
        vocab_size=args.vocab_size,
        d_model=args.d_model,
        num_heads=args.num_heads,
        num_kv_heads=args.num_kv_heads or None,
        attention_window=args.attention_window or None,
        use_bias=bool(args.use_bias),
        position=args.position,
        rope_theta=args.rope_theta,
        num_layers=args.num_layers,
        d_ff=args.d_ff,
        max_seq_len=args.seq_len,
        attention=args.attention,
        compute_dtype=compute_dtype(device),
    )
    world, chief = cluster.world_size, cluster.is_chief
    if args.parallelism == "dp":
        import torch.distributed as dist

        if args.batch_size % world:
            raise ValueError(f"--batch_size {args.batch_size} does not split over {world} "
                             f"data-parallel ranks")
        per = args.batch_size // world
        rows = slice(cluster.rank * per, (cluster.rank + 1) * per)  # this rank's batch rows
        model, mesh = TransformerLM(cfg, seed=args.seed, device=device), None
        build_step = functools.partial(build_lm_train_step, group=dist.group.WORLD)
    else:
        from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh
        from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
            TpTransformerLM,
            build_tp_lm_train_step,
        )

        mesh = make_mesh(args.model_parallel)
        if args.batch_size % mesh.data_size:
            raise ValueError(f"--batch_size {args.batch_size} does not split over "
                             f"{mesh.data_size} data-parallel ranks")
        per = args.batch_size // mesh.data_size
        rows = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)  # this rank's batch rows
        model = TpTransformerLM(cfg, mesh, seed=args.seed, device=device)
        build_step = functools.partial(build_tp_lm_train_step, mesh=mesh)
    opt = make_optimizer(
        args.optimizer, model.parameters(), args.learning_rate,
        total_steps=args.training_steps, schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps, grad_clip_norm=args.grad_clip_norm,
    )
    step = build_step(model, opt)
    rng = np.random.default_rng(args.seed)

    ckpt, start = None, 0
    if args.train_dir:
        from distributed_tensorflow_tpu_torch.train.checkpoint import (
            CheckpointManager,
            coordinated_maybe_save,
            restore_train_state,
            train_state,
        )

        ckpt = CheckpointManager(args.train_dir, save_interval_secs=args.save_secs)
        restored = ckpt.restore_latest()
        if restored is not None:
            start = restore_train_state(*restored, model, opt, mesh)
            if chief:
                print(f"restored checkpoint at step {restored[0]} from {args.train_dir}",
                      flush=True)

    def batch_for(i):
        if text_data is not None:
            return text_data.train_batch(args.batch_size, step=i)
        return synthetic_tokens(rng, args.batch_size, args.seq_len, args.vocab_size)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    peak = chip_peak_flops(device)
    flops = transformer_train_flops(cfg, args.batch_size)
    timer = StepTimer(warmup_steps=2)
    timer.start(start)
    loss = float("nan")  # a run resumed at its last step trains nothing
    writer = None
    if args.train_dir and chief:
        from distributed_tensorflow_tpu_torch.utils.summary import SummaryWriter

        writer = SummaryWriter(args.train_dir)
    try:
        for i in range(start, args.training_steps):
            # Every rank draws the same global batch and trains on its rows.
            tokens = torch.from_numpy(batch_for(i)[rows]).to(device, non_blocking=True)
            m = step(tokens)
            i_end = i + 1
            boundary = i_end % args.eval_step_interval == 0 or i_end == args.training_steps
            if boundary:
                sync()  # completion barrier: the window holds finished work only
                timer.tick_to(i_end)
                loss = float(m["loss"])
                record = {"step": i_end, "loss": round(loss, 4),
                          "parallelism": args.parallelism}
                scalars = {"loss": loss}
                if timer.steps_per_sec > 0:  # the first drained window is warm-up
                    record["steps_per_sec"] = round(timer.steps_per_sec, 2)
                    record["tokens_per_sec"] = round(
                        timer.steps_per_sec * args.batch_size * args.seq_len, 0
                    )
                    scalars["steps_per_sec"] = timer.steps_per_sec
                    if peak is not None:
                        record["mfu"] = scalars["mfu"] = round(
                            flops * timer.steps_per_sec / (peak * world), 4)
                if writer is not None:
                    writer.add_scalars(scalars, i_end)
                if chief:
                    print(json.dumps(record), flush=True)
            saved = ckpt is not None and coordinated_maybe_save(
                ckpt, i_end, lambda: train_state(model, opt, i_end, mesh), is_chief=chief,
                force=i_end == args.training_steps, at_boundary=boundary,
            )
            if boundary or saved:
                # Boundary and save work stay out of the next window.
                timer.mark(i_end)
    finally:
        if writer is not None:
            writer.close()
    if args.parallelism == "dp" and world > 1:
        # Replicated parameters: every rank must hold the same bits (the
        # JAX trainer's check after multi-process dp).
        from distributed_tensorflow_tpu_torch.parallel.consistency import (
            check_cross_process_consistency,
        )

        check_cross_process_consistency(model)
    if args.output and chief:
        _export(args, cfg, model, world)
    return loss


def _export(args, cfg, model, world) -> None:
    """The chief's ``--output``: the bundle with the JAX trainer's metadata
    (enough to rebuild the config at load time)."""
    if world > 1 and args.parallelism == "tp":
        print(
            f"skipping --output: {args.parallelism} params are sharded across "
            "processes (not addressable from the chief alone) — use "
            "--train_dir checkpoints, which save/restore cross-process "
            "shards natively",
            flush=True,
        )
        return
    from distributed_tensorflow_tpu_torch.models.convert import transformer_params_to_jax
    from distributed_tensorflow_tpu_torch.train.checkpoint import export_inference_bundle

    export_inference_bundle(
        args.output,
        transformer_params_to_jax(model),
        metadata={
            "model": "TransformerLM",
            "parallelism": args.parallelism,
            "config": {
                "vocab_size": cfg.vocab_size,
                "d_model": cfg.d_model,
                "num_heads": cfg.num_heads,
                "num_kv_heads": cfg.num_kv_heads or 0,
                "attention_window": cfg.attention_window or 0,
                "use_bias": int(cfg.use_bias),
                "rope": int(cfg.position == "rope"),  # 0 = learned
                "rope_theta": float(cfg.rope_theta),
                "num_layers": cfg.num_layers,
                "d_ff": cfg.d_ff,
                "max_seq_len": cfg.max_seq_len,
            },
        },
    )
    print(f"exported {args.output}", flush=True)


if __name__ == "__main__":
    main()
