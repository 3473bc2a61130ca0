"""Transformer-LM training CLI — the port of ``tools/train_lm.py`` in its
``dp`` (data parallelism), ``tp`` (Megatron tensor parallelism), ``pp``
(GPipe pipeline parallelism), ``3d`` (data x pipe x model), ``sp``
(sequence parallelism, ring attention) and ``sp_tp`` (data x sequence x
tensor parallelism) modes.

    python -m distributed_tensorflow_tpu_torch.cli.train_lm \\
        --d_model 2048 --num_heads 16 --num_layers 8 --d_ff 8192 \\
        --seq_len 2048 --batch_size 12 --use_bias 0 --attention flash
    torchrun --nproc_per_node N -m distributed_tensorflow_tpu_torch.cli.train_lm \\
        --parallelism dp --attention flash ...
    torchrun --nproc_per_node N -m distributed_tensorflow_tpu_torch.cli.train_lm \\
        --parallelism tp --model_parallel N --attention flash ...
    torchrun --nproc_per_node N -m distributed_tensorflow_tpu_torch.cli.train_lm \\
        --parallelism pp --model_parallel N --num_microbatches N --attention flash ...
    torchrun --nproc_per_node 4 -m distributed_tensorflow_tpu_torch.cli.train_lm \\
        --parallelism 3d --pipeline_parallel 2 --model_parallel 2 --attention flash ...
    torchrun --nproc_per_node 4 -m distributed_tensorflow_tpu_torch.cli.train_lm \\
        --parallelism sp --model_parallel 4 --seq_len 8192 ...
    torchrun --nproc_per_node 4 -m distributed_tensorflow_tpu_torch.cli.train_lm \\
        --parallelism sp_tp --pipeline_parallel 2 --model_parallel 2 ...

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
``--batch_size``. ``pp`` splits the layers into ``--model_parallel``
pipeline stages, as the JAX trainer does (the rest of the world is data
parallel), and runs ``--num_microbatches`` microbatches through them
(``parallel/pipeline_parallel.py``); ``3d`` runs ``--pipeline_parallel``
stages of ``--model_parallel``-way tensor-parallel blocks, data parallel
across the rest (``parallel/three_d.py``). ``sp`` splits the sequence
over ``--model_parallel`` ranks (the rest of the world is data parallel)
and attends by a ring over them (``parallel/sequence_parallel.py``,
``parallel/ring_attention.py``); ``sp_tp`` splits it over
``--pipeline_parallel`` ranks, with ``--model_parallel``-way tensor
parallelism inside each (``parallel/three_d.py``). In both the ring
replaces whatever ``--attention`` names, as in the JAX trainer, and runs
no flash kernel; ``--attention blockwise`` is the online softmax over key
blocks, also without one. After a run of more than one process, dp and sp
check that every rank holds bitwise-equal parameters. ``--remat``
recomputes each block on backward in every mode. Gradient clipping under
tp, pp, 3d and sp_tp is per rank, over what the rank holds, as in the JAX
step. Data:
``--text_file`` trains byte-level (vocab 256) on random windows of a file;
without it, the JAX trainer's synthetic copy task
from ``np.random.default_rng(seed)``. One JSON record per eval boundary,
printed by the chief (rank 0): step, loss, parallelism and, after the first
(warm-up) window, steps/s, tokens/s and MFU (over the peak of every rank's
card), timed over windows drained by ``torch.cuda.synchronize()``.

Checkpoints (``--train_dir``, ``train/checkpoint.py``), in every mode: before
the loop the newest committed step is restored (parameters, optimizer state, the
schedule's count and the global step) and training goes on from there;
the state is saved when ``--save_secs`` have passed (checked every step in
a world of one, at eval boundaries over a group) and always at the last
step. The chief also writes each boundary's loss, steps/s and MFU as
TensorBoard scalars there. A run resumed at its last step trains nothing
and returns NaN. With ``--text_file`` a resumed run draws the windows an
uninterrupted run would have drawn (they are keyed by step); the synthetic
copy task's generator restarts from ``--seed``, as in the JAX trainer.
pp and 3d save the stage-stacked tree (each stage's block written by the
rank that holds it), tp and sp_tp their tensor-parallel slices, dp and sp
the replicated parameters; a step resumes at any split that divides the
layers. ``--output`` exports the final parameters as an inference bundle
from the chief (not for tp, pp, 3d or sp_tp over several processes, whose
parameters are split across them), with the JAX trainer's metadata; pp and
3d export the stage-stacked tree the JAX trainer exports.
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
    p.add_argument("--parallelism", choices=("dp", "sp", "tp", "pp", "3d", "sp_tp"),
                   default="dp",
                   help="dp: data parallelism over every rank; sp: the sequence over "
                        "--model_parallel ranks (ring attention); tp: tensor parallelism over "
                        "--model_parallel ranks; pp: --model_parallel pipeline stages; 3d: "
                        "--pipeline_parallel stages of --model_parallel-way tp; sp_tp: the "
                        "sequence over --pipeline_parallel ranks, tp over --model_parallel; "
                        "data parallelism across the rest (ep and fsdp are not ported yet)")
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--pipeline_parallel", type=int, default=1,
                   help="size of the 'pipe' mesh axis: pipeline stages (3d) or "
                        "sequence shards (sp_tp)")
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
    p.add_argument("--attention", default="dense", choices=("dense", "blockwise", "flash"))
    p.add_argument("--remat", action="store_true",
                   help="rematerialise transformer blocks on backward (activation "
                        "memory O(L*S*d_model) instead of every intermediate)")
    p.add_argument("--num_microbatches", type=int, default=2, help="pp and 3d only")
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
        remat=args.remat,
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
        block = lambda t: t[rows]  # noqa: E731
        model, mesh = TransformerLM(cfg, seed=args.seed, device=device), None
        build_step = functools.partial(build_lm_train_step, group=dist.group.WORLD)
    else:
        from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh3

        # pp and sp take their stage or shard count from --model_parallel,
        # sp_tp its shard count from --pipeline_parallel, as the JAX trainer does.
        pipe, tp = {"tp": (1, args.model_parallel), "pp": (args.model_parallel, 1),
                    "3d": (args.pipeline_parallel, args.model_parallel),
                    "sp": (1, args.model_parallel),
                    "sp_tp": (args.pipeline_parallel, args.model_parallel)}[args.parallelism]
        mesh = make_mesh3(pipe, tp)
        if args.batch_size % mesh.data_size:
            raise ValueError(f"--batch_size {args.batch_size} does not split over "
                             f"{mesh.data_size} data-parallel ranks")
        per = args.batch_size // mesh.data_size
        rows = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)  # this rank's batch rows
        block = lambda t: t[rows]  # noqa: E731
        if args.parallelism in ("sp", "sp_tp"):
            from distributed_tensorflow_tpu_torch.parallel.sequence_parallel import shard_lm_batch

            seq_axis = "model" if args.parallelism == "sp" else "pipe"
            block = lambda t: shard_lm_batch(t, mesh, seq_axis)  # noqa: E731
        if args.parallelism == "sp":
            from distributed_tensorflow_tpu_torch.parallel.sequence_parallel import (
                build_lm_train_step as build_sp_lm_train_step,
                make_sp_model,
            )

            model = make_sp_model(cfg, mesh, seed=args.seed, device=device)
            build_step = functools.partial(build_sp_lm_train_step, mesh=mesh)
        elif args.parallelism == "sp_tp":
            from distributed_tensorflow_tpu_torch.parallel.three_d import (
                build_sp_tp_lm_train_step,
                make_sp_tp_model,
            )

            model = make_sp_tp_model(cfg, mesh, seed=args.seed, device=device)
            build_step = functools.partial(build_sp_tp_lm_train_step, mesh=mesh)
        elif args.parallelism == "tp":
            from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
                TpTransformerLM,
                build_tp_lm_train_step,
            )

            model = TpTransformerLM(cfg, mesh, seed=args.seed, device=device)
            build_step = functools.partial(build_tp_lm_train_step, mesh=mesh)
        elif args.parallelism == "pp":
            from distributed_tensorflow_tpu_torch.parallel.pipeline_parallel import (
                PipelineLM,
                build_pp_lm_train_step,
            )

            model = PipelineLM(cfg, mesh, seed=args.seed, device=device)
            build_step = functools.partial(build_pp_lm_train_step,
                                           num_microbatches=args.num_microbatches)
        else:
            from distributed_tensorflow_tpu_torch.parallel.three_d import (
                ThreeDLM,
                build_3d_lm_train_step,
            )

            model = ThreeDLM(cfg, mesh, seed=args.seed, device=device)
            build_step = functools.partial(build_3d_lm_train_step,
                                           num_microbatches=args.num_microbatches)
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
            # Every rank draws the same global batch and trains on its block.
            tokens = torch.from_numpy(np.ascontiguousarray(block(batch_for(i))))
            tokens = tokens.to(device, non_blocking=True)
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
    if args.parallelism in ("dp", "sp") and world > 1:
        # Replicated parameters: every rank must hold the same bits (the
        # JAX trainer's check after multi-process dp and sp).
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
    if world > 1 and args.parallelism not in ("dp", "sp"):
        print(
            f"skipping --output: {args.parallelism} params are sharded across "
            "processes (not addressable from the chief alone) — use "
            "--train_dir checkpoints, which save/restore cross-process "
            "shards natively",
            flush=True,
        )
        return
    from distributed_tensorflow_tpu_torch.models.convert import (
        pp_params_to_jax,
        transformer_params_to_jax,
    )
    from distributed_tensorflow_tpu_torch.train.checkpoint import export_inference_bundle

    if args.parallelism in ("pp", "3d"):
        params = pp_params_to_jax([model])  # a world of one: the one stage, stacked
    else:
        params = transformer_params_to_jax(model)
    export_inference_bundle(
        args.output,
        params,
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
