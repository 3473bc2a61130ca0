"""Serve a TransformerLM over HTTP with continuous batching — the port of
``tools/serve_lm.py``.

Loads a bundle of either package (``train/checkpoint.py::load_lm_bundle``)
or, with ``--demo``, weights drawn from seed 0; warms the slot engine up
(every program signature runs before the port opens); then runs the
``serve/`` stack: the lane scheduler on a background thread that owns the
engine and the card, the stdlib HTTP front end, and the serving metrics.
It runs on the card in bf16 unless ``--device cpu`` is asked for (f32);
with no card it raises.

    python -m distributed_tensorflow_tpu_torch.cli.serve_lm --model lm.msgpack \\
        --port 8000 --slots 8 [--device cpu]
    curl -s localhost:8000/generate -d '{"prompt": [7,8,9], "max_new_tokens": 16}'
    curl -s localhost:8000/generate -d '{"prompt": "Once", "stream": true}'  # SSE
    curl -s localhost:8000/healthz        # 200 serving / 503 shutting down
    curl -s localhost:8000/metrics        # Prometheus text exposition
    curl -s localhost:8000/metrics.json   # JSON summary snapshot

Byte-level models (vocab 256) also take ``{"prompt": "text"}`` and return
the decoded ``"text"`` beside the token ids. SIGTERM drains: ``/healthz``
turns 503, accepted work finishes (up to ``--drain_deadline_s``), then the
server stops. Flags of later slices (quantized weights, int8 KV,
speculation, tp, deploy, handoff roles, SLO rules, obs output) exit with a
message.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

import numpy as np

from distributed_tensorflow_tpu_torch.config import ServeConfig, add_dataclass_flags, from_args

# Flags of the JAX tool that later slices port: (flag, value that is still
# this slice's behaviour, or None when any use is refused).
_LATER = {
    "quant": ("", "weight-only quantization (models/quant.py)"),
    "weight_dtype": ("", "weight-only quantization (models/quant.py)"),
    "quant_group_size": (0, "weight-only quantization (models/quant.py)"),
    "kv_cache_dtype": ("", "the int8 KV cache"),
    "kv_dtype": (("", "bf16"), "the int8 KV cache"),
    "spec_k": (0, "speculative decoding"),
    "spec_branches": (1, "tree speculation"),
    "draft_model": ("", "the learned drafter"),
    "draft_window": (None, "the learned drafter"),
    "tp": (1, "the sharded engine (ShardedSlotEngine)"),
    "role": ("mixed", "disaggregated prefill/decode roles (handoff)"),
    "handoff_peers": (None, "disaggregated prefill/decode roles (handoff)"),
    "slo": (None, "SLO rules (obs/slo.py)"),
    "slo_interval_s": (None, "SLO rules (obs/slo.py)"),
    "obs_dir": (None, "the obs output directory"),
    "serve_log_dir": (None, "serving summaries (--serve_log_dir)"),
    "watch_dir": (None, "the deploy plane (hot swap, canaries, variants)"),
    "deploy_variant": (None, "the deploy plane (hot swap, canaries, variants)"),
    "canary_percent": (None, "the deploy plane (hot swap, canaries, variants)"),
    "canary_variant": (None, "the deploy plane (hot swap, canaries, variants)"),
}


class _ByteCodec:
    """String prompt <-> byte-level token ids for vocab-256 models."""

    def encode(self, text):
        from distributed_tensorflow_tpu_torch.data.text import encode_text

        return [int(t) for t in encode_text(text)]

    def decode(self, tokens):
        from distributed_tensorflow_tpu_torch.data.text import decode_tokens

        return decode_tokens(np.asarray(tokens, np.int32))


def build_stack(serve_cfg, cfg, model, deploy_cfg=None, *, prefill_buckets=()):
    """(engine, scheduler, metrics, http server) — warmed up, not started,
    on the model's device; ``prefill_buckets`` adds prefill widths below
    ``prefill_len`` (the engine's argument, which the CLI leaves empty). The recompile sentinel and the metrics ride
    along as ``server.sentinel`` / ``server.serving_metrics`` (the 4-tuple
    is the JAX tool's contract); ``server.slo_monitor``, ``variant_table``,
    ``swapper`` and ``watcher`` are None (not ported yet)."""
    from distributed_tensorflow_tpu_torch.obs.perf import RecompileSentinel
    from distributed_tensorflow_tpu_torch.serve.engine import SlotEngine
    from distributed_tensorflow_tpu_torch.serve.metrics import ServingMetrics
    from distributed_tensorflow_tpu_torch.serve.scheduler import Scheduler
    from distributed_tensorflow_tpu_torch.serve.server import make_server

    if deploy_cfg is not None:
        raise NotImplementedError("the deploy plane (hot swap, canaries, variants) is not "
                                  "ported yet")
    metrics = ServingMetrics()
    sentinel = RecompileSentinel(metrics.registry, use_listener=False)
    engine = SlotEngine(
        cfg,
        model,
        slots=serve_cfg.slots,
        max_len=serve_cfg.serve_max_len or None,
        prefill_len=serve_cfg.prefill_len or None,
        steps_per_sync=serve_cfg.steps_per_sync,
        sentinel=sentinel,
        page_size=serve_cfg.engine_page_size,
        kv_pages=serve_cfg.kv_pages,
        prefix_cache=serve_cfg.prefix_cache,
        prefill_buckets=tuple(prefill_buckets),
        prefill_chunk_tokens=serve_cfg.prefill_chunk_tokens,
        device=next(model.parameters()).device,
    )
    engine.warmup()
    scheduler = Scheduler(
        engine,
        max_queue_depth=serve_cfg.max_queue_depth,
        metrics=metrics,
        lane_weights=serve_cfg.lane_weight_tuple,
    )
    codec = _ByteCodec() if cfg.vocab_size == 256 else None
    server = make_server(scheduler, serve_cfg.host, serve_cfg.port,
                         request_timeout_s=serve_cfg.request_timeout_s, codec=codec)
    server.slo_monitor = None
    server.sentinel = sentinel
    server.serving_metrics = metrics
    server.variant_table = server.swapper = server.watcher = None
    return engine, scheduler, metrics, server


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="lm.msgpack")
    p.add_argument("--demo", action="store_true",
                   help="serve weights drawn from seed 0 (no bundle needed)")
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--vocab_size", type=int, default=256)
    p.add_argument("--d_model", type=int, default=128)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--d_ff", type=int, default=512)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_dataclass_flags(p, ServeConfig)
    for name in _LATER:
        p.add_argument("--" + name, default=None, help=argparse.SUPPRESS)
    return p


def parse_args(argv=None):
    """``(args, serve_cfg)``; exits naming the flag for any flag of a later
    slice set to something this slice does not do."""
    parser = build_parser()
    args = parser.parse_args(argv)
    for name, (keep, what) in _LATER.items():
        value = getattr(args, name)
        if value is None:
            continue
        allowed = keep if isinstance(keep, tuple) else (keep,)
        if keep is None or value not in tuple(str(a) for a in allowed):
            parser.error(f"--{name} {value}: {what} is not ported yet")
    return args, from_args(ServeConfig, args)


def main(argv=None):
    args, serve_cfg = parse_args(argv)

    from distributed_tensorflow_tpu_torch.utils.device import compute_dtype, resolve_device

    device = resolve_device(args.device)
    if args.demo:
        from distributed_tensorflow_tpu_torch.models.transformer import (
            TransformerConfig,
            TransformerLM,
        )

        cfg = TransformerConfig(vocab_size=args.vocab_size, d_model=args.d_model,
                                num_heads=args.num_heads, num_layers=args.num_layers,
                                d_ff=args.d_ff, max_seq_len=args.seq_len,
                                compute_dtype=compute_dtype(device))
        model = TransformerLM(cfg, seed=0, device=device)
    else:
        from distributed_tensorflow_tpu_torch.train.checkpoint import load_lm_bundle

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

    engine, scheduler, metrics, server = build_stack(serve_cfg, cfg, model)
    host, port = server.server_address
    kv_desc = (
        f"paged(page_size={engine.page_size} pages={engine.pool.num_pages} "
        f"prefix={'on' if engine.prefix is not None else 'off'} "
        f"kv_dtype={engine.kv_dtype} chunk={engine.prefill_chunk_tokens})"
        if engine.paged else "monolithic"
    )
    print(
        f"serving on http://{host}:{port}  slots={engine.slots} max_len={engine.max_len} "
        f"prefill_len={engine.prefill_len} kv={kv_desc} device={engine.device} "
        f"weights={engine.weight_dtype} role={scheduler.role} "
        f"compiled={engine.compile_count()}",
        flush=True,
    )
    scheduler.start()

    # SIGTERM = graceful drain: stop accepting (/healthz 503), keep serving
    # what was accepted, then stop when idle or at the drain deadline.
    def _on_sigterm(signum, frame):
        scheduler.begin_drain(serve_cfg.drain_deadline_s)
        print(f"serve_lm: SIGTERM — draining for up to {serve_cfg.drain_deadline_s}s",
              flush=True)

        def _finish():
            deadline = time.monotonic() + serve_cfg.drain_deadline_s
            while time.monotonic() < deadline and not scheduler.idle:
                time.sleep(0.05)
            server.shutdown()

        threading.Thread(target=_finish, name="serve-drain", daemon=True).start()

    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        scheduler.stop()
        print("serve_lm: shut down cleanly", flush=True)


if __name__ == "__main__":
    main()
