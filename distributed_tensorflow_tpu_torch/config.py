"""Dataclass configs + argparse front-end for the serving CLI.

This package's copy of the part of ``distributed_tensorflow_tpu/config.py``
that ``cli/serve_lm.py`` reads: the dataclass-to-flags helpers and
``ServeConfig``'s fields for the port's serving engine — the core,
speculation (``spec_k``, ``spec_branches``, ``draft_model``,
``draft_window``), weight quantization (``weight_dtype``,
``quant_group_size``) and the KV format (``kv_dtype``) — with the JAX
package's names, defaults, help texts and validation. Fields of later
slices (tp, handoff roles, SLO and obs output) are not here;
``cli/serve_lm.py`` refuses their flags.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Type, TypeVar

T = TypeVar("T")


def add_dataclass_flags(parser: argparse.ArgumentParser, cls: Type[Any]) -> None:
    """One ``--flag`` per dataclass field (bools as store_true)."""
    for f in dataclasses.fields(cls):
        name = "--" + f.name
        default = f.default if f.default is not dataclasses.MISSING else f.default_factory()  # type: ignore[misc]
        help_text = f.metadata.get("help", "")
        if f.type in ("bool", bool):
            parser.add_argument(name, action="store_true", default=default, help=help_text)
        else:
            ftype = {"int": int, "float": float, "str": str}.get(str(f.type), type(default))
            parser.add_argument(name, type=ftype, default=default, help=help_text)


def from_args(cls: Type[T], args: argparse.Namespace) -> T:
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vars(args).items() if k in names})


@dataclass
class ServeConfig:
    """Continuous-batching inference server (``serve/``,
    ``cli/serve_lm.py``): the slot count (batch capacity),
    ``steps_per_sync`` (decode micro-steps per engine round), the paged KV
    pool and its prefix cache, chunked prefill, and the admission pair
    ``max_queue_depth``/``request_timeout_s``."""

    host: str = field(default="127.0.0.1", metadata={"help": "bind address"})
    port: int = field(default=8000, metadata={"help": "bind port; 0 = ephemeral"})
    slots: int = field(default=4, metadata={"help": "concurrent request capacity (batch lanes)"})
    serve_max_len: int = field(
        default=0, metadata={"help": "per-slot KV capacity; 0 = model max_seq_len"})
    prefill_len: int = field(
        default=0, metadata={"help": "padded prompt capacity; 0 = serve_max_len // 2"})
    steps_per_sync: int = field(
        default=1,
        metadata={"help": "decode micro-steps per engine round (tokens are delivered in "
                          "bursts of this size)"},
    )
    max_queue_depth: int = field(
        default=64, metadata={"help": "queued requests beyond which submits shed (429)"})
    request_timeout_s: float = field(
        default=60.0, metadata={"help": "HTTP handler wait before a 503 timeout answer"})
    drain_deadline_s: float = field(
        default=10.0,
        metadata={"help": "SIGTERM grace: seconds the server keeps finishing accepted work "
                          "(healthz 503, no new submits) before hard stop"},
    )
    lane_weights: str = field(
        default="8,4,1",
        metadata={"help": "admissions per scheduling cycle for priority lanes 0 "
                          "(interactive), 1 (normal), 2 (batch) under contention"},
    )
    page_size: int = field(
        default=-1,
        metadata={"help": "KV page size in tokens: -1 = auto (16 when it divides "
                          "serve_max_len, else one whole-row page), 0 = monolithic per-slot "
                          "KV, >0 = explicit page size"},
    )
    kv_pages: int = field(
        default=0,
        metadata={"help": "physical KV pages in the paged pool; 0 = worst case "
                          "(slots * pages_per_slot + trash)"},
    )
    prefix_cache: bool = field(
        default=True,
        metadata={"help": "adopt shared-prefix KV pages copy-free (paged layout only)"},
    )
    spec_k: int = field(
        default=0,
        metadata={"help": "speculative drafts per verify round (paged layout); 0 disables. "
                          "Output is token-identical to plain decoding — this only changes "
                          "latency"},
    )
    spec_branches: int = field(
        default=1,
        metadata={"help": "draft-tree branches per speculative verify round (requires "
                          "spec_k > 0): 1 = linear drafts, N > 1 = a shared draft tree per "
                          "slot verified in one widened forward under a tree-attention mask"},
    )
    kv_dtype: str = field(
        default="",
        metadata={"help": "live KV-cache page format: '' = model default, 'bf16' = "
                          "compute-dtype rows (explicit native), 'int8' = quantize-on-write "
                          "int8 rows + per-row f32 scales with dequant fused on attend"},
    )
    prefill_chunk_tokens: int = field(
        default=0,
        metadata={"help": "chunked-prefill budget per engine iteration (paged layout); "
                          "0 = auto (prefill_len), -1 = off (prefill_len stays a hard "
                          "prompt cap)"},
    )
    draft_model: str = field(
        default="",
        metadata={"help": "path to a draft LM bundle replacing the n-gram drafter for "
                          "spec_k rounds (greedy output stays token-identical). Empty = "
                          "n-gram prompt-lookup drafting"},
    )
    draft_window: int = field(
        default=16,
        metadata={"help": "history suffix (tokens) the draft model conditions on per round; "
                          "clamped to the draft bundle's max_seq_len minus spec_k"},
    )
    weight_dtype: str = field(
        default="",
        metadata={"help": "weight-only quantization for serving: '' = the bundle's native "
                          "weights, 'int8' = symmetric per-channel, 'int4' = group-wise along "
                          "the input axis (needs quant_group_size). Embeddings/norms/lm_head "
                          "stay high-precision (models/quant.py)"},
    )
    quant_group_size: int = field(
        default=0,
        metadata={"help": "int4 scale-group size along the matmul input axis (even, dividing "
                          "d_model and d_ff — e.g. 32/64/128); must be 0 for '' / 'int8'"},
    )

    @property
    def lane_weight_tuple(self) -> tuple:
        return tuple(int(w) for w in self.lane_weights.split(","))

    @property
    def engine_page_size(self) -> int | None:
        """``page_size`` for SlotEngine: None = auto, 0 = monolithic."""
        return None if self.page_size < 0 else self.page_size

    def validate_kv(self) -> None:
        """Fail fast on a KV-format / speculation combination the engine
        would reject anyway, with the flag names in the message."""
        if self.kv_dtype not in ("", "bf16", "int8"):
            raise ValueError(f"kv_dtype must be '', 'bf16' or 'int8', got {self.kv_dtype!r}")
        if self.spec_branches < 1:
            raise ValueError(f"spec_branches must be >= 1, got {self.spec_branches}")
        if self.spec_branches > 1 and not self.spec_k:
            raise ValueError(
                "spec_branches > 1 requires spec_k > 0 (tree speculation widens the verify "
                "block; there is nothing to widen without drafts)")

    @property
    def engine_kv_cache_dtype(self):
        """``kv_dtype`` as ``TransformerConfig.kv_cache_dtype``: ``''`` keeps
        the bundle's own setting (the string ``'keep'``), ``'bf16'`` forces
        compute-dtype rows (None), ``'int8'`` quantize-on-write int8 pages."""
        if not self.kv_dtype:
            return "keep"
        return "int8" if self.kv_dtype == "int8" else None
