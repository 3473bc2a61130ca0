"""Dataclass configs + argparse front-end for the serving CLI.

This package's copy of the part of ``distributed_tensorflow_tpu/config.py``
that ``cli/serve_lm.py`` reads: the dataclass-to-flags helpers and
``ServeConfig``'s fields for the port's serving core, with the JAX
package's names, defaults and help texts. Fields of later slices
(speculation, quantization, tp, handoff roles, SLO and obs output) are not
here; ``cli/serve_lm.py`` refuses their flags.
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
    prefill_chunk_tokens: int = field(
        default=0,
        metadata={"help": "chunked-prefill budget per engine iteration (paged layout); "
                          "0 = auto (prefill_len), -1 = off (prefill_len stays a hard "
                          "prompt cap)"},
    )

    @property
    def lane_weight_tuple(self) -> tuple:
        return tuple(int(w) for w in self.lane_weights.split(","))

    @property
    def engine_page_size(self) -> int | None:
        """``page_size`` for SlotEngine: None = auto, 0 = monolithic."""
        return None if self.page_size < 0 else self.page_size
