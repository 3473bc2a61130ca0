"""The recompile sentinel, in poll mode.

This package's copy of ``RecompileSentinel`` from
``distributed_tensorflow_tpu/obs/perf.py``. The JAX sentinel's listener
mode hears XLA compile events through ``jax.monitoring``; this package
compiles nothing, so only the poll mode is here: the serving engine feeds
its monotone ``compile_count()`` (the distinct program signatures it has
run) to :meth:`RecompileSentinel.poll` every round, and deltas become
events. ``mark_warm()`` draws the line: events after it increment
``recompile_events_total``, the alerting condition the serving contract
keeps at 0.
"""

from __future__ import annotations

import threading

from distributed_tensorflow_tpu_torch.obs import registry as _registry

__all__ = ["RecompileSentinel"]


class RecompileSentinel:
    """Counts program-signature events and alerts on any after warmup.

    Metrics (on ``registry``, process default when None):

    * ``xla_compile_events_total`` — every event seen (the JAX package's
      name, kept so scrapers read both packages alike).
    * ``recompile_events_total`` — events AFTER :meth:`mark_warm`; must
      stay 0.
    """

    def __init__(self, registry=None, *, use_listener: bool = False):
        if use_listener:
            raise NotImplementedError(
                "the listener mode reads jax.monitoring and is not ported; use poll mode")
        reg = registry if registry is not None else _registry.get_registry()
        self._compiles = reg.counter(
            "xla_compile_events_total",
            "XLA compilations observed by the recompile sentinel.")
        self._post_warm = reg.counter(
            "recompile_events_total",
            "XLA compilations observed AFTER warmup — must stay 0.")
        self._lock = threading.Lock()
        self._warm = False
        self._poll_base: int | None = None
        self.mode = "poll"

    def poll(self, compile_count: int) -> None:
        """Feed a monotone compile count; deltas become events."""
        with self._lock:
            base, self._poll_base = self._poll_base, int(compile_count)
            warm = self._warm
        if base is None:
            return
        delta = int(compile_count) - base
        if delta > 0:
            self._compiles.inc(delta)
            if warm:
                self._post_warm.inc(delta)

    def mark_warm(self) -> None:
        """Everything counted so far was warmup."""
        with self._lock:
            self._warm = True

    def close(self) -> None:
        """Nothing to detach in poll mode (kept for the JAX API)."""

    @property
    def events_total(self) -> int:
        return int(self._compiles.value)

    @property
    def post_warm_total(self) -> int:
        return int(self._post_warm.value)
