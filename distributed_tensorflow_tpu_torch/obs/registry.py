"""Thread-safe process-wide metrics registry (Prometheus-style instruments).

This package's copy of ``distributed_tensorflow_tpu/obs/registry.py``,
which imports no JAX; the text below is that module's.

Three instrument kinds, each addressable as a labeled *family*:

* :class:`Counter` — monotonically increasing float (``_total`` names by
  convention); resets only with the process.
* :class:`Gauge` — a value that goes both ways (queue depth, occupancy).
* :class:`Histogram` — bounded reservoir for percentile readout (serving
  metrics should reflect CURRENT behavior, not the warmup transient from an
  hour ago) plus exact lifetime ``count``/``sum`` and cumulative bucket
  counts for the Prometheus exposition.

Concurrency contract: every mutation and every read snapshot takes the
instrument's own lock, so a ThreadingHTTPServer handler thread can render
``/metrics`` while the scheduler thread ``observe()``s — the exact race
that crashed the old ``serve/metrics.py`` deque (append during iteration).
The hot-path cost is one uncontended lock acquire + a float op, which is
what keeps the bench.py overhead gate (≤1% vs no-op) honest rather than
lucky.

Registration is idempotent: asking for an existing (name, kind) returns the
same family; re-registering a name as a different kind raises. A
:class:`NullRegistry` hands out shared no-op instruments so ``obs.disable()``
turns every call site into a near-free method call.
"""

from __future__ import annotations

import bisect
import math
import threading
from collections import deque
from typing import Iterable, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Family",
    "MetricsRegistry",
    "NullRegistry",
    "get_registry",
    "set_registry",
    "DEFAULT_BUCKETS",
]

# Geometric 1-2.5-5 ladder from 1 ms to 10 s — wide enough for TTFT,
# per-token gaps, step times, and checkpoint stalls without per-site tuning.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """np.percentile's default linear interpolation, numpy-free."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    if n == 1:
        return float(sorted_vals[0])
    pos = (q / 100.0) * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac)


class Counter:
    """Monotonic accumulator. ``inc`` with a negative amount raises — a
    shrinking counter means a bug at the call site, not a feature."""

    kind = "counter"
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    kind = "gauge"
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Bounded reservoir (most recent ``maxlen`` samples, deque semantics)
    with exact lifetime ``count``/``total`` and cumulative bucket counts.

    All reads snapshot under the same lock the writes take — ``percentile``
    / ``summary`` / ``values`` are safe against a concurrent ``observe``
    from another thread (the old serve Histogram's
    "deque mutated during iteration" crash is structurally impossible here).
    """

    kind = "histogram"

    def __init__(self, maxlen: int = 4096, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self._lock = threading.Lock()
        self._samples: deque[float] = deque(maxlen=maxlen)
        self._buckets = tuple(sorted(float(b) for b in buckets))
        self._bucket_counts = [0] * len(self._buckets)
        self.count = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._samples.append(value)
            self.count += 1
            self.total += value
            i = bisect.bisect_left(self._buckets, value)
            if i < len(self._bucket_counts):
                self._bucket_counts[i] += 1

    def _snapshot(self) -> list[float]:
        with self._lock:
            return list(self._samples)

    def percentile(self, q: float) -> float:
        """q in [0, 100] over the reservoir; 0.0 with no samples."""
        return _percentile(sorted(self._snapshot()), q)

    def summary(self) -> dict:
        with self._lock:
            vals = sorted(self._samples)
            count, total = self.count, self.total
        return {
            "count": count,
            "mean": total / count if count else 0.0,
            "p50": _percentile(vals, 50),
            "p95": _percentile(vals, 95),
            "p99": _percentile(vals, 99),
            "max": vals[-1] if vals else 0.0,
        }

    def values(self):
        """Reservoir contents as a float64 numpy array (for
        ``SummaryWriter.add_histogram``)."""
        import numpy as np

        return np.asarray(self._snapshot(), np.float64)

    def buckets(self) -> list[tuple[float, int]]:
        """CUMULATIVE (le, count) pairs, Prometheus ``_bucket`` semantics;
        the implicit +Inf bucket is the lifetime count."""
        with self._lock:
            counts = list(self._bucket_counts)
        out, acc = [], 0
        for le, c in zip(self._buckets, counts):
            acc += c
            out.append((le, acc))
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One registered metric name: either a single unlabeled instrument or a
    set of labeled children. Unlabeled families proxy the instrument API
    directly (``registry.counter("x").inc()``); labeled families hand out
    children via :meth:`labels`."""

    def __init__(self, name: str, kind: str, help: str,
                 label_names: tuple[str, ...], make):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = label_names
        self._make = make
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}
        if not label_names:
            self._children[()] = make()

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            values = tuple(str(kv[n]) for n in self.label_names)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got {values}"
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._make()
            return child

    def children(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())

    # -- unlabeled proxy ---------------------------------------------------

    def _solo(self):
        if self.label_names:
            raise ValueError(f"{self.name} is labeled — use .labels(...)")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    @property
    def value(self) -> float:
        return self._solo().value

    def percentile(self, q: float) -> float:
        return self._solo().percentile(q)

    def summary(self) -> dict:
        return self._solo().summary()

    def values(self):
        return self._solo().values()

    def buckets(self):
        return self._solo().buckets()

    @property
    def count(self) -> int:
        return self._solo().count

    @property
    def total(self) -> float:
        return self._solo().total


class MetricsRegistry:
    """Process-wide (or scoped — serving builds a private one per stack so
    tests stay isolated) family registry. Registration is idempotent per
    (name, kind); kind conflicts raise immediately."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, Family] = {}

    def _register(self, name: str, kind: str, help: str,
                  labels: Iterable[str], make) -> Family:
        labels = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}, "
                        f"not {kind}"
                    )
                return fam
            fam = self._families[name] = Family(name, kind, help, labels, make)
            return fam

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Family:
        return self._register(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Family:
        return self._register(name, "gauge", help, labels, Gauge)

    def histogram(self, name: str, help: str = "", labels: Iterable[str] = (),
                  maxlen: int = 4096,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Family:
        return self._register(
            name, "histogram", help, labels,
            lambda: Histogram(maxlen=maxlen, buckets=buckets),
        )

    def collect(self) -> list[Family]:
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)


class _NullInstrument:
    """Shared do-nothing instrument: every mutator is a constant-time no-op,
    every reader returns zeros. ``labels()`` returns itself so labeled call
    sites need no special casing."""

    kind = "null"
    count = 0
    total = 0.0
    value = 0.0

    def labels(self, *a, **k):
        return self

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def percentile(self, q: float) -> float:
        return 0.0

    def summary(self) -> dict:
        return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                "p99": 0.0, "max": 0.0}

    def values(self):
        import numpy as np

        return np.zeros(0, np.float64)

    def buckets(self) -> list:
        return []


_NULL = _NullInstrument()


class NullRegistry:
    """The obs-disabled registry: all three constructors return one shared
    no-op instrument (the bench.py overhead baseline)."""

    def counter(self, name: str, help: str = "", labels=()) -> _NullInstrument:
        return _NULL

    def gauge(self, name: str, help: str = "", labels=()) -> _NullInstrument:
        return _NULL

    def histogram(self, name: str, help: str = "", labels=(), maxlen: int = 4096,
                  buckets=DEFAULT_BUCKETS) -> _NullInstrument:
        return _NULL

    def collect(self) -> list:
        return []


_default_lock = threading.Lock()
_default: MetricsRegistry | NullRegistry = MetricsRegistry()


def get_registry() -> MetricsRegistry | NullRegistry:
    """The process default registry (what the train loops and the data
    pipeline publish into)."""
    return _default


def set_registry(registry) -> None:
    global _default
    with _default_lock:
        _default = registry
