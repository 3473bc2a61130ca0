"""Exporters for the metrics registry: Prometheus text, JSONL, SummaryWriter.

This package's copy of ``distributed_tensorflow_tpu/obs/export.py``. This
package's ``utils/summary.py`` writes scalars only, so
:func:`publish_to_summary` writes a histogram as its p99 scalar.

Three audiences:

* A scraper (``GET /metrics`` on the serve server) gets the standard
  Prometheus text exposition — ``# HELP`` / ``# TYPE`` headers, labeled
  samples, and cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count``
  histogram series (:func:`prometheus_text`).
* Offline tooling gets append-only JSONL snapshots
  (:func:`write_jsonl_snapshot`) — one line per scrape, trivially greppable
  and diffable across runs.
* TensorBoard gets the existing ``utils/summary.py`` event files via
  :func:`publish_to_summary` — counters/gauges as scalars, histograms as
  reservoir histograms — so nothing about the established workflow breaks.

:func:`parse_prometheus_text` is the minimal inverse of the text format
(name, labels, value). It exists so tests can ROUND-TRIP the exposition
instead of string-matching it, and so loadgen-style tools can read a live
``/metrics`` endpoint without a prometheus client dependency.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import TYPE_CHECKING

from distributed_tensorflow_tpu_torch.obs import registry as _registry

if TYPE_CHECKING:
    from distributed_tensorflow_tpu_torch.utils.summary import SummaryWriter

__all__ = [
    "prometheus_text",
    "parse_prometheus_text",
    "registry_snapshot",
    "write_jsonl_snapshot",
    "publish_to_summary",
]


def _fmt(v: float) -> str:
    """Prometheus sample values: integers render bare, +Inf as ``+Inf``."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(names: tuple[str, ...], values: tuple[str, ...],
               extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def prometheus_text(registry=None) -> str:
    """Render a registry in the Prometheus text exposition format
    (``text/plain; version=0.0.4``)."""
    registry = registry if registry is not None else _registry.get_registry()
    lines: list[str] = []
    for fam in registry.collect():
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for label_values, inst in fam.children():
            if fam.kind in ("counter", "gauge"):
                ls = _label_str(fam.label_names, label_values)
                lines.append(f"{fam.name}{ls} {_fmt(inst.value)}")
            else:  # histogram
                for le, cum in inst.buckets():
                    ls = _label_str(fam.label_names, label_values,
                                    extra=(("le", _fmt(le)),))
                    lines.append(f"{fam.name}_bucket{ls} {cum}")
                with inst._lock:
                    count, total = inst.count, inst.total
                ls_inf = _label_str(fam.label_names, label_values,
                                    extra=(("le", "+Inf"),))
                ls = _label_str(fam.label_names, label_values)
                lines.append(f"{fam.name}_bucket{ls_inf} {count}")
                lines.append(f"{fam.name}_sum{ls} {_fmt(total)}")
                lines.append(f"{fam.name}_count{ls} {count}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> list[dict]:
    """Minimal parser for the exposition format: returns
    ``[{"name", "labels", "value"}, ...]`` for every sample line. Comment
    (``#``) and blank lines are skipped. ``le`` shows up as an ordinary
    label on ``_bucket`` series."""
    samples = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            label_part, value_part = rest.rsplit("}", 1)
            labels = {}
            # Split on commas outside quotes.
            buf, depth, parts = [], False, []
            for ch in label_part:
                if ch == '"' and (not buf or buf[-1] != "\\"):
                    depth = not depth
                if ch == "," and not depth:
                    parts.append("".join(buf))
                    buf = []
                else:
                    buf.append(ch)
            if buf:
                parts.append("".join(buf))
            for part in parts:
                if not part:
                    continue
                k, v = part.split("=", 1)
                v = v.strip().strip('"')
                v = v.replace('\\"', '"').replace("\\n", "\n")
                v = v.replace("\\\\", "\\")
                labels[k.strip()] = v
            value_s = value_part.strip().split()[0]
        else:
            fields = line.split()
            name, value_s = fields[0], fields[1]
            labels = {}
        if value_s == "+Inf":
            value = math.inf
        elif value_s == "-Inf":
            value = -math.inf
        else:
            value = float(value_s)
        samples.append({"name": name.strip(), "labels": labels, "value": value})
    return samples


def registry_snapshot(registry=None) -> dict:
    """JSON-friendly snapshot of every family: counters/gauges as values,
    histograms as their ``summary()`` dicts (per label set)."""
    registry = registry if registry is not None else _registry.get_registry()
    out: dict = {"t_wall": time.time(), "metrics": {}}
    for fam in registry.collect():
        entries = []
        for label_values, inst in fam.children():
            labels = dict(zip(fam.label_names, label_values))
            if fam.kind == "histogram":
                entry = {"labels": labels, **inst.summary()}
            else:
                entry = {"labels": labels, "value": inst.value}
            entries.append(entry)
        out["metrics"][fam.name] = {"kind": fam.kind, "samples": entries}
    return out


def write_jsonl_snapshot(path: str, registry=None) -> dict:
    """Append one :func:`registry_snapshot` line to ``path`` (JSONL). Returns
    the snapshot. Creates parent directories."""
    snap = registry_snapshot(registry)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(snap, default=str) + "\n")
    return snap


def publish_to_summary(writer: "SummaryWriter", step: int, registry=None) -> None:
    """Bridge registry families into the repo's TensorBoard writer: counters
    and gauges become scalars (labels joined into the tag), histograms become
    a p99 scalar."""
    registry = registry if registry is not None else _registry.get_registry()
    for fam in registry.collect():
        for label_values, inst in fam.children():
            tag = fam.name
            if label_values:
                tag += "/" + "/".join(label_values)
            if fam.kind == "histogram":
                writer.add_scalars({f"obs/{tag}_p99": inst.percentile(99)}, step)
            else:
                writer.add_scalars({f"obs/{tag}": inst.value}, step)
