"""Env-var-driven fault injection: this package's own copy of the count,
``after=`` and ``ms=`` arms of ``distributed_tensorflow_tpu/utils/faults.py``.

``DTT_FAULT=ckpt_restore:2,stream_cut:after=3,replica_stall:ms=200`` arms
sites by name:

* ``site:N`` — the next N traversals of ``site`` fire;
* ``site:after=N`` — let N traversals pass, fire once on the N+1th (repeat
  the entry to arm several crossings);
* ``site:ms=D`` — attach a latency of D milliseconds: a delay-type site
  stalls by D on every armed traversal, an error-type site reads D as its
  duration;
* ``site`` alone — ``site:1``.

Entries for one site combine: ``replica_hang:1,replica_hang:ms=500`` arms
one hang of 500 ms. A site with ONLY ``ms=`` delays every traversal; with a
count or ``after=`` arm too, the delay applies when that arm fires.

The sites this package traverses:

* ``ckpt_publish`` — ``train/checkpoint.py``: between a step's shard and
  manifest files and its commit marker;
* ``ckpt_restore`` — ``train/checkpoint.py``: the read of one step, inside
  its retry, then the walk back to an older step;
* ``replica_5xx`` — ``serve/server.py``: ``/generate`` answers 503 before
  admission;
* ``replica_stall`` — ``serve/server.py``: ``/generate`` stalls ``ms=``
  before answering;
* ``replica_hang`` — ``serve/server.py``: ``/generate`` holds the socket
  without answering (``ms=`` caps the hold, default 30 000);
* ``stream_cut`` — ``serve/server.py``: an SSE stream closes without its
  ``done`` frame (``after=N`` lets N token frames pass).

The JAX package's ``step=`` and ``p=`` arms are not ported: a spec that
uses one raises, as a malformed one does.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field

from distributed_tensorflow_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

ENV_VAR = "DTT_FAULT"


class InjectedFault(OSError):
    """An OSError, so injected faults take the paths real I/O errors take."""


@dataclass
class _Site:
    remaining: int = 0
    afters: set[int] = field(default_factory=set)  # fire once past each crossing
    ms: float = 0.0  # attached latency (delay value / hang duration)
    seen: int = 0  # traversals observed (drives ``after=``)
    gated: bool = False  # count- or after-armed: ms only fires with the arm


_lock = threading.Lock()
_registry: dict[str, _Site] | None = None  # None: not yet read from the env


def parse_spec(spec: str) -> dict[str, _Site]:
    """The sites of a ``DTT_FAULT`` spec; raises ValueError on an entry this
    copy does not take."""
    sites: dict[str, _Site] = {}
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        name, _, arg = (s.strip() for s in entry.partition(":"))
        if not name:
            raise ValueError(f"bad {ENV_VAR} entry {entry!r}: empty site name")
        site = sites.setdefault(name, _Site())
        if not arg or arg.isdigit():
            site.remaining += int(arg) if arg else 1
        elif arg.startswith("after=") and arg[6:].isdigit():
            site.afters.add(int(arg[6:]))
        elif arg.startswith("ms="):
            try:
                ms = float(arg[3:])
            except ValueError:
                ms = -1.0
            if ms < 0:
                raise ValueError(f"bad {ENV_VAR} entry {entry!r}: ms must be a number >= 0")
            site.ms = ms
        else:
            raise ValueError(
                f"bad {ENV_VAR} entry {entry!r}: expected 'site', 'site:N', 'site:after=N' "
                "or 'site:ms=D'"
            )
        if site.remaining > 0 or site.afters:
            site.gated = True
    return sites


def configure(spec: str | None) -> None:
    """Install a spec (tests); ``None`` re-arms from the env on next use."""
    global _registry
    with _lock:
        _registry = None if spec is None else parse_spec(spec)


def reset() -> None:
    configure(None)


def _sites() -> dict[str, _Site]:
    global _registry
    if _registry is None:
        _registry = parse_spec(os.environ.get(ENV_VAR, ""))
    return _registry


def _roll(s: _Site) -> bool:
    """One traversal of a site, lock held: the count arm, then crossings."""
    s.seen += 1
    if s.remaining > 0:
        s.remaining -= 1
        return True
    crossed = {a for a in s.afters if s.seen > a}
    if crossed:
        s.afters -= crossed
        return True
    return False


def fire(site: str) -> bool:
    """One traversal of ``site``: True when an armed shot fires."""
    with _lock:
        s = _sites().get(site)
        if s is None or not _roll(s):
            return False
    log.warning("injected fault fired: %s", site)
    return True


def maybe_fail(site: str, detail: str = "") -> None:
    """Raise :class:`InjectedFault` when ``site`` fires on this traversal."""
    if fire(site):
        raise InjectedFault(f"injected fault at {site}" + (f" ({detail})" if detail else ""))


def site_ms(site: str, default: float = 0.0) -> float:
    """The ``ms=`` latency attached to ``site`` (non-consuming)."""
    with _lock:
        s = _sites().get(site)
        return s.ms if s is not None and s.ms > 0 else default


def delay_s(site: str) -> float:
    """Seconds to stall this traversal of ``site``, 0.0 when quiet."""
    with _lock:
        s = _sites().get(site)
        if s is None or s.ms <= 0:
            return 0.0
        if s.gated:  # an exhausted count/after arm stays quiet
            if not _roll(s):
                return 0.0
        else:
            s.seen += 1
        out = s.ms / 1000.0
    log.warning("injected delay fired: %s (%.0f ms)", site, out * 1000.0)
    return out
