"""Env-var-driven fault injection: this package's own copy of the
count-armed part of ``distributed_tensorflow_tpu/utils/faults.py``.

``DTT_FAULT=ckpt_restore:2,ckpt_publish`` arms sites by name: ``site:N``
fires on the next N traversals of ``site``, and ``site`` alone is
``site:1``. The sites this package traverses:

* ``ckpt_publish`` — ``train/checkpoint.py``: between a step's shard and
  manifest files and its commit marker (a save torn before it became
  visible);
* ``ckpt_restore`` — ``train/checkpoint.py``: the read of one step, inside
  its retry, then the walk back to an older step.

The JAX package's other arms (``step=``, ``p=``, ``after=``, ``ms=``) are
not ported: a spec that uses one raises, as a malformed one does.
"""

from __future__ import annotations

import os
import threading

from distributed_tensorflow_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

ENV_VAR = "DTT_FAULT"


class InjectedFault(OSError):
    """An OSError, so injected faults take the paths real I/O errors take."""


_lock = threading.Lock()
_registry: dict[str, int] | None = None  # None: not yet read from the env


def parse_spec(spec: str) -> dict[str, int]:
    """``{site: shots}`` of a ``DTT_FAULT`` spec; raises ValueError on an
    entry this copy does not take."""
    sites: dict[str, int] = {}
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        name, _, arg = (s.strip() for s in entry.partition(":"))
        if not name or (arg and not arg.isdigit()):
            raise ValueError(f"bad {ENV_VAR} entry {entry!r}: expected 'site' or 'site:N'")
        sites[name] = sites.get(name, 0) + (int(arg) if arg else 1)
    return sites


def configure(spec: str | None) -> None:
    """Install a spec (tests); ``None`` re-arms from the env on next use."""
    global _registry
    with _lock:
        _registry = None if spec is None else parse_spec(spec)


def reset() -> None:
    configure(None)


def fire(site: str) -> bool:
    """One traversal of ``site``: True when an armed shot fires."""
    global _registry
    with _lock:
        if _registry is None:
            _registry = parse_spec(os.environ.get(ENV_VAR, ""))
        if _registry.get(site, 0) <= 0:
            return False
        _registry[site] -= 1
    log.warning("injected fault fired: %s", site)
    return True


def maybe_fail(site: str, detail: str = "") -> None:
    """Raise :class:`InjectedFault` when ``site`` fires on this traversal."""
    if fire(site):
        raise InjectedFault(f"injected fault at {site}" + (f" ({detail})" if detail else ""))
