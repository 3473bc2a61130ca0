"""Retry with exponential backoff and jitter: this package's own copy of
``retry_call`` in ``distributed_tensorflow_tpu/utils/retry.py``.

Backoff: ``base_delay * 2**(attempt-1)`` capped at ``max_delay``, then scaled
by a uniform jitter factor in ``[1-jitter, 1+jitter]``. Only ``OSError``
(filesystem errors and injected faults) is retried; anything else
propagates at once.
"""

from __future__ import annotations

import random
import time
from typing import Callable, TypeVar

from distributed_tensorflow_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

T = TypeVar("T")


def retry_call(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base_delay: float = 0.5,
    max_delay: float = 30.0,
    jitter: float = 0.25,
    description: str = "",
) -> T:
    """Call ``fn()`` up to ``attempts`` times; re-raise the last error."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    what = description or getattr(fn, "__name__", "call")
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except OSError as e:
            if attempt == attempts:
                log.warning("%s: attempt %d/%d failed (%s) — giving up", what, attempt,
                            attempts, e)
                raise
            delay = (min(max_delay, base_delay * 2 ** (attempt - 1))
                     * (1.0 - jitter + 2.0 * jitter * random.random()))
            log.warning("%s: attempt %d/%d failed (%s) — retrying in %.2fs", what, attempt,
                        attempts, e, delay)
            time.sleep(delay)
    raise AssertionError("unreachable")
