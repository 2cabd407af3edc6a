"""One retry primitive: jittered exponential backoff with a hard deadline
(the port's copy of the JAX package's `reliability/retry.py` `retry_call`,
without its telemetry counters, its fault-plan jitter (here ordinary
`random`) and its retry hook)."""

from __future__ import annotations

import random
import time
from typing import Callable, Tuple, Type

MAX_DELAY_S = 2.0  # the default cap of one backoff sleep


def retry_call(
    fn: Callable,
    *,
    attempts: int = 3,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    base_delay_s: float = 0.05,
    max_delay_s: float = MAX_DELAY_S,
    deadline_s: float = 30.0,
    sleep: Callable[[float], None] = time.sleep,
):
    """Call `fn()`; on a `retry_on` failure, back off and retry.

    - `attempts` is the TOTAL call budget (1 = no retries).
    - Backoff: `base_delay_s * 2^(attempt-1) * jitter(0.5..1.5)`, capped at
      `max_delay_s`.
    - `deadline_s` bounds elapsed wall time across the whole call: when the
      next sleep would cross it, the last error re-raises at once.
    - Non-retryable exceptions propagate untouched on the first throw."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    t0 = time.monotonic()
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on:
            if attempt >= attempts:
                raise
            delay = min(base_delay_s * 2 ** (attempt - 1)
                        * (0.5 + random.random()), max_delay_s)
            if time.monotonic() - t0 + delay > deadline_s:
                raise
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
