"""Retry policy for the save/commit protocol's transient store errors.

The save write path and the commit DAG's refs CAS absorb transient
`OSError`s through `RetryPolicy` / `call_with_retries` (reported as
``n_retries`` in save stats).  The reference package's fault-injecting
`FaultyStore` and its crash matrix are not ported yet (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Tuple


@dataclasses.dataclass
class RetryPolicy:
    """Exponential-backoff retry for *transient* store errors.

    Retries `OSError` (IOError is its alias) by default — the class real
    filesystems and object stores throw for recoverable conditions.
    ``max_retries=0`` disables retrying.

    ``jitter`` spreads the backoff by a uniform ±fraction so N losers of
    the same CAS race don't all retry in lockstep (the thundering-herd
    fix the contention path needs); 0 keeps delays deterministic.
    """

    max_retries: int = 3
    backoff_s: float = 0.005
    multiplier: float = 2.0
    retry_on: tuple = (OSError,)
    jitter: float = 0.0

    def delay(self, attempt: int) -> float:
        """Sleep before retry number ``attempt`` (0-based): jittered
        exponential ``backoff_s * multiplier**attempt``."""
        d = self.backoff_s * (self.multiplier ** attempt)
        if self.jitter:
            import random
            d *= 1.0 + random.uniform(-self.jitter, self.jitter)
        return max(d, 0.0)


def call_with_retries(fn: Callable[[], Any], policy: RetryPolicy,
                      sleep: Callable[[float], None] = time.sleep
                      ) -> Tuple[Any, int]:
    """Run `fn`, retrying per `policy`.  Returns ``(result, n_retries)``;
    re-raises the last error once retries are exhausted."""
    attempt = 0
    while True:
        try:
            return fn(), attempt
        except policy.retry_on:
            if attempt >= policy.max_retries:
                raise
            sleep(policy.delay(attempt))
            attempt += 1
