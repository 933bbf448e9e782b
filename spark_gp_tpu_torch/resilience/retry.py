"""Bounded retry with backoff for host-side recovery actions: around
whole fit attempts (a quarantine round that needs the fit run again)
and any other operation whose failure may be transient.  Deterministic
exponential backoff, a hard attempt budget, and a hook before each retry
so that the caller can repair its operands in between."""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Tuple, Type

logger = logging.getLogger("spark_gp_tpu_torch")


class RetryBudgetExceededError(RuntimeError):
    """Every attempt failed; carries the last underlying error as cause."""


def retry_with_backoff(
    fn: Callable,
    *,
    attempts: int = 3,
    base_delay_s: float = 0.05,
    max_delay_s: float = 2.0,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    describe: str = "operation",
    sleep: Callable[[float], None] = time.sleep,
):
    """Run ``fn()``; on a ``retry_on`` failure back off and retry.

    ``on_retry(attempt_index, exc)`` runs before each retry (where fit
    recovery quarantines or jitters); an error it raises propagates at
    once.  After ``attempts`` tries the last error is re-raised wrapped
    in :class:`RetryBudgetExceededError` (cause chained)."""
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    delay = base_delay_s
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as exc:
            last = exc
            if attempt == attempts - 1:
                break
            logger.warning(
                "%s failed (attempt %d/%d): %s -- backing off %.3fs",
                describe, attempt + 1, attempts, exc, delay,
            )
            if on_retry is not None:
                on_retry(attempt, exc)
            sleep(delay)
            delay = min(delay * 2.0, max_delay_s)
    raise RetryBudgetExceededError(
        f"{describe} failed after {attempts} attempts: {last}"
    ) from last
