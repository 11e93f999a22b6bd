"""The retry policy's schedule and the error classification (counterpart
of ``flaxdiff_tpu/resilience/retry.py``, without the JAX package's
`RetryPolicy.call`: nothing in the port retries in place). The serving
scheduler takes its requeue budget and backoff schedule from a
`RetryPolicy`, and `default_classifier` is the base of its fault taxonomy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# HTTP statuses that will not succeed on retry (client errors minus 408
# request-timeout and 429 too-many-requests, which are transient).
NON_RETRYABLE_HTTP = frozenset(
    {400, 401, 403, 404, 405, 406, 410, 411, 413, 414, 415, 422, 451})


def _http_code(exc: BaseException) -> Optional[int]:
    code = getattr(exc, "code", None)
    if isinstance(code, int):
        return code
    resp = getattr(exc, "response", None)           # requests-style
    return getattr(resp, "status_code", None) if resp is not None else None


def default_classifier(exc: BaseException) -> bool:
    """True if `exc` is worth retrying.

    Retryable: I/O and network faults (OSError covers URLError, socket
    timeouts, ConnectionError), plus HTTP 5xx/408/429. Non-retryable:
    HTTP 4xx client errors, programming errors (TypeError/ValueError/
    KeyError/AttributeError), and control-flow exceptions.
    """
    if isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit,
                        StopIteration, AssertionError)):
        return False
    code = _http_code(exc)
    if code is not None:
        return code not in NON_RETRYABLE_HTTP
    if isinstance(exc, (TypeError, ValueError, KeyError, AttributeError,
                        IndexError, NotImplementedError)):
        return False
    return True


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """A bounded retry budget with exponential backoff: the delay before
    attempt k (k >= 2) is `min(base_delay * growth**(k-2), max_delay)`.
    The serving scheduler requeues a failed-but-innocent request after
    `delays()[attempts - 1]` until `max_attempts` is reached. `jitter` is
    kept for the JAX package's field set; the schedule is pre-jitter."""
    max_attempts: int = 3
    base_delay: float = 0.1
    growth: float = 2.0
    max_delay: float = 5.0
    jitter: float = 0.5

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError("jitter must be in [0, 1]")

    def delays(self) -> Tuple[float, ...]:
        """The backoff schedule (pre-jitter) — one delay per retry."""
        return tuple(min(self.base_delay * self.growth ** i, self.max_delay)
                     for i in range(self.max_attempts - 1))
