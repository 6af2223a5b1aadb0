"""Transient-error taxonomy and budgeted backoff.

Counterpart of ``torchsnapshot_tpu/retry.py``: the s3 plugin's internal
attempt loops, the scheduler's bounded write/read requeue and the rank-0
metadata commit classify errors through :func:`is_transient` and sleep
through :func:`backoff_s`.

- **transient** — :class:`StorageTransientError`; HTTP 408, 429 and 5xx
  (:class:`HTTPStatusError` carries the status);
  ``http.client``'s ``RemoteDisconnected``, ``IncompleteRead`` and
  ``BadStatusLine``; connection resets and timeouts; and the retryable
  ``OSError`` errnos of a contended filesystem (EAGAIN, EINTR, EBUSY,
  EIO, ETIMEDOUT, ESTALE, network-down).  ENOSPC, EACCES and ENOENT are
  terminal.
- **terminal** — everything else, other 4xx responses included.
"""

from __future__ import annotations

import errno
import http.client
import logging
import random
import time
from typing import Optional

from . import knobs
from .telemetry import metrics as tmetrics

logger = logging.getLogger(__name__)


class StorageTransientError(RuntimeError):
    """A storage error its raiser believes is safe to retry."""


class HTTPStatusError(RuntimeError):
    """An HTTP response a storage plugin refused, carrying its ``status``
    (the standard-library transport has no ``requests`` response object)."""

    def __init__(self, message: str, status: int) -> None:
        super().__init__(message)
        self.status = status


TRANSIENT_HTTP_STATUS = frozenset({408, 429, 500, 502, 503, 504})

_TRANSIENT_ERRNOS = frozenset(
    e
    for e in (
        errno.EAGAIN,
        errno.EINTR,
        errno.EBUSY,
        errno.EIO,
        errno.ETIMEDOUT,
        errno.ESTALE,
        errno.ENETDOWN,
        errno.ENETUNREACH,
        errno.ENETRESET,
        getattr(errno, "EREMOTEIO", None),
    )
    if e is not None
)

# What a dropped or garbled response raises (RemoteDisconnected is a
# ConnectionResetError, so ConnectionError covers it).
_TRANSIENT_HTTP_EXCEPTIONS = (http.client.IncompleteRead, http.client.BadStatusLine)


def is_transient(exc: BaseException) -> bool:
    """Whether ``exc`` is worth retrying.  Unknown errors are terminal: a
    retry layer must never spin on a logic bug."""
    if isinstance(exc, StorageTransientError):
        return True
    if isinstance(exc, HTTPStatusError) and exc.status in TRANSIENT_HTTP_STATUS:
        return True
    if isinstance(exc, _TRANSIENT_HTTP_EXCEPTIONS):
        return True
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    return isinstance(exc, OSError) and exc.errno in _TRANSIENT_ERRNOS


def backoff_s(attempt: int, base_s: Optional[float] = None, cap_s: float = 32.0) -> float:
    """Jittered exponential backoff for the ``attempt``-th retry (1-based).
    ``base_s`` is the caller's calibrated base (s3's 0.2 s);
    ``TPUSNAP_RETRY_BASE_S``, when set, overrides it in every layer."""
    base = knobs.get_retry_base_s(default=base_s)
    exp = min(max(attempt, 1) - 1, 8)
    return min(cap_s, base * (2**exp)) * (0.5 + random.random())


def sleep_backoff(attempt: int, cancel=None, **kwargs) -> None:
    """Sleep for the ``attempt``-th retry; a set ``cancel`` event
    (threading.Event) cuts the wait short."""
    delay = backoff_s(attempt, **kwargs)
    if cancel is not None:
        cancel.wait(delay)
    else:
        time.sleep(delay)


def call_with_retries(fn, *, stage: str):
    """Run a blocking callable, retrying transient failures up to
    ``TPUSNAP_IO_RETRIES`` times, each counted on
    ``tpusnap_pipeline_retries_total{stage=...}``."""
    max_retries = knobs.get_io_retries()
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — classified below
            if attempt >= max_retries or not is_transient(e):
                raise
            attempt += 1
            tmetrics.record_pipeline_retry(stage)
            logger.warning(
                "transient %s failure (attempt %d/%d): %r; retrying",
                stage,
                attempt,
                max_retries,
                e,
            )
            time.sleep(backoff_s(attempt))
