"""Transient-error taxonomy and budgeted backoff.

Counterpart of ``torchsnapshot_tpu/retry.py`` for the local-disk slice:
the scheduler's bounded write/read requeue and the rank-0 metadata commit
classify errors through :func:`is_transient` and sleep through
:func:`backoff_s`.

- **transient** — :class:`StorageTransientError`, connection and timeout
  errors, and the retryable ``OSError`` errnos of a contended filesystem
  (EAGAIN, EINTR, EBUSY, EIO, ETIMEDOUT, ESTALE, network-down).  ENOSPC,
  EACCES and ENOENT are terminal.
- **terminal** — everything else.
"""

from __future__ import annotations

import errno
import logging
import random
import time

from . import knobs

logger = logging.getLogger(__name__)


class StorageTransientError(RuntimeError):
    """A storage error its raiser believes is safe to retry."""


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


def is_transient(exc: BaseException) -> bool:
    if isinstance(exc, StorageTransientError):
        return True
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    return isinstance(exc, OSError) and exc.errno in _TRANSIENT_ERRNOS


def backoff_s(attempt: int, cap_s: float = 32.0) -> float:
    """Jittered exponential backoff for the ``attempt``-th retry (1-based)."""
    exp = min(max(attempt, 1) - 1, 8)
    return min(cap_s, knobs.get_retry_base_s() * (2**exp)) * (0.5 + random.random())


def call_with_retries(fn, *, stage: str):
    """Run a blocking callable, retrying transient failures up to
    ``TPUSNAP_IO_RETRIES`` times."""
    max_retries = knobs.get_io_retries()
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — classified below
            if attempt >= max_retries or not is_transient(e):
                raise
            attempt += 1
            logger.warning(
                "transient %s failure (attempt %d/%d): %r; retrying",
                stage,
                attempt,
                max_retries,
                e,
            )
            time.sleep(backoff_s(attempt))
