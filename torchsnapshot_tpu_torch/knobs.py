"""Environment-variable configuration knobs.

Counterpart of ``torchsnapshot_tpu/knobs.py``, holding only the knobs the
synchronous take/restore path reads.  The environment variable names are
the JAX package's own, so one setting (and one test override) drives both
packages.  Defaults are storage-side numbers and match the JAX package:
512 MB chunks, 128 MB slabs, 16 concurrent I/O operations per process.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Generator, Optional

_ENV_PREFIX = "TPUSNAP_"

MAX_CHUNK_SIZE_ENV_VAR = _ENV_PREFIX + "MAX_CHUNK_SIZE_BYTES"
SLAB_SIZE_THRESHOLD_ENV_VAR = _ENV_PREFIX + "SLAB_SIZE_THRESHOLD_BYTES"
MAX_PER_RANK_IO_CONCURRENCY_ENV_VAR = _ENV_PREFIX + "MAX_PER_RANK_IO_CONCURRENCY"
DISABLE_BATCHING_ENV_VAR = _ENV_PREFIX + "DISABLE_BATCHER"
PER_RANK_MEMORY_BUDGET_ENV_VAR = _ENV_PREFIX + "PER_RANK_MEMORY_BUDGET_BYTES"
MAX_READ_MERGE_GAP_ENV_VAR = _ENV_PREFIX + "MAX_READ_MERGE_GAP_BYTES"
IO_RETRIES_ENV_VAR = _ENV_PREFIX + "IO_RETRIES"
RETRY_BASE_S_ENV_VAR = _ENV_PREFIX + "RETRY_BASE_S"
NATIVE_THREADS_ENV_VAR = _ENV_PREFIX + "NATIVE_THREADS"
CHECKSUM_ENV_VAR = _ENV_PREFIX + "CHECKSUM"
CHECKSUM_ON_SAVE_ENV_VAR = _ENV_PREFIX + "CHECKSUM_ON_SAVE"

_DEFAULT_MAX_CHUNK_SIZE_BYTES = 512 * 1024 * 1024
_DEFAULT_SLAB_SIZE_THRESHOLD_BYTES = 128 * 1024 * 1024
_DEFAULT_MAX_PER_RANK_IO_CONCURRENCY = 16
_DEFAULT_MAX_READ_MERGE_GAP_BYTES = 8 * 1024 * 1024
_DEFAULT_IO_RETRIES = 2
_DEFAULT_RETRY_BASE_S = 0.2


def _get_int_env(name: str, default: int) -> int:
    val = os.environ.get(name)
    if val is None:
        return default
    return int(val)


def _get_flag_env(name: str, default: str) -> bool:
    return os.environ.get(name, default) not in ("0", "", "false", "False")


def get_max_chunk_size_bytes() -> int:
    return _get_int_env(MAX_CHUNK_SIZE_ENV_VAR, _DEFAULT_MAX_CHUNK_SIZE_BYTES)


def get_slab_size_threshold_bytes() -> int:
    return _get_int_env(
        SLAB_SIZE_THRESHOLD_ENV_VAR, _DEFAULT_SLAB_SIZE_THRESHOLD_BYTES
    )


def get_max_per_rank_io_concurrency() -> int:
    return _get_int_env(
        MAX_PER_RANK_IO_CONCURRENCY_ENV_VAR, _DEFAULT_MAX_PER_RANK_IO_CONCURRENCY
    )


def is_batching_disabled() -> bool:
    return _get_flag_env(DISABLE_BATCHING_ENV_VAR, "0")


def get_max_read_merge_gap_bytes() -> int:
    """Largest hole tolerated inside one merged (spanning) read."""
    return _get_int_env(
        MAX_READ_MERGE_GAP_ENV_VAR, _DEFAULT_MAX_READ_MERGE_GAP_BYTES
    )


def get_per_rank_memory_budget_bytes_override() -> Optional[int]:
    val = os.environ.get(PER_RANK_MEMORY_BUDGET_ENV_VAR)
    return int(val) if val is not None else None


def get_io_retries() -> int:
    """Retries of a transient storage failure beyond the first attempt, per
    write/read request and for the metadata commit."""
    return max(0, _get_int_env(IO_RETRIES_ENV_VAR, _DEFAULT_IO_RETRIES))


def get_retry_base_s() -> float:
    """Base of the jittered exponential backoff (retry.backoff_s)."""
    val = os.environ.get(RETRY_BASE_S_ENV_VAR)
    return float(val) if val is not None else _DEFAULT_RETRY_BASE_S


def get_native_threads() -> int:
    """Size of the native library's C++ worker pool; 0 (default) sizes it
    to min(16, hardware threads).  Read once, when the library loads."""
    return max(0, _get_int_env(NATIVE_THREADS_ENV_VAR, 0))


def checksum_enabled() -> bool:
    """Whether payload digests participate at all (default on): off skips
    recording on save and verification on restore."""
    return _get_flag_env(CHECKSUM_ENV_VAR, "1")


def checksum_on_save_enabled() -> bool:
    """Whether saves record digests (default on); restores keep verifying
    whatever digests a snapshot carries."""
    return _get_flag_env(CHECKSUM_ON_SAVE_ENV_VAR, "1")


@contextmanager
def _override_env(name: str, value: Optional[str]) -> Generator[None, None, None]:
    prev = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


@contextmanager
def override_max_chunk_size_bytes(value: int) -> Generator[None, None, None]:
    with _override_env(MAX_CHUNK_SIZE_ENV_VAR, str(value)):
        yield





@contextmanager
def override_batching_disabled(disabled: bool) -> Generator[None, None, None]:
    with _override_env(DISABLE_BATCHING_ENV_VAR, "1" if disabled else None):
        yield


@contextmanager
def override_per_rank_memory_budget_bytes(value: int) -> Generator[None, None, None]:
    with _override_env(PER_RANK_MEMORY_BUDGET_ENV_VAR, str(value)):
        yield
