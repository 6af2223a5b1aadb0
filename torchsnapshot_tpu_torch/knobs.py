"""Environment-variable configuration knobs.

Counterpart of ``torchsnapshot_tpu/knobs.py``, holding only the knobs the
take/restore, async-take and distributed paths read.  The environment variable names are
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
ASYNC_STAGING_ENV_VAR = _ENV_PREFIX + "ASYNC_STAGING"
PINNED_HOST_RETRY_S_ENV_VAR = _ENV_PREFIX + "PINNED_HOST_RETRY_S"
SAVE_DEADLINE_S_ENV_VAR = _ENV_PREFIX + "SAVE_DEADLINE_S"
MAX_SHARD_SIZE_ENV_VAR = _ENV_PREFIX + "MAX_SHARD_SIZE_BYTES"
PARTIAL_READS_ENV_VAR = _ENV_PREFIX + "PARTIAL_READS"
PARTIAL_READ_MIN_SAVED_ENV_VAR = _ENV_PREFIX + "PARTIAL_READ_MIN_SAVED_BYTES"
STORE_ADDR_ENV_VAR = _ENV_PREFIX + "STORE_ADDR"
STORE_PATH_ENV_VAR = _ENV_PREFIX + "STORE_PATH"
RANK_ENV_VAR = _ENV_PREFIX + "RANK"
WORLD_SIZE_ENV_VAR = _ENV_PREFIX + "WORLD_SIZE"
LEASE_INTERVAL_S_ENV_VAR = _ENV_PREFIX + "LEASE_INTERVAL_S"
LEASE_GRACE_S_ENV_VAR = _ENV_PREFIX + "LEASE_GRACE_S"
BARRIER_TIMEOUT_S_ENV_VAR = _ENV_PREFIX + "BARRIER_TIMEOUT_S"
FAULTS_ENV_VAR = _ENV_PREFIX + "FAULTS"

_DEFAULT_MAX_CHUNK_SIZE_BYTES = 512 * 1024 * 1024
_DEFAULT_SLAB_SIZE_THRESHOLD_BYTES = 128 * 1024 * 1024
_DEFAULT_MAX_PER_RANK_IO_CONCURRENCY = 16
_DEFAULT_MAX_READ_MERGE_GAP_BYTES = 8 * 1024 * 1024
_DEFAULT_IO_RETRIES = 2
_DEFAULT_RETRY_BASE_S = 0.2
_DEFAULT_PINNED_HOST_RETRY_S = 300.0
# Emergency-flush budget (preemption.py), sized for a typical cloud
# preemption grace window (GCE gives 30 s).
_DEFAULT_SAVE_DEADLINE_S = 30.0
# Sharded pieces above this are subdivided along their largest dim.
_DEFAULT_MAX_SHARD_SIZE_BYTES = 512 * 1024 * 1024
# A partial (row-span) read of a sharded piece skips its whole-payload
# digest, so it is taken only when it saves at least this many bytes.
_DEFAULT_PARTIAL_READ_MIN_SAVED_BYTES = 64 * 1024
# Bound on store-based waits (barriers, collectives, the async commit
# barrier); a peer's reported error or expired lease ends a wait sooner.
_DEFAULT_BARRIER_TIMEOUT_S = 1800.0
# Liveness lease: refreshed every interval by each rank of a multi-rank
# operation; a waiter presumes a peer dead once its lease is older than the
# grace.
_DEFAULT_LEASE_INTERVAL_S = 2.0
_DEFAULT_LEASE_GRACE_S = 10.0


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


def get_pinned_host_retry_s() -> float:
    """Seconds to skip pinned_host staging after a failure before retrying
    it (device_staging.py health tracking); 0 retries immediately."""
    val = os.environ.get(PINNED_HOST_RETRY_S_ENV_VAR)
    return float(val) if val is not None else _DEFAULT_PINNED_HOST_RETRY_S


def get_save_deadline_s() -> float:
    """Emergency-flush budget: seconds the preemption handler gives an
    in-flight snapshot to reach a committed state after SIGTERM."""
    val = os.environ.get(SAVE_DEADLINE_S_ENV_VAR)
    return max(0.0, float(val)) if val is not None else _DEFAULT_SAVE_DEADLINE_S


def get_max_shard_size_bytes() -> int:
    return _get_int_env(MAX_SHARD_SIZE_ENV_VAR, _DEFAULT_MAX_SHARD_SIZE_BYTES)


def partial_reads_enabled() -> bool:
    """Whether sharded restores read only the row span of a saved piece
    that their targets intersect (default on); such a partial read cannot
    be verified against the piece's whole-payload digest."""
    return _get_flag_env(PARTIAL_READS_ENV_VAR, "1")


def get_partial_read_min_saved_bytes() -> int:
    return max(
        0,
        _get_int_env(
            PARTIAL_READ_MIN_SAVED_ENV_VAR, _DEFAULT_PARTIAL_READ_MIN_SAVED_BYTES
        ),
    )


def get_store_addr() -> Optional[str]:
    """``host:port`` of a running TCP store (tpustore.py), or None."""
    val = os.environ.get(STORE_ADDR_ENV_VAR, "").strip()
    return val or None


def get_store_path() -> Optional[str]:
    """Directory backing a FileStore (dist_store.py), or None."""
    val = os.environ.get(STORE_PATH_ENV_VAR, "").strip()
    return val or None


def get_env_rank() -> Optional[int]:
    """This process's rank as a launcher exported it (``TPUSNAP_RANK``)."""
    val = os.environ.get(RANK_ENV_VAR)
    return int(val) if val is not None else None


def get_env_world_size() -> Optional[int]:
    val = os.environ.get(WORLD_SIZE_ENV_VAR)
    return int(val) if val is not None else None


def get_barrier_timeout_s() -> float:
    """Bound on store-based waits: barriers, object collectives, and the
    async commit barrier's arrive/depart."""
    val = os.environ.get(BARRIER_TIMEOUT_S_ENV_VAR)
    return float(val) if val is not None else _DEFAULT_BARRIER_TIMEOUT_S


def get_lease_interval_s() -> float:
    """Seconds between liveness-lease refreshes (clamped to >= 0.05)."""
    val = os.environ.get(LEASE_INTERVAL_S_ENV_VAR)
    return max(0.05, float(val)) if val is not None else _DEFAULT_LEASE_INTERVAL_S


def get_lease_grace_s() -> float:
    """Age past which a peer's unrefreshed lease means "presumed dead"; 0
    disables liveness detection.  Clamped to >= 2x the refresh interval."""
    val = os.environ.get(LEASE_GRACE_S_ENV_VAR)
    grace = float(val) if val is not None else _DEFAULT_LEASE_GRACE_S
    if grace <= 0:
        return 0.0
    return max(grace, 2.0 * get_lease_interval_s())


def get_faults_spec() -> Optional[str]:
    """The fault-injection spec (faults.py), or None."""
    val = os.environ.get(FAULTS_ENV_VAR, "").strip()
    return val or None


@contextmanager
def override_env(name: str, value: Optional[str]) -> Generator[None, None, None]:
    """Set (or, with ``value=None``, unset) one variable for the block and
    restore it on exit, also when the block raises."""
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
    with override_env(MAX_CHUNK_SIZE_ENV_VAR, str(value)):
        yield


@contextmanager
def override_max_per_rank_io_concurrency(value: int) -> Generator[None, None, None]:
    with override_env(MAX_PER_RANK_IO_CONCURRENCY_ENV_VAR, str(value)):
        yield


@contextmanager
def override_batching_disabled(disabled: bool) -> Generator[None, None, None]:
    with override_env(DISABLE_BATCHING_ENV_VAR, "1" if disabled else None):
        yield


@contextmanager
def override_per_rank_memory_budget_bytes(value: int) -> Generator[None, None, None]:
    with override_env(PER_RANK_MEMORY_BUDGET_ENV_VAR, str(value)):
        yield


@contextmanager
def override_async_staging(mode: str) -> Generator[None, None, None]:
    """auto / device / pinned_host / host — where async_take makes the app
    state snapshot-stable before returning (device_staging.py)."""
    with override_env(ASYNC_STAGING_ENV_VAR, mode):
        yield


@contextmanager
def override_save_deadline_s(value: float) -> Generator[None, None, None]:
    with override_env(SAVE_DEADLINE_S_ENV_VAR, str(value)):
        yield


@contextmanager
def override_max_shard_size_bytes(value: int) -> Generator[None, None, None]:
    with override_env(MAX_SHARD_SIZE_ENV_VAR, str(value)):
        yield


@contextmanager
def override_partial_reads(enabled: bool) -> Generator[None, None, None]:
    with override_env(PARTIAL_READS_ENV_VAR, "1" if enabled else "0"):
        yield


@contextmanager
def override_partial_read_min_saved_bytes(value: int) -> Generator[None, None, None]:
    with override_env(PARTIAL_READ_MIN_SAVED_ENV_VAR, str(value)):
        yield


@contextmanager
def override_barrier_timeout_s(value: float) -> Generator[None, None, None]:
    with override_env(BARRIER_TIMEOUT_S_ENV_VAR, str(value)):
        yield


@contextmanager
def override_lease_interval_s(value: float) -> Generator[None, None, None]:
    with override_env(LEASE_INTERVAL_S_ENV_VAR, str(value)):
        yield


@contextmanager
def override_lease_grace_s(value: float) -> Generator[None, None, None]:
    with override_env(LEASE_GRACE_S_ENV_VAR, str(value)):
        yield


@contextmanager
def override_faults(spec: Optional[str]) -> Generator[None, None, None]:
    with override_env(FAULTS_ENV_VAR, spec):
        yield
