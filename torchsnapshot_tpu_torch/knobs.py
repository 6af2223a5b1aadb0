"""Environment-variable configuration knobs.

Counterpart of ``torchsnapshot_tpu/knobs.py``, holding only the knobs the
take/restore, async-take, distributed, storage-depth (compression,
content addressing, content-defined chunking) and manager (journal,
telemetry sidecars, step history) paths read.  The environment variable
names are the JAX package's own, so one setting (and one test override)
drives both packages.  Defaults are storage-side numbers and match the
JAX package: 512 MB chunks, 128 MB slabs, 16 concurrent I/O operations per
process.

Knobs of the JAX package's host data plane that this package does not
implement yet (:data:`UNIMPLEMENTED_KNOBS`) are not silently ignored:
:func:`warn_unimplemented_knobs` warns once per process for each one set.
``TPUSNAP_D2H_BITCAST`` and ``TPUSNAP_H2D_BITCAST`` have no meaning here:
they force the JAX package's sub-word bitcast staging, and torch moves
every dtype's bytes through a ``view(torch.uint8)`` with no repack.
"""

from __future__ import annotations

import os
import threading
import warnings
from contextlib import contextmanager
from typing import Generator, Optional, Set, Tuple

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
COMPRESSION_ENV_VAR = _ENV_PREFIX + "COMPRESSION"
COMPRESSION_MIN_BYTES_ENV_VAR = _ENV_PREFIX + "COMPRESSION_MIN_BYTES"
ZSTD_WINDOW_LOG_ENV_VAR = _ENV_PREFIX + "ZSTD_WINDOW_LOG"
ZSTD_LDM_ENV_VAR = _ENV_PREFIX + "ZSTD_LDM"
STAGING_THREADS_ENV_VAR = _ENV_PREFIX + "STAGING_THREADS"
CAS_ENV_VAR = _ENV_PREFIX + "CAS"
CAS_ALGO_ENV_VAR = _ENV_PREFIX + "CAS_ALGO"
CDC_ENV_VAR = _ENV_PREFIX + "CDC"
CDC_MIN_BYTES_ENV_VAR = _ENV_PREFIX + "CDC_MIN_BYTES"
CDC_AVG_BYTES_ENV_VAR = _ENV_PREFIX + "CDC_AVG_BYTES"
CDC_MAX_BYTES_ENV_VAR = _ENV_PREFIX + "CDC_MAX_BYTES"
STORE_ENV_VAR = _ENV_PREFIX + "STORE"
SIDECAR_ENV_VAR = _ENV_PREFIX + "SIDECAR"
JOURNAL_ENV_VAR = _ENV_PREFIX + "JOURNAL"
JOURNAL_MAX_SEGMENTS_ENV_VAR = _ENV_PREFIX + "JOURNAL_MAX_SEGMENTS"
JOURNAL_MAX_BYTES_ENV_VAR = _ENV_PREFIX + "JOURNAL_MAX_BYTES"
REGRESSION_FACTOR_ENV_VAR = _ENV_PREFIX + "REGRESSION_FACTOR"
REGRESSION_WINDOW_ENV_VAR = _ENV_PREFIX + "REGRESSION_WINDOW"
DIRECT_IO_ENV_VAR = _ENV_PREFIX + "DIRECT_IO"
NATIVE_BATCH_ENV_VAR = _ENV_PREFIX + "NATIVE_BATCH"
PARALLEL_READ_WAYS_ENV_VAR = _ENV_PREFIX + "PARALLEL_READ_WAYS"
NATIVE_ENV_VAR = _ENV_PREFIX + "NATIVE"
NATIVE_SANITIZE_ENV_VAR = _ENV_PREFIX + "NATIVE_SANITIZE"

# The JAX package's host data plane knobs this package reads nothing of yet.
UNIMPLEMENTED_KNOBS = (
    DIRECT_IO_ENV_VAR,
    NATIVE_BATCH_ENV_VAR,
    PARALLEL_READ_WAYS_ENV_VAR,
    NATIVE_ENV_VAR,
    NATIVE_SANITIZE_ENV_VAR,
)
_warned_knobs: Set[str] = set()
_warned_lock = threading.Lock()

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
# Payloads below this stay raw (and slab-batchable) under a codec.
_DEFAULT_COMPRESSION_MIN_BYTES = 64 * 1024
_SUPPORTED_CAS_ALGOS = ("xxh64",)
# Content-defined chunk sizes (min, average, max).
_DEFAULT_CDC_MIN_BYTES = 256 * 1024
_DEFAULT_CDC_AVG_BYTES = 1024 * 1024
_DEFAULT_CDC_MAX_BYTES = 4 * 1024 * 1024
# Journal compaction triggers: segments since the base, and summed logical
# delta bytes (0 disables the byte trigger).
_DEFAULT_JOURNAL_MAX_SEGMENTS = 8
_DEFAULT_JOURNAL_MAX_BYTES = 0
# Step-history regression detection: a save slower than this multiple of
# the trailing window's median is flagged.
_DEFAULT_REGRESSION_FACTOR = 2.0
_DEFAULT_REGRESSION_WINDOW = 50


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


def get_compression() -> Tuple[str, Optional[int]]:
    """``(codec_name, level_or_None)`` from ``TPUSNAP_COMPRESSION``:
    ``<codec>`` or ``<codec>:<level>`` (``zstd``, ``zstd:6``, ``zlib:1``).
    Unset, empty, ``raw``, ``none``, ``off``, ``0`` and ``false`` mean no
    compression.  The name is resolved against the codecs this host can
    run at the point of use (compression.resolve), not here."""
    val = os.environ.get(COMPRESSION_ENV_VAR, "").strip()
    if not val or val.lower() in ("raw", "none", "off", "0", "false"):
        return "raw", None
    codec, _, level = val.partition(":")
    try:
        parsed_level = int(level) if level else None
    except ValueError:
        raise ValueError(
            f"{COMPRESSION_ENV_VAR}={val!r}: level {level!r} is not an "
            "integer (expected <codec> or <codec>:<int level>, e.g. zstd:6)"
        ) from None
    return codec.strip().lower(), parsed_level


def get_compression_min_bytes() -> int:
    """Smallest payload the configured codec applies to."""
    return _get_int_env(COMPRESSION_MIN_BYTES_ENV_VAR, _DEFAULT_COMPRESSION_MIN_BYTES)


def get_zstd_window_log() -> int:
    """zstd window log (``TPUSNAP_ZSTD_WINDOW_LOG``), clamped to [10, 27];
    0 keeps the level's own."""
    val = _get_int_env(ZSTD_WINDOW_LOG_ENV_VAR, 0)
    if val <= 0:
        return 0
    return min(max(val, 10), 27)


def zstd_ldm_enabled() -> bool:
    """zstd long-distance matching (``TPUSNAP_ZSTD_LDM``)."""
    return _get_flag_env(ZSTD_LDM_ENV_VAR, "0")


def get_staging_threads() -> int:
    """Pinned size of the pipelines' executors (``TPUSNAP_STAGING_THREADS``),
    or 0 for automatic sizing (scheduler.py)."""
    return max(0, _get_int_env(STAGING_THREADS_ENV_VAR, 0))


def cas_enabled() -> bool:
    """Whether takes write payloads into the root's content-addressed
    chunk store (``TPUSNAP_CAS``, cas.py)."""
    return _get_flag_env(CAS_ENV_VAR, "0")


def get_cas_algo() -> str:
    """Digest algorithm naming CAS chunks (``TPUSNAP_CAS_ALGO``); only
    ``xxh64`` exists, and another value raises."""
    val = os.environ.get(CAS_ALGO_ENV_VAR, "").strip().lower() or "xxh64"
    if val not in _SUPPORTED_CAS_ALGOS:
        raise ValueError(
            f"{CAS_ALGO_ENV_VAR}={val!r}: unsupported digest algorithm "
            f"(supported: {', '.join(_SUPPORTED_CAS_ALGOS)})"
        )
    return val


def cdc_enabled() -> bool:
    """Whether the CAS writer splits large payloads on content-defined
    chunk edges (``TPUSNAP_CDC``; needs ``TPUSNAP_CAS=1``)."""
    return _get_flag_env(CDC_ENV_VAR, "0")


def get_cdc_params() -> Tuple[int, int, int]:
    """(min, avg, max) content-defined chunk sizes from
    ``TPUSNAP_CDC_{MIN,AVG,MAX}_BYTES``, which must satisfy
    64 <= min < avg <= max (chunk edges name CAS chunks)."""
    min_b = _get_int_env(CDC_MIN_BYTES_ENV_VAR, _DEFAULT_CDC_MIN_BYTES)
    avg_b = _get_int_env(CDC_AVG_BYTES_ENV_VAR, _DEFAULT_CDC_AVG_BYTES)
    max_b = _get_int_env(CDC_MAX_BYTES_ENV_VAR, _DEFAULT_CDC_MAX_BYTES)
    if not (64 <= min_b < avg_b <= max_b):
        raise ValueError(
            f"TPUSNAP_CDC_*_BYTES must satisfy 64 <= min < avg <= max, "
            f"got min={min_b} avg={avg_b} max={max_b}"
        )
    return min_b, avg_b, max_b


def get_store_url() -> Optional[str]:
    """The shared chunk store (``TPUSNAP_STORE``), or None.  Not ported:
    CAS takes and the manager refuse it (cas.py, manager.py)."""
    val = os.environ.get(STORE_ENV_VAR, "").strip()
    return val or None


def sidecar_enabled() -> bool:
    """Whether each take, async take and restore writes a small
    ``telemetry/<op>.json`` summary next to ``.snapshot_metadata``
    (telemetry/sidecar.py).  On by default; ``TPUSNAP_SIDECAR=0`` opts out."""
    return _get_flag_env(SIDECAR_ENV_VAR, "1")


def journal_enabled() -> bool:
    """Whether ``SnapshotManager.save`` runs in delta-journal mode
    (journal.py): each save appends a segment of the entries that changed
    since the last committed base, and segments are folded into full steps.
    Off by default; ``SnapshotManager(journal=...)`` overrides it."""
    return _get_flag_env(JOURNAL_ENV_VAR, "0")


def get_journal_max_segments() -> int:
    """Segment-count compaction trigger: once this many committed segments
    chain on the base, the next committed save folds them into a full step.
    Minimum 1."""
    return max(1, _get_int_env(JOURNAL_MAX_SEGMENTS_ENV_VAR, _DEFAULT_JOURNAL_MAX_SEGMENTS))


def get_journal_max_bytes() -> int:
    """Byte compaction trigger: fold once the committed segments' summed
    logical delta bytes reach this; 0 (the default) leaves the count
    trigger alone."""
    return max(0, _get_int_env(JOURNAL_MAX_BYTES_ENV_VAR, _DEFAULT_JOURNAL_MAX_BYTES))


def get_regression_factor() -> float:
    """A committed save slower than this multiple of the trailing-window
    median is flagged in the step history (telemetry/history.py) with a
    ``telemetry.regression`` event; 0 disables detection."""
    val = os.environ.get(REGRESSION_FACTOR_ENV_VAR)
    return float(val) if val is not None else _DEFAULT_REGRESSION_FACTOR


def get_regression_window() -> int:
    """Entries of the same action the regression median is taken over."""
    return max(1, _get_int_env(REGRESSION_WINDOW_ENV_VAR, _DEFAULT_REGRESSION_WINDOW))


def warn_unimplemented_knobs() -> None:
    """Warn, once per process and knob, for each :data:`UNIMPLEMENTED_KNOBS`
    entry that is set: the JAX package reads it, this package does not yet."""
    for name in UNIMPLEMENTED_KNOBS:
        if not os.environ.get(name, "").strip():
            continue
        with _warned_lock:
            if name in _warned_knobs:
                continue
            _warned_knobs.add(name)
        warnings.warn(
            f"{name} is set but has no effect in torchsnapshot_tpu_torch yet "
            "(torchsnapshot_tpu reads it; this package ignores it)",
            RuntimeWarning,
            stacklevel=3,
        )


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


@contextmanager
def override_compression(value: Optional[str]) -> Generator[None, None, None]:
    """``codec[:level]`` (``"zstd"``, ``"zlib:6"``) or None to disable."""
    with override_env(COMPRESSION_ENV_VAR, value):
        yield


@contextmanager
def override_compression_min_bytes(value: int) -> Generator[None, None, None]:
    with override_env(COMPRESSION_MIN_BYTES_ENV_VAR, str(value)):
        yield


@contextmanager
def override_cas(enabled: bool) -> Generator[None, None, None]:
    with override_env(CAS_ENV_VAR, "1" if enabled else None):
        yield


@contextmanager
def override_cdc(enabled: bool) -> Generator[None, None, None]:
    with override_env(CDC_ENV_VAR, "1" if enabled else None):
        yield


@contextmanager
def override_cdc_params(
    min_bytes: int, avg_bytes: int, max_bytes: int
) -> Generator[None, None, None]:
    with override_env(CDC_MIN_BYTES_ENV_VAR, str(min_bytes)), override_env(
        CDC_AVG_BYTES_ENV_VAR, str(avg_bytes)
    ), override_env(CDC_MAX_BYTES_ENV_VAR, str(max_bytes)):
        yield


@contextmanager
def override_cas_algo(value: Optional[str]) -> Generator[None, None, None]:
    with override_env(CAS_ALGO_ENV_VAR, value):
        yield


@contextmanager
def override_slab_size_threshold_bytes(value: int) -> Generator[None, None, None]:
    with override_env(SLAB_SIZE_THRESHOLD_ENV_VAR, str(value)):
        yield


@contextmanager
def override_staging_threads(value: int) -> Generator[None, None, None]:
    with override_env(STAGING_THREADS_ENV_VAR, str(value)):
        yield


@contextmanager
def override_retry_base_s(value: float) -> Generator[None, None, None]:
    with override_env(RETRY_BASE_S_ENV_VAR, str(value)):
        yield


@contextmanager
def override_sidecar(enabled: bool) -> Generator[None, None, None]:
    with override_env(SIDECAR_ENV_VAR, "1" if enabled else "0"):
        yield


@contextmanager
def override_journal(enabled: bool) -> Generator[None, None, None]:
    with override_env(JOURNAL_ENV_VAR, "1" if enabled else None):
        yield


@contextmanager
def override_journal_max_segments(value: int) -> Generator[None, None, None]:
    with override_env(JOURNAL_MAX_SEGMENTS_ENV_VAR, str(value)):
        yield


@contextmanager
def override_journal_max_bytes(value: int) -> Generator[None, None, None]:
    with override_env(JOURNAL_MAX_BYTES_ENV_VAR, str(value)):
        yield


@contextmanager
def override_regression_window(value: int) -> Generator[None, None, None]:
    with override_env(REGRESSION_WINDOW_ENV_VAR, str(value)):
        yield
