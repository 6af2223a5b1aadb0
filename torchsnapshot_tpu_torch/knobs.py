"""Environment-variable configuration knobs.

Counterpart of ``torchsnapshot_tpu/knobs.py``, holding only the knobs the
take/restore, async-take, distributed, storage-depth (compression,
content addressing, content-defined chunking) and manager (journal,
telemetry sidecars, step history) paths read.  The environment variable
names are the JAX package's own, so one setting (and one test override)
drives both packages.  Defaults are storage-side numbers and match the
JAX package: 512 MB chunks, 128 MB slabs, 16 concurrent I/O operations per
process.

The host data plane's knobs are the JAX package's too: micro-batched
fused writes (``TPUSNAP_NATIVE_BATCH``), direct I/O (``TPUSNAP_DIRECT_IO``),
the adaptive into-read (``TPUSNAP_PARALLEL_READ_WAYS``) and sanitizer
builds of the native library (``TPUSNAP_NATIVE_SANITIZE``).  So are the
object store's: ``TPUSNAP_S3_ENDPOINT``, the multipart threshold and part
size, ``TPUSNAP_GCS_ENDPOINT``, and ``TPUSNAP_CLOUD_PARALLEL_MIN_BYTES``,
the smallest read that fans out across ranged GETs.

So are the serving tier's: the host cache (``TPUSNAP_CACHE_DIR``,
``TPUSNAP_CACHE_MAX_BYTES``) and the peer tier (``TPUSNAP_PEER_FETCH``,
``_PORT``, ``_ADDR``, ``_TIMEOUT_S``, ``_RETRIES``, ``_GRACE_S``,
``_BAD_TTL_S``, ``_DEMOTE_FACTOR``).  So are telemetry's: per-operation
traces (``TPUSNAP_TRACE_DIR``), the metrics registry (``TPUSNAP_METRICS``),
the peer daemon's server tracer (``TPUSNAP_PEER_TRACE_MAX_SPANS``,
``_FLUSH_S``) and access log (``TPUSNAP_PEERD_ACCESS_LOG``,
``_MAX_BYTES``), the scheduler's progress table
(``TPUSNAP_PROGRESS_INTERVAL_S``), the health monitor's stall watchdog
(``TPUSNAP_STALL_TIMEOUT_S``, ``TPUSNAP_STALL_ESCALATE``) and heartbeat
(``TPUSNAP_HEARTBEAT_FILE``), the flight recorder
(``TPUSNAP_BLACKBOX``, ``_SLOTS``, ``_SLOT_BYTES``), the sampling
profiler (``TPUSNAP_PROFILE``, ``TPUSNAP_PROFILE_HZ``) and fleet telemetry
(``TPUSNAP_FLEET_TELEMETRY``, ``_INTERVAL_S``, ``_STALE_S``).

Every other knob of the JAX package is named here too, so that none is
ignored without a word.  :data:`UNIMPLEMENTED_KNOBS` holds
``TPUSNAP_NATIVE``, whose ``0`` selects the JAX package's pure-Python data
plane (this package requires its native library):
:func:`warn_unimplemented_knobs` warns once per process when it is set.
:data:`MEANINGLESS_IN_TORCH_KNOBS` holds
``TPUSNAP_D2H_BITCAST`` and ``TPUSNAP_H2D_BITCAST``: they force the JAX
package's sub-word bitcast staging, and torch moves every dtype's bytes
through a ``view(torch.uint8)`` with no repack.
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
CACHE_DIR_ENV_VAR = _ENV_PREFIX + "CACHE_DIR"
CACHE_MAX_BYTES_ENV_VAR = _ENV_PREFIX + "CACHE_MAX_BYTES"
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
S3_ENDPOINT_ENV_VAR = _ENV_PREFIX + "S3_ENDPOINT"
S3_MULTIPART_THRESHOLD_ENV_VAR = _ENV_PREFIX + "S3_MULTIPART_THRESHOLD_BYTES"
S3_MULTIPART_PART_ENV_VAR = _ENV_PREFIX + "S3_MULTIPART_PART_BYTES"
CLOUD_PARALLEL_MIN_BYTES_ENV_VAR = _ENV_PREFIX + "CLOUD_PARALLEL_MIN_BYTES"
GCS_ENDPOINT_ENV_VAR = _ENV_PREFIX + "GCS_ENDPOINT"
D2H_BITCAST_ENV_VAR = _ENV_PREFIX + "D2H_BITCAST"
H2D_BITCAST_ENV_VAR = _ENV_PREFIX + "H2D_BITCAST"
ENABLE_SHARDED_ELASTICITY_ROOT_ONLY_ENV_VAR = _ENV_PREFIX + "ENABLE_SHARDED_ARRAY_ELASTICITY_ROOT_ONLY"
TRACE_DIR_ENV_VAR = _ENV_PREFIX + "TRACE_DIR"
METRICS_ENV_VAR = _ENV_PREFIX + "METRICS"
PROGRESS_INTERVAL_S_ENV_VAR = _ENV_PREFIX + "PROGRESS_INTERVAL_S"
STALL_TIMEOUT_S_ENV_VAR = _ENV_PREFIX + "STALL_TIMEOUT_S"
STALL_ESCALATE_ENV_VAR = _ENV_PREFIX + "STALL_ESCALATE"
HEARTBEAT_FILE_ENV_VAR = _ENV_PREFIX + "HEARTBEAT_FILE"
FLEET_TELEMETRY_ENV_VAR = _ENV_PREFIX + "FLEET_TELEMETRY"
FLEET_TELEMETRY_INTERVAL_S_ENV_VAR = _ENV_PREFIX + "FLEET_TELEMETRY_INTERVAL_S"
FLEET_TELEMETRY_STALE_S_ENV_VAR = _ENV_PREFIX + "FLEET_TELEMETRY_STALE_S"
PEER_FETCH_ENV_VAR = _ENV_PREFIX + "PEER_FETCH"
PEER_PORT_ENV_VAR = _ENV_PREFIX + "PEER_PORT"
PEER_ADDR_ENV_VAR = _ENV_PREFIX + "PEER_ADDR"
PEER_TIMEOUT_S_ENV_VAR = _ENV_PREFIX + "PEER_TIMEOUT_S"
PEER_RETRIES_ENV_VAR = _ENV_PREFIX + "PEER_RETRIES"
PEER_GRACE_S_ENV_VAR = _ENV_PREFIX + "PEER_GRACE_S"
PEER_BAD_TTL_S_ENV_VAR = _ENV_PREFIX + "PEER_BAD_TTL_S"
PEER_TRACE_MAX_SPANS_ENV_VAR = _ENV_PREFIX + "PEER_TRACE_MAX_SPANS"
PEER_TRACE_FLUSH_S_ENV_VAR = _ENV_PREFIX + "PEER_TRACE_FLUSH_S"
PEER_DEMOTE_FACTOR_ENV_VAR = _ENV_PREFIX + "PEER_DEMOTE_FACTOR"
PEERD_ACCESS_LOG_ENV_VAR = _ENV_PREFIX + "PEERD_ACCESS_LOG"
PEERD_ACCESS_LOG_MAX_BYTES_ENV_VAR = _ENV_PREFIX + "PEERD_ACCESS_LOG_MAX_BYTES"
STORE_QUARANTINE_S_ENV_VAR = _ENV_PREFIX + "STORE_QUARANTINE_S"
BLACKBOX_DIR_ENV_VAR = _ENV_PREFIX + "BLACKBOX"
BLACKBOX_SLOTS_ENV_VAR = _ENV_PREFIX + "BLACKBOX_SLOTS"
BLACKBOX_SLOT_BYTES_ENV_VAR = _ENV_PREFIX + "BLACKBOX_SLOT_BYTES"
PROFILE_DIR_ENV_VAR = _ENV_PREFIX + "PROFILE"
PROFILE_HZ_ENV_VAR = _ENV_PREFIX + "PROFILE_HZ"

# The JAX package's knobs this package reads nothing of: there is no
# pure-Python data plane to switch to.
UNIMPLEMENTED_KNOBS = (NATIVE_ENV_VAR,)
# Knobs of the JAX package with no meaning in torch (sub-word bitcast
# staging); set or not, they change nothing here.
MEANINGLESS_IN_TORCH_KNOBS = (D2H_BITCAST_ENV_VAR, H2D_BITCAST_ENV_VAR)
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
# Max payloads the fs plugin's micro-batcher groups into one native
# write+hash batch call; below the default 16 io slots, so a batch can form
# from in-flight writers while the previous batch's call runs.
_DEFAULT_NATIVE_BATCH = 8
# Peer tier (peer.py, peerd.py): a fetch times out in seconds, because a
# slow peer has a fallback (the next peer, then origin); a peer that served
# corrupt bytes or ran out of retries stays out of the candidate set for a
# minute; a peer whose latency EWMA exceeds the factor times the fleet
# median is tried last.
_DEFAULT_PEER_TIMEOUT_S = 5.0
_DEFAULT_PEER_RETRIES = 1
_DEFAULT_PEER_BAD_TTL_S = 60.0
_DEFAULT_PEER_DEMOTE_FACTOR = 3.0
# A peer daemon's server tracer keeps at most this many spans between
# flushes of its trace file, which it rewrites every few seconds.
_DEFAULT_PEER_TRACE_MAX_SPANS = 10000
_DEFAULT_PEER_TRACE_FLUSH_S = 5.0
# The daemon's access log rotates to ``<path>.1`` past this size.
_DEFAULT_PEERD_ACCESS_LOG_MAX_BYTES = 16 * 1024 * 1024
# Seconds between the scheduler's progress-table lines.
_DEFAULT_PROGRESS_INTERVAL_S = 5.0
# Flight-recorder ring geometry: 512 slots of 512 bytes (256 KiB a process).
_DEFAULT_BLACKBOX_SLOTS = 512
_DEFAULT_BLACKBOX_SLOT_BYTES = 512
# Sampling profiler: wall-clock ticks per second, 99 rather than 100 so the
# ticks do not run in lockstep with work on a round period.
_DEFAULT_PROFILE_HZ = 99.0
# Fleet telemetry: one small JSON write per op a second, and an entry older
# than 30 s is aged out (a crashed worker's stays visible as suspected-dead).
_DEFAULT_FLEET_TELEMETRY_INTERVAL_S = 1.0
_DEFAULT_FLEET_TELEMETRY_STALE_S = 30.0
# Sanitizer builds of the native library (_native/build.py).
_SUPPORTED_SANITIZERS = ("tsan", "asan", "ubsan")
# Smallest object-store read that fans out across concurrent ranged GETs
# (storage_plugins/_ranged.py).
_DEFAULT_CLOUD_PARALLEL_MIN_BYTES = 64 * 1024 * 1024


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


def get_retry_base_s(default: Optional[float] = None) -> float:
    """Base of the jittered exponential backoff (retry.backoff_s).  The
    variable, when set, overrides every layer's base, a caller's calibrated
    ``default`` included; unset, ``default`` wins, then 0.2 s."""
    val = os.environ.get(RETRY_BASE_S_ENV_VAR)
    if val is not None:
        return float(val)
    return default if default is not None else _DEFAULT_RETRY_BASE_S


def get_native_threads() -> int:
    """Size of the native library's C++ worker pool; 0 (default) sizes it
    to min(16, hardware threads).  Read once, when the library loads."""
    return max(0, _get_int_env(NATIVE_THREADS_ENV_VAR, 0))


def get_native_batch() -> int:
    """Max payloads the fs plugin's fused write+hash path groups into one
    native batch call (``TPUSNAP_NATIVE_BATCH``, default 8); 0 or 1 gives
    every payload its own call."""
    return max(0, _get_int_env(NATIVE_BATCH_ENV_VAR, _DEFAULT_NATIVE_BATCH))


def direct_io_enabled() -> bool:
    """Whether payload writes bypass the page cache (``TPUSNAP_DIRECT_IO=1``,
    off by default): io_uring where the kernel allows it, aligned pwrite
    with ``O_DIRECT`` otherwise, and buffered writes, with one
    ``native.degraded`` event, on a filesystem that rejects ``O_DIRECT``.
    The bytes on disk are identical in every mode."""
    return _get_flag_env(DIRECT_IO_ENV_VAR, "0")


def get_parallel_read_ways() -> Optional[int]:
    """Intra-file parallelism of large unchecksummed into-reads
    (``TPUSNAP_PARALLEL_READ_WAYS``): a pinned way count, or None for the
    default ``auto``, where the fs plugin measures a sequential and a
    parallel read once and keeps the faster."""
    val = os.environ.get(PARALLEL_READ_WAYS_ENV_VAR)
    if val is None or val == "auto":
        return None
    return int(val)


def get_native_sanitize() -> str:
    """The sanitizer the native library is built with
    (``TPUSNAP_NATIVE_SANITIZE``: ``tsan``, ``asan`` or ``ubsan``, each into
    its own ``libtpusnap_torch-<mode>.so``), or "" for none.  Any other
    value raises: an uninstrumented race run would report a meaningless
    "clean"."""
    val = os.environ.get(NATIVE_SANITIZE_ENV_VAR, "").strip().lower()
    if val in ("", "0", "none", "off"):
        return ""
    if val not in _SUPPORTED_SANITIZERS:
        raise ValueError(
            f"{NATIVE_SANITIZE_ENV_VAR}={val!r}: unsupported sanitizer "
            f"(supported: {', '.join(_SUPPORTED_SANITIZERS)})"
        )
    return val


def get_cloud_parallel_min_bytes() -> int:
    """Smallest S3 read that fans out across concurrent ranged requests
    (storage_plugins/_ranged.py)."""
    return _get_int_env(
        CLOUD_PARALLEL_MIN_BYTES_ENV_VAR, _DEFAULT_CLOUD_PARALLEL_MIN_BYTES
    )


def get_s3_endpoint() -> Optional[str]:
    """Override for the S3 endpoint URL (minio, a fake server); None derives
    the AWS endpoint from the bucket region."""
    val = os.environ.get(S3_ENDPOINT_ENV_VAR, "").strip()
    return val or None


def get_gcs_endpoint() -> Optional[str]:
    """Override for the GCS JSON/upload API base URL (a fake server, private
    service connect); None uses the public endpoints with credentials."""
    val = os.environ.get(GCS_ENDPOINT_ENV_VAR, "").strip()
    return val or None


def get_s3_multipart_threshold_bytes(default: int) -> int:
    """Object size above which the s3 plugin switches to multipart upload;
    the plugin passes its AWS-bound default."""
    return _get_int_env(S3_MULTIPART_THRESHOLD_ENV_VAR, default)


def get_s3_multipart_part_bytes(default: int) -> int:
    """Part size for s3 multipart uploads (AWS bounds: >=5 MB, <=10k
    parts)."""
    return _get_int_env(S3_MULTIPART_PART_ENV_VAR, default)


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


def get_cache_dir() -> Optional[str]:
    """Directory of the shared host chunk cache (``cache.py``), or None:
    caching off (the default; restores read storage directly).  Point every
    co-located worker at the same directory, so that a snapshot's payloads
    cross from origin once per host, not once per process."""
    val = os.environ.get(CACHE_DIR_ENV_VAR, "").strip()
    return val or None


def get_cache_max_bytes() -> int:
    """LRU byte bound on the cache directory; eviction (oldest access
    first) runs now and then after populates.  0 (the default) is
    unbounded: the operator owns the disk."""
    return max(0, _get_int_env(CACHE_MAX_BYTES_ENV_VAR, 0))


def peer_fetch_enabled() -> bool:
    """Whether restore and warm reads resolve cache misses peer-first
    (``TPUSNAP_PEER_FETCH``, default off).  It takes effect only with a
    cache directory (fetched chunks land there) and a coordination store
    (``TPUSNAP_STORE_PATH``/``TPUSNAP_STORE_ADDR``: daemons register there)."""
    return _get_flag_env(PEER_FETCH_ENV_VAR, "0")


def get_peer_port() -> int:
    """TCP port a peer daemon binds (0, the default: an ephemeral port,
    which the registry advertises)."""
    return max(0, _get_int_env(PEER_PORT_ENV_VAR, 0))


def get_peer_addr() -> Optional[str]:
    """Advertised ``host:port`` of this host's peer daemon, when peers must
    reach it through another interface than the one it bound."""
    val = os.environ.get(PEER_ADDR_ENV_VAR, "").strip()
    return val or None


def get_peer_timeout_s() -> float:
    """Timeout of one peer HTTP request (at least 0.05 s)."""
    val = os.environ.get(PEER_TIMEOUT_S_ENV_VAR)
    return max(0.05, float(val)) if val is not None else _DEFAULT_PEER_TIMEOUT_S


def get_peer_retries() -> int:
    """Retries of a transient failure against one peer before the next
    candidate; a 404 and a digest reject never retry."""
    return max(0, _get_int_env(PEER_RETRIES_ENV_VAR, _DEFAULT_PEER_RETRIES))


def get_peer_grace_s() -> float:
    """Age past which a daemon's unrefreshed registry stamp drops it from
    the candidates: ``TPUSNAP_LEASE_GRACE_S``'s value (its default when
    liveness is off) unless set, and at least twice the lease interval."""
    val = os.environ.get(PEER_GRACE_S_ENV_VAR)
    if val is None:
        grace = get_lease_grace_s()
        return grace if grace > 0 else _DEFAULT_LEASE_GRACE_S
    return max(float(val), 2.0 * get_lease_interval_s())


def get_peer_bad_ttl_s() -> float:
    """Seconds a peer stays quarantined after a digest reject or after
    running out of retries."""
    val = os.environ.get(PEER_BAD_TTL_S_ENV_VAR)
    return max(0.0, float(val)) if val is not None else _DEFAULT_PEER_BAD_TTL_S


def get_peer_demote_factor() -> float:
    """A peer whose latency EWMA exceeds this multiple of the fleet median
    (or whose error EWMA passes 0.5) is tried last; 0 turns demotion off."""
    val = os.environ.get(PEER_DEMOTE_FACTOR_ENV_VAR)
    return max(0.0, float(val)) if val is not None else _DEFAULT_PEER_DEMOTE_FACTOR


def get_peer_trace_max_spans() -> int:
    """Spans a peer daemon's server tracer buffers between flushes; past it
    the oldest are dropped, and the trace file's ``otherData`` counts them."""
    return max(1, _get_int_env(PEER_TRACE_MAX_SPANS_ENV_VAR, _DEFAULT_PEER_TRACE_MAX_SPANS))


def get_peer_trace_flush_s() -> float:
    """Seconds between a peer daemon's rewrites of its trace file under
    ``TPUSNAP_TRACE_DIR`` (at least 0.1)."""
    val = os.environ.get(PEER_TRACE_FLUSH_S_ENV_VAR)
    return max(0.1, float(val)) if val is not None else _DEFAULT_PEER_TRACE_FLUSH_S


def get_peerd_access_log() -> Optional[str]:
    """Path of the peer daemon's JSON-lines access log, or None.  With none
    set and a trace directory configured, the daemon logs to
    ``<TPUSNAP_TRACE_DIR>/peerd-<pid>.access.jsonl``."""
    val = os.environ.get(PEERD_ACCESS_LOG_ENV_VAR, "").strip()
    return val or None


def get_peerd_access_log_max_bytes() -> int:
    """Size past which the access log is renamed to ``<path>.1`` (one
    generation kept) and a fresh file started (at least 4096)."""
    return max(4096, _get_int_env(PEERD_ACCESS_LOG_MAX_BYTES_ENV_VAR, _DEFAULT_PEERD_ACCESS_LOG_MAX_BYTES))


def get_trace_dir() -> Optional[str]:
    """Directory of per-operation Chrome/Perfetto trace files
    (``telemetry/trace.py``), or None: tracing off (the default).  Each
    take, async_take, restore and read_object writes one
    ``<kind>-<op>-rank<r>.trace.json`` there."""
    val = os.environ.get(TRACE_DIR_ENV_VAR, "").strip()
    return val or None


def metrics_enabled() -> bool:
    """Whether the in-process metrics registry (``telemetry/metrics.py``)
    records, and the event bridge is installed at each operation.  Off by
    default: every instrumentation site returns on this check."""
    return _get_flag_env(METRICS_ENV_VAR, "0")


def is_sharded_elasticity_root_only_enabled() -> bool:
    """With it on, a restore reconciles sharded entries with the request
    only when every merged sharded entry sits directly under an app-state
    key (``key/name``); nested ones leave the manifest as it is."""
    return _get_flag_env(ENABLE_SHARDED_ELASTICITY_ROOT_ONLY_ENV_VAR, "0")


def get_progress_interval_s() -> float:
    """Seconds between the scheduler's progress-table log lines (the
    per-rank pipeline-state counts, RSS growth and budget); 0 disables the
    table.  The progress gauges refresh every loop turn regardless."""
    val = os.environ.get(PROGRESS_INTERVAL_S_ENV_VAR)
    return float(val) if val is not None else _DEFAULT_PROGRESS_INTERVAL_S


def get_stall_timeout_s() -> float:
    """Seconds of zero pipeline progress before the health monitor
    (``telemetry/monitor.py``) declares a take, async take or restore
    stalled: it writes a diagnostic bundle, emits ``watchdog.stall`` and,
    with ``TPUSNAP_STALL_ESCALATE=1``, reports the stall through the commit
    barrier's store.  0 (the default) starts no watchdog thread."""
    val = os.environ.get(STALL_TIMEOUT_S_ENV_VAR)
    return float(val) if val is not None else 0.0


def stall_escalate_enabled() -> bool:
    """Whether a detected stall wakes the peers blocked in the async commit
    barrier as ``StorePeerError`` instead of leaving them to
    ``TPUSNAP_BARRIER_TIMEOUT_S``.  Off by default: the watchdog only
    diagnoses."""
    return _get_flag_env(STALL_ESCALATE_ENV_VAR, "0")


def get_heartbeat_file() -> Optional[str]:
    """File the health monitor rewrites atomically with the progress
    snapshot every tick, for supervisors outside the process; None (the
    default) disables it."""
    val = os.environ.get(HEARTBEAT_FILE_ENV_VAR, "").strip()
    return val or None


def get_blackbox_dir() -> Optional[str]:
    """Directory of the flight recorder's per-process rings
    (``telemetry/blackbox.py``, one ``<host>-<pid>.ring`` each), or None:
    recording off (the default).  The convention is
    ``<root>/telemetry/blackbox``."""
    val = os.environ.get(BLACKBOX_DIR_ENV_VAR, "").strip()
    return val or None


def get_blackbox_slots() -> int:
    """Slots of a flight-recorder ring: the records a process keeps (older
    ones are overwritten in place)."""
    return max(8, _get_int_env(BLACKBOX_SLOTS_ENV_VAR, _DEFAULT_BLACKBOX_SLOTS))


def get_blackbox_slot_bytes() -> int:
    """Bytes of one flight-recorder slot: a record is one ``pwrite`` of
    exactly this many bytes, so a kill tears at most one slot."""
    return max(128, _get_int_env(BLACKBOX_SLOT_BYTES_ENV_VAR, _DEFAULT_BLACKBOX_SLOT_BYTES))


def get_profile_dir() -> Optional[str]:
    """Directory of the per-operation sampled CPU profiles
    (``telemetry/profiler.py``), or None: profiling off (the default).
    Each monitored take, async_take and restore writes
    ``<kind>-<op8>-rank<r>.profile.json`` (speedscope-loadable, the tpusnap
    schema under ``tpusnap``) and a ``.profile.collapsed`` flamegraph text
    there; by convention the directory of ``TPUSNAP_TRACE_DIR``."""
    val = os.environ.get(PROFILE_DIR_ENV_VAR, "").strip()
    return val or None


def get_fleet_telemetry_dir() -> Optional[str]:
    """Spool directory of fleet telemetry (``telemetry/fleet.py``), or None:
    publishing off (the default; ``0``, ``false``, ``off`` and ``none`` are
    off too).  Every monitored op writes an atomic progress and metrics entry
    there each interval and once at its end; point every worker of a job at
    one directory, by convention ``<root>/telemetry/live``."""
    val = os.environ.get(FLEET_TELEMETRY_ENV_VAR, "").strip()
    if not val or val.lower() in ("0", "false", "off", "none"):
        return None
    return val


def get_fleet_telemetry_interval_s() -> float:
    """Seconds between an op's fleet-telemetry publishes (at least 0.05);
    the terminal state publishes once more at the op's end."""
    val = os.environ.get(FLEET_TELEMETRY_INTERVAL_S_ENV_VAR)
    return max(0.05, float(val)) if val is not None else _DEFAULT_FLEET_TELEMETRY_INTERVAL_S


def get_fleet_telemetry_stale_s() -> float:
    """Age (at least 1 s) past which a spool entry counts as dead: the
    collector skips and sweeps a finished op's, and shows an in-flight op's
    as suspected-dead."""
    val = os.environ.get(FLEET_TELEMETRY_STALE_S_ENV_VAR)
    return max(1.0, float(val)) if val is not None else _DEFAULT_FLEET_TELEMETRY_STALE_S


def get_profile_hz() -> float:
    """Sampling frequency of the profiler in Hz (default 99), at most 1000.
    0 or less disables it even with ``TPUSNAP_PROFILE`` set: no sampler
    thread, no profile file.  A value that does not parse is the default."""
    val = os.environ.get(PROFILE_HZ_ENV_VAR)
    if val is None or not val.strip():
        return _DEFAULT_PROFILE_HZ
    try:
        hz = float(val)
    except ValueError:
        return _DEFAULT_PROFILE_HZ
    return 0.0 if hz <= 0 else min(hz, 1000.0)


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
    chunk store (``TPUSNAP_CAS``, cas.py).  A value pinned for the calling
    thread (:func:`override_in_thread`) comes before the environment."""
    val = _thread_value(CAS_ENV_VAR)
    if val is not None:
        return val not in ("0", "", "false", "False")
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


# The quarantine grace of the shared chunk store (store.py): the window
# between a sweep's condemn phase (orphan chunks moved into
# <store>/quarantine/<epoch>/) and its delete phase, long enough that a take
# which deduped against a chunk mid-condemnation has committed (the delete
# phase then restores the chunk) or re-written it.
_DEFAULT_STORE_QUARANTINE_S = 60.0


def get_store_url() -> Optional[str]:
    """The shared chunk store (``TPUSNAP_STORE``), or None (per-root CAS).
    When set, CAS takes write chunks to
    ``<store>/cas/<algo>/<digest[:2]>/<digest>`` instead of the root's own
    ``cas/``, and the manager's GC becomes the ledger-fenced two-phase store
    sweep (store.py).  A value pinned for the calling thread
    (:func:`override_in_thread`) comes before the environment."""
    val = _thread_value(STORE_ENV_VAR)
    if val is None:
        val = os.environ.get(STORE_ENV_VAR, "")
    return val.strip() or None


def get_store_quarantine_s() -> float:
    """Seconds a condemned chunk sits in ``<store>/quarantine/<epoch>/``
    before the sweep's delete phase may remove it (after re-checking the
    store-wide referenced set).  0 makes it eligible at once, which is safe
    only with no concurrent writer."""
    val = os.environ.get(STORE_QUARANTINE_S_ENV_VAR)
    return max(0.0, float(val)) if val is not None else _DEFAULT_STORE_QUARANTINE_S


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


# Values pinned for one thread by override_in_thread: {env var: value}.
_thread_local = threading.local()


def _thread_value(name: str) -> Optional[str]:
    return getattr(_thread_local, "values", {}).get(name)


@contextmanager
def override_in_thread(name: str, value: str) -> Generator[None, None, None]:
    """Pin one knob for the calling thread only, ahead of the environment
    (read by :func:`get_store_url` and :func:`cas_enabled`).  The manager
    pins its store and content addressing for each take this way, so two
    managers saving in two threads neither see nor leave behind each
    other's setting, as ``os.environ`` overrides would."""
    values = getattr(_thread_local, "values", None)
    if values is None:
        values = _thread_local.values = {}
    prev = values.get(name)
    values[name] = value
    try:
        yield
    finally:
        if prev is None:
            values.pop(name, None)
        else:
            values[name] = prev


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
def override_regression_factor(value: float) -> Generator[None, None, None]:
    with override_env(REGRESSION_FACTOR_ENV_VAR, str(value)):
        yield


@contextmanager
def override_regression_window(value: int) -> Generator[None, None, None]:
    with override_env(REGRESSION_WINDOW_ENV_VAR, str(value)):
        yield


@contextmanager
def override_native_batch(value: int) -> Generator[None, None, None]:
    with override_env(NATIVE_BATCH_ENV_VAR, str(value)):
        yield


@contextmanager
def override_direct_io(enabled: bool) -> Generator[None, None, None]:
    with override_env(DIRECT_IO_ENV_VAR, "1" if enabled else "0"):
        yield


@contextmanager
def override_parallel_read_ways(value: int) -> Generator[None, None, None]:
    with override_env(PARALLEL_READ_WAYS_ENV_VAR, str(value)):
        yield


@contextmanager
def override_cloud_parallel_min_bytes(value: int) -> Generator[None, None, None]:
    with override_env(CLOUD_PARALLEL_MIN_BYTES_ENV_VAR, str(value)):
        yield


@contextmanager
def override_native_sanitize(value: Optional[str]) -> Generator[None, None, None]:
    with override_env(NATIVE_SANITIZE_ENV_VAR, value):
        yield


@contextmanager
def override_store(value: Optional[str]) -> Generator[None, None, None]:
    with override_env(STORE_ENV_VAR, value):
        yield


@contextmanager
def override_store_quarantine_s(value: float) -> Generator[None, None, None]:
    with override_env(STORE_QUARANTINE_S_ENV_VAR, str(value)):
        yield


@contextmanager
def override_cache_dir(value: Optional[str]) -> Generator[None, None, None]:
    with override_env(CACHE_DIR_ENV_VAR, value):
        yield


@contextmanager
def override_cache_max_bytes(value: int) -> Generator[None, None, None]:
    with override_env(CACHE_MAX_BYTES_ENV_VAR, str(value)):
        yield


@contextmanager
def override_store_path(value: Optional[str]) -> Generator[None, None, None]:
    with override_env(STORE_PATH_ENV_VAR, value):
        yield


@contextmanager
def override_peer_fetch(enabled: bool) -> Generator[None, None, None]:
    with override_env(PEER_FETCH_ENV_VAR, "1" if enabled else None):
        yield


@contextmanager
def override_peer_addr(value: Optional[str]) -> Generator[None, None, None]:
    with override_env(PEER_ADDR_ENV_VAR, value):
        yield


@contextmanager
def override_peer_timeout_s(value: float) -> Generator[None, None, None]:
    with override_env(PEER_TIMEOUT_S_ENV_VAR, str(value)):
        yield


@contextmanager
def override_peer_retries(value: int) -> Generator[None, None, None]:
    with override_env(PEER_RETRIES_ENV_VAR, str(value)):
        yield


@contextmanager
def override_peer_grace_s(value: float) -> Generator[None, None, None]:
    with override_env(PEER_GRACE_S_ENV_VAR, str(value)):
        yield


@contextmanager
def override_peer_bad_ttl_s(value: float) -> Generator[None, None, None]:
    with override_env(PEER_BAD_TTL_S_ENV_VAR, str(value)):
        yield


@contextmanager
def override_peer_demote_factor(value: float) -> Generator[None, None, None]:
    with override_env(PEER_DEMOTE_FACTOR_ENV_VAR, str(value)):
        yield


@contextmanager
def override_trace_dir(value: Optional[str]) -> Generator[None, None, None]:
    with override_env(TRACE_DIR_ENV_VAR, value):
        yield


@contextmanager
def override_metrics(enabled: bool) -> Generator[None, None, None]:
    with override_env(METRICS_ENV_VAR, "1" if enabled else None):
        yield


@contextmanager
def override_peer_trace_max_spans(value: int) -> Generator[None, None, None]:
    with override_env(PEER_TRACE_MAX_SPANS_ENV_VAR, str(value)):
        yield


@contextmanager
def override_peer_trace_flush_s(value: float) -> Generator[None, None, None]:
    with override_env(PEER_TRACE_FLUSH_S_ENV_VAR, str(value)):
        yield


@contextmanager
def override_peerd_access_log(value: Optional[str]) -> Generator[None, None, None]:
    with override_env(PEERD_ACCESS_LOG_ENV_VAR, value):
        yield


@contextmanager
def override_peerd_access_log_max_bytes(value: int) -> Generator[None, None, None]:
    with override_env(PEERD_ACCESS_LOG_MAX_BYTES_ENV_VAR, str(value)):
        yield


@contextmanager
def override_sharded_elasticity_root_only(enabled: bool) -> Generator[None, None, None]:
    with override_env(ENABLE_SHARDED_ELASTICITY_ROOT_ONLY_ENV_VAR, "1" if enabled else None):
        yield


@contextmanager
def override_progress_interval_s(value: float) -> Generator[None, None, None]:
    with override_env(PROGRESS_INTERVAL_S_ENV_VAR, str(value)):
        yield


@contextmanager
def override_stall_timeout_s(value: float) -> Generator[None, None, None]:
    with override_env(STALL_TIMEOUT_S_ENV_VAR, str(value)):
        yield


@contextmanager
def override_stall_escalate(enabled: bool) -> Generator[None, None, None]:
    with override_env(STALL_ESCALATE_ENV_VAR, "1" if enabled else None):
        yield


@contextmanager
def override_heartbeat_file(value: Optional[str]) -> Generator[None, None, None]:
    with override_env(HEARTBEAT_FILE_ENV_VAR, value):
        yield


@contextmanager
def override_blackbox_dir(value: Optional[str]) -> Generator[None, None, None]:
    with override_env(BLACKBOX_DIR_ENV_VAR, value):
        yield


@contextmanager
def override_blackbox_slots(value: int) -> Generator[None, None, None]:
    with override_env(BLACKBOX_SLOTS_ENV_VAR, str(value)):
        yield


@contextmanager
def override_blackbox_slot_bytes(value: int) -> Generator[None, None, None]:
    with override_env(BLACKBOX_SLOT_BYTES_ENV_VAR, str(value)):
        yield


@contextmanager
def override_fleet_telemetry(value: Optional[str]) -> Generator[None, None, None]:
    with override_env(FLEET_TELEMETRY_ENV_VAR, value):
        yield


@contextmanager
def override_fleet_telemetry_interval_s(value: float) -> Generator[None, None, None]:
    with override_env(FLEET_TELEMETRY_INTERVAL_S_ENV_VAR, str(value)):
        yield


@contextmanager
def override_fleet_telemetry_stale_s(value: float) -> Generator[None, None, None]:
    with override_env(FLEET_TELEMETRY_STALE_S_ENV_VAR, str(value)):
        yield


@contextmanager
def override_profile_dir(value: Optional[str]) -> Generator[None, None, None]:
    with override_env(PROFILE_DIR_ENV_VAR, value):
        yield


@contextmanager
def override_profile_hz(value: float) -> Generator[None, None, None]:
    with override_env(PROFILE_HZ_ENV_VAR, str(value)):
        yield
