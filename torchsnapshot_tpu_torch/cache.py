"""Shared host-side chunk cache: the checkpoint-serving read tier.

Counterpart of ``torchsnapshot_tpu/cache.py``, on the same on-disk format,
so both packages share one cache directory on a host.  Many co-located
workers restoring one snapshot point ``TPUSNAP_CACHE_DIR`` at the same
directory, and each byte crosses from origin once per host:

- **Keys.**  Content-addressed chunks (``cas://<algo>/<digest>``) key on
  their digest (``cas/<algo>/<hex>``), shared across snapshots and steps;
  ``casx://`` locations on a digest of the location (``casx/<sha1[:24]>``);
  every other payload on ``obj/<fingerprint>/<path>``, the fingerprint a
  digest of the commit marker's JSON, so a step pruned and re-saved with
  other content never serves stale bytes.  A ranged read's key appends
  ``@<start>-<end>``.
- **Layout.**  One data file per entry under
  ``<dir>/objects/<sha1(key)[:2]>/<sha1(key)>`` and a ``.meta`` JSON
  record (``key``, ``nbytes``, ``digest``) written after the data: a
  reader needs the meta, so a torn populate is a miss, never a short
  read.  Eviction and the tmp sweep serialize on an advisory ``flock`` of
  ``<dir>/.tpusnap_cache.lock``.
- **Populate.**  tmp (``.tmp.<pid>.<tid>``) + rename.  A whole CAS chunk
  must hash to its name before it is cached; every entry records its
  digest, checked on whole reads and on the first ranged slice of it in a
  process, so a corrupt cache file is dropped and re-fetched from origin.
  Concurrent cold reads of one key single-flight through a per-key
  ``flock`` (``<data>.lock``): one process fetches, the rest wait and hit.
- **Eviction.**  LRU by access time under ``TPUSNAP_CACHE_MAX_BYTES``
  (0 = unbounded).  A reader opens an fd before it reads, so an eviction's
  unlink never truncates a read in flight.

Hits are read by the native library (``native_io``), straight into the
caller's buffer (a pinned restore buffer needs no intermediate copy).
Installed by the snapshot read paths outside the CAS reader, so chunk
digests are the keys, and inside the peer tier (peer.py), which fetches
missing chunks from other hosts into it; the fault wrapper sits below it,
so a hit bypasses origin faults as it bypasses origin latency.
"""

from __future__ import annotations

import asyncio
import fcntl
import hashlib
import json
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import cas, integrity, knobs, peer, phase_stats
from .event import Event
from .event_handlers import log_event
from .telemetry import metrics as tmetrics
from .io_types import ReadIO, StoragePlugin, WriteIO
from .manifest import iter_payload_entries
from .native_io import NativeFileIO
from .serialization import array_nbytes

logger = logging.getLogger(__name__)

_META_SUFFIX = ".meta"
_LOCK_SUFFIX = ".lock"
_MAINT_LOCK = ".tpusnap_cache.lock"
# Eviction walks the cache directory; amortize it over this many populates.
_EVICT_CHECK_EVERY = 16
# How long a cold miss waits for a sibling's in-flight populate before
# fetching origin itself (a timeout only duplicates traffic).
_POPULATE_LOCK_TIMEOUT_S = 120.0
# tmp files older than this are a crashed populate's debris (a live
# populate holds its key's lock and finishes within minutes).
_STALE_TMP_AGE_S = 3600.0


# ------------------------------------------------------- process-wide totals

_TOTALS_LOCK = threading.Lock()
_TOTALS: Dict[str, int] = {
    "hits": 0,
    "misses": 0,
    "hit_bytes": 0,
    "miss_bytes": 0,
    "evictions": 0,
    "evicted_bytes": 0,
}


def process_stats() -> Dict[str, int]:
    """This process's cache outcomes (each reader folds its counters in
    when it closes): bytes served from the cache against bytes fetched
    from origin."""
    with _TOTALS_LOCK:
        return dict(_TOTALS)


def reset_process_stats() -> None:
    with _TOTALS_LOCK:
        for k in _TOTALS:
            _TOTALS[k] = 0


def _add_totals(**deltas: int) -> None:
    with _TOTALS_LOCK:
        for k, v in deltas.items():
            _TOTALS[k] += v


# ----------------------------------------------------------------- key model


def snapshot_fingerprint(metadata: Any) -> str:
    """Namespace of a snapshot's non-CAS keys: a digest of its metadata
    JSON, equal in both packages for one commit marker.  Two snapshots
    with identical manifests share entries; a step rewritten with other
    content never aliases."""
    return hashlib.sha1(metadata.to_json().encode("utf-8")).hexdigest()[:16]


def full_key_for(namespace: str, path: str) -> Tuple[str, Optional[str]]:
    """``(whole-object key, expected digest or None)`` for a storage path.
    A ``cas://`` location keys on its digest, which it must hash to; a
    ``casx://`` location on a digest of the location (an ordered digest
    list, so a content identity too); everything else under the snapshot
    fingerprint."""
    if cas.is_cas_location(path):
        algo, hexdigest = cas.parse_cas_location(path)
        return f"cas/{algo}/{hexdigest}", f"{algo}:{hexdigest}"
    if cas.is_casx_location(path):
        spec = hashlib.sha1(path.encode("utf-8")).hexdigest()[:24]
        return f"casx/{spec}", None
    return f"obj/{namespace}/{path}", None


def keys_for(
    namespace: str, path: str, byte_range: Optional[List[int]]
) -> Tuple[str, Optional[str], Optional[str]]:
    """``(exact key, whole-object key or None, expected digest of a whole
    CAS entry)``.  A ranged read's exact key embeds the range; its
    whole-object key lets a warmed whole entry serve any range."""
    full, expect = full_key_for(namespace, path)
    if byte_range is None:
        return full, None, expect
    return f"{full}@{byte_range[0]}-{byte_range[1]}", full, expect


# ---------------------------------------------------------------- the store


class CacheStore:
    """The on-disk cache.  Every method may block on disk: callers run them
    on an executor."""

    def __init__(self, root: str, max_bytes: Optional[int] = None) -> None:
        self.root = root
        self.max_bytes = knobs.get_cache_max_bytes() if max_bytes is None else max_bytes
        self._objects = os.path.join(root, "objects")
        os.makedirs(self._objects, exist_ok=True)
        self._populates_since_check = 0
        self._lock = threading.Lock()
        # Keys whose whole content this process verified against the
        # recorded digest: the first ranged slice of an entry reads and
        # hashes all of it (a torn populate is only detectable that way),
        # later slices read just their range.
        self._verified_keys: set = set()
        self._native = NativeFileIO.get()

    # -------------------------------------------------------------- layout

    def _paths(self, key: str) -> Tuple[str, str]:
        h = hashlib.sha1(key.encode("utf-8")).hexdigest()
        d = os.path.join(self._objects, h[:2])
        return os.path.join(d, h), os.path.join(d, h + _META_SUFFIX)

    @staticmethod
    def _read_meta(meta_path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(meta_path, "r", encoding="utf-8") as f:
                doc = json.loads(f.read())
        except (OSError, ValueError):
            return None
        if not isinstance(doc, dict) or "nbytes" not in doc:
            return None
        return doc

    # --------------------------------------------------------------- reads

    def get(
        self,
        key: str,
        into: Optional[memoryview] = None,
        byte_range: Optional[List[int]] = None,
    ):
        """The entry's bytes (or ``True`` once ``into`` is filled), or None
        on a miss.  ``byte_range`` slices a range out of a whole-object
        entry.  A whole read verifies the recorded digest, and so does the
        first ranged slice of an entry in this process; a mismatch drops
        the entry and reports a miss, so the caller re-fetches origin.

        An fd on the data file is opened, and its size checked, before any
        byte moves: an eviction's unlink cannot truncate this read (the
        inode lives while the fd does), and if the name is already gone
        the bytes come through the held fd."""
        data_path, meta_path = self._paths(key)
        meta = self._read_meta(meta_path)
        if meta is None:
            return None
        nbytes = int(meta["nbytes"])
        start, end = (byte_range[0], byte_range[1]) if byte_range is not None else (0, nbytes)
        if end > nbytes or start < 0:
            return None
        if into is not None:
            dest = memoryview(into).cast("B")
            if dest.nbytes != end - start:
                return None
        else:
            dest = self._alloc(end - start)
        with self._lock:
            full_verify = byte_range is not None and bool(meta.get("digest")) and key not in self._verified_keys
        if full_verify:
            read_start, read_view = 0, self._alloc(nbytes)
        else:
            read_start, read_view = start, dest
        try:
            fd = os.open(data_path, os.O_RDONLY)
        except OSError:
            return None
        try:
            if os.fstat(fd).st_size != nbytes:
                self._drop(key)  # torn or foreign debris
                return None
            ok = self._read_into(fd, data_path, read_start, read_view)
        finally:
            os.close(fd)
        if not ok:
            self._drop(key)
            return None
        if byte_range is None or full_verify:
            if not self._verify(meta, read_view):
                logger.warning("cache entry %s failed verification; dropping and re-fetching from origin", key)
                self._drop(key)
                return None
            with self._lock:
                self._verified_keys.add(key)
        if full_verify:
            dest[:] = read_view[start:end]
        try:
            os.utime(data_path)  # LRU touch (best effort)
        except OSError:
            pass
        return True if into is not None else dest

    @staticmethod
    def _alloc(nbytes: int) -> memoryview:
        # np.empty, not bytearray: bytearray(n) zeroes n bytes under the GIL.
        return memoryview(np.empty(nbytes, dtype=np.uint8))

    def _read_into(self, fd: int, data_path: str, start: int, dest: memoryview) -> bool:
        """Fill ``dest`` from the entry at byte ``start`` with the native
        library's parallel pread.  It opens by path: when an eviction has
        already unlinked the name, the held ``fd`` serves the bytes (the
        eviction-safety contract).  Any other failure is a miss."""
        try:
            self._native.read_ranges_into(data_path, [(start, start + dest.nbytes)], [dest])
            return True
        except FileNotFoundError:
            pass
        except OSError:
            return False
        filled = 0
        while filled < dest.nbytes:
            n = os.preadv(fd, [dest[filled:]], start + filled)
            if not n:
                return False
            filled += n
        return True

    @staticmethod
    def _verify(meta: Dict[str, Any], data) -> bool:
        expected = meta.get("digest")
        if not expected:
            return True  # populated with no digest: nothing to check against
        return integrity.digest_as(data, expected) == expected

    def resident_nbytes(self, key: str) -> Optional[int]:
        """Size of a resident entry, or None.  Reads the meta only."""
        data_path, meta_path = self._paths(key)
        meta = self._read_meta(meta_path)
        if meta is None or not os.path.exists(data_path):
            return None
        return int(meta["nbytes"])

    # --------------------------------------------------------------- writes

    def put(self, key: str, data, expect_digest: Optional[str] = None) -> bool:
        """Populate ``key`` atomically (tmp + rename, data before meta).
        ``expect_digest``: the content's known digest (a whole CAS chunk's
        name), checked BEFORE caching, so a corrupt origin fetch is never
        cached as verified.  Returns False when that check or the write
        failed; the caller still holds the origin bytes, so a failed
        populate never fails the read."""
        view = memoryview(data).cast("B")
        digest = integrity.digest_as(view, expect_digest)
        if expect_digest is not None and digest != expect_digest:
            logger.warning("refusing to cache %s: content hashes to %s", key, digest)
            return False
        data_path, meta_path = self._paths(key)
        suffix = f".tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            os.makedirs(os.path.dirname(data_path), exist_ok=True)
            tmp = data_path + suffix
            with open(tmp, "wb") as f:
                f.write(view)
            # Entries verify themselves on read, so a crash-torn rename is
            # detected and re-fetched: no fsync on this hot path.
            # tpusnap-lint: disable=durability-flow
            os.replace(tmp, data_path)
            mtmp = meta_path + suffix
            with open(mtmp, "w", encoding="utf-8") as f:
                f.write(json.dumps({"key": key, "nbytes": view.nbytes, "digest": digest}))
            # tpusnap-lint: disable=durability-flow
            os.replace(mtmp, meta_path)
        except OSError:
            logger.warning("cache populate failed for %s", key, exc_info=True)
            return False
        with self._lock:
            # Fresh content: a slice-path verification of the replaced
            # entry no longer holds.
            self._verified_keys.discard(key)
            self._populates_since_check += 1
            check = self._populates_since_check >= _EVICT_CHECK_EVERY
            if check:
                self._populates_since_check = 0
        if check:
            self.maybe_evict()
        return True

    def _drop(self, key: str) -> None:
        with self._lock:
            self._verified_keys.discard(key)
        for p in reversed(self._paths(key)):  # meta first
            try:
                os.unlink(p)
            except OSError:
                pass

    # ------------------------------------------------------- populate lock

    def try_acquire_populate_lock(self, key: str) -> Optional[int]:
        """One NON-blocking attempt at the per-key populate lock.  Returns
        the held fd (release with :meth:`release_populate_lock`), or None
        when a sibling holds it or locking is unavailable.  It never
        blocks: callers poll from their event loop, because a blocking
        flock on a bounded executor can starve the very populate it waits
        for.  The lock dies with its holder (flock semantics)."""
        data_path, _ = self._paths(key)
        lock_path = data_path + _LOCK_SUFFIX
        try:
            os.makedirs(os.path.dirname(lock_path), exist_ok=True)
            fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        except OSError:
            return None
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return None
        return fd

    @staticmethod
    def release_populate_lock(fd: Optional[int]) -> None:
        if fd is None:
            return
        try:
            fcntl.flock(fd, fcntl.LOCK_UN)
        except OSError:
            pass
        os.close(fd)

    # ------------------------------------------------------------ eviction

    def _walk_entries(self) -> List[Tuple[float, int, str, str]]:
        """``(access time, nbytes, data path, meta path)`` of every complete
        entry, oldest access first."""
        out = []
        for dirpath, _, files in os.walk(self._objects):
            for name in files:
                if name.endswith((_META_SUFFIX, _LOCK_SUFFIX)) or ".tmp." in name:
                    continue
                data_path = os.path.join(dirpath, name)
                try:
                    st = os.stat(data_path)
                except OSError:
                    continue
                out.append((max(st.st_mtime, st.st_atime), st.st_size, data_path, data_path + _META_SUFFIX))
        out.sort()
        return out

    def _sweep_stale_tmp(self) -> None:
        """Unlink tmp files of crashed populates.  Eviction does not see
        them (a live populate's tmp must not go under it), so without this
        a SIGKILL mid-put leaks a file the byte bound never counts."""
        cutoff = time.time() - _STALE_TMP_AGE_S
        for dirpath, _, files in os.walk(self._objects):
            for name in files:
                if ".tmp." not in name:
                    continue
                path = os.path.join(dirpath, name)
                try:
                    if os.stat(path).st_mtime < cutoff:
                        os.unlink(path)
                except OSError:
                    continue

    def stats(self) -> Dict[str, int]:
        entries = self._walk_entries()
        return {"entries": len(entries), "bytes": sum(e[1] for e in entries), "max_bytes": self.max_bytes}

    def maybe_evict(self) -> int:
        """Evict least-recently-used entries until the cache fits its byte
        bound; returns the bytes reclaimed.  Serialized across processes on
        a non-blocking advisory lock (a sibling already sweeping does this
        pass's work)."""
        try:
            lock_fd = os.open(os.path.join(self.root, _MAINT_LOCK), os.O_CREAT | os.O_RDWR, 0o644)
        except OSError:
            return 0
        try:
            try:
                fcntl.flock(lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                return 0
            self._sweep_stale_tmp()
            if not self.max_bytes:
                return 0
            entries = self._walk_entries()
            total = sum(e[1] for e in entries)
            evicted_bytes = evicted = 0
            for _, nbytes, data_path, meta_path in entries:
                if total - evicted_bytes <= self.max_bytes:
                    break
                for p in (meta_path, data_path):
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
                evicted_bytes += nbytes
                evicted += 1
            if evicted:
                _add_totals(evictions=evicted, evicted_bytes=evicted_bytes)
                tmetrics.record_cache_evicted(evicted, evicted_bytes)
                log_event(
                    Event(
                        name="cache.evict",
                        metadata={"entries": evicted, "bytes": evicted_bytes, "max_bytes": self.max_bytes},
                    )
                )
                logger.info(
                    "cache: evicted %d entr%s (%.1f MB) to fit %.1f MB bound",
                    evicted,
                    "y" if evicted == 1 else "ies",
                    evicted_bytes / 1e6,
                    self.max_bytes / 1e6,
                )
            return evicted_bytes
        finally:
            os.close(lock_fd)


# ------------------------------------------------------------ reader plugin


class CacheReaderPlugin(StoragePlugin):
    """Serves payload reads from the shared host cache, populating on miss.

    Writes, deletes and listings pass straight through.  Protocol metadata
    (dot-files, ``telemetry/``) is never cached: the commit marker's
    absence is itself a signal."""

    def __init__(self, inner: StoragePlugin, store: CacheStore, namespace: str) -> None:
        self._inner = inner
        self._store = store
        self._ns = namespace
        self.supports_scatter = getattr(inner, "supports_scatter", False)
        self.supports_write_hash = getattr(inner, "supports_write_hash", False)
        # Own pool, larger than the io-concurrency cap: lock waiters park
        # here during a sibling's populate, and sharing the inner plugin's
        # pool could deadlock the populate behind its own waiters.
        self._executor = ThreadPoolExecutor(max_workers=32, thread_name_prefix="tpusnap_cache")
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.miss_bytes = 0
        self._closed = False

    @property
    def store(self) -> CacheStore:
        return self._store

    @property
    def namespace(self) -> str:
        return self._ns

    @staticmethod
    def _cacheable(path: str) -> bool:
        name = path.rsplit("/", 1)[-1]
        return not (path.startswith(".") or name.startswith(".") or path.startswith("telemetry/"))

    def _try_get(
        self,
        exact_key: str,
        full_key: Optional[str],
        byte_range: Optional[List[int]],
        into: Optional[memoryview],
    ):
        """The exact key first, then a ranged slice of a resident whole
        object."""
        hit = self._store.get(exact_key, into=into)
        if hit is not None:
            return hit
        if full_key is not None:
            return self._store.get(full_key, into=into, byte_range=byte_range)
        return None

    def _probe_resident(self, exact_key: str, full_key: Optional[str], byte_range: Optional[List[int]]) -> bool:
        """Meta-only residency probe: the only cache work done under the
        populate lock (reading data under it would queue every waiter's
        copy behind one flock)."""
        if self._store.resident_nbytes(exact_key) is not None:
            return True
        if full_key is not None:
            nbytes = self._store.resident_nbytes(full_key)
            if nbytes is not None and (byte_range is None or byte_range[1] <= nbytes):
                return True
        return False

    def _record_hit(self, nbytes: int) -> None:
        with self._lock:
            self.hits += 1
            self.hit_bytes += nbytes

    def _record_miss(self, nbytes: int) -> None:
        with self._lock:
            self.misses += 1
            self.miss_bytes += nbytes

    @staticmethod
    def _record_wait(wait_s: float, path: str) -> None:
        """One finished single-flight wait on a sibling's populate."""
        phase_stats.add("cache_wait", wait_s)
        tmetrics.record_cache_wait(wait_s)
        log_event(Event(name="cache.wait", metadata={"path": path, "wait_s": round(wait_s, 4)}))

    async def read(self, read_io: ReadIO) -> None:
        if not self._cacheable(read_io.path):
            await self._inner.read(read_io)
            return
        exact_key, full_key, expect = keys_for(self._ns, read_io.path, read_io.byte_range)
        loop = asyncio.get_running_loop()

        def _lookup():
            begin = time.monotonic()
            hit = self._try_get(exact_key, full_key, read_io.byte_range, read_io.into)
            if hit is not None:
                nbytes = memoryview(read_io.into).nbytes if hit is True else len(hit)
                phase_stats.add("cache_read", time.monotonic() - begin, nbytes)
            return hit

        hit = await loop.run_in_executor(self._executor, _lookup)
        if hit is None:
            # Single-flight the cold fetch: poll the per-key lock with
            # non-blocking attempts from this loop (waiters sleep here, not
            # in executor threads).  A sibling's populate landing ends the
            # wait early; on timeout the fetch goes lock-less (duplicated
            # origin traffic, never an error).
            lock_fd = None
            deadline = loop.time() + _POPULATE_LOCK_TIMEOUT_S
            wait_begin = loop.time()
            wait_turns = 0
            while True:
                lock_fd = await loop.run_in_executor(self._executor, self._store.try_acquire_populate_lock, exact_key)
                if lock_fd is not None or loop.time() >= deadline:
                    break
                wait_turns += 1
                await asyncio.sleep(0.02)
                if await loop.run_in_executor(
                    self._executor, self._probe_resident, exact_key, full_key, read_io.byte_range
                ):
                    break
            if wait_turns:
                self._record_wait(loop.time() - wait_begin, read_io.path)
            try:
                resident = await loop.run_in_executor(
                    self._executor, self._probe_resident, exact_key, full_key, read_io.byte_range
                )
                if not resident:
                    await self._inner.read(read_io)
                    # The populate is awaited before this read returns, so
                    # the caller cannot touch buf meanwhile: no copy.
                    data = memoryview(read_io.buf).cast("B")
                    self._record_miss(data.nbytes)

                    def _populate() -> None:
                        with phase_stats.timed("cache_populate", data.nbytes):
                            self._store.put(exact_key, data, expect_digest=expect if read_io.byte_range is None else None)

                    await loop.run_in_executor(self._executor, _populate)
                    return
            finally:
                await loop.run_in_executor(self._executor, self._store.release_populate_lock, lock_fd)
            # A sibling populated while this one queued: read it outside
            # the lock.  A failed read here (evicted or corrupt in the
            # window) goes to origin.
            hit = await loop.run_in_executor(self._executor, _lookup)
            if hit is None:
                await self._inner.read(read_io)
                self._record_miss(memoryview(read_io.buf).nbytes)
                return
        if hit is True:
            read_io.buf = read_io.into
            nbytes = memoryview(read_io.into).nbytes
        else:
            read_io.buf = hit
            nbytes = len(hit)
        read_io.hash64 = None  # the consumer verifies with its own pass
        self._record_hit(nbytes)

    # ------------------------------------------------------- passthroughs

    async def write(self, write_io: WriteIO) -> None:
        await self._inner.write(write_io)

    async def exists(self, path: str) -> bool:
        return await self._inner.exists(path)

    async def list_dir(self, path: str) -> List[str]:
        return await self._inner.list_dir(path)

    async def delete(self, path: str) -> None:
        await self._inner.delete(path)

    async def delete_dir(self, path: str) -> None:
        await self._inner.delete_dir(path)

    async def copy_from_sibling(self, src_root: str, path: str) -> bool:
        return await self._inner.copy_from_sibling(src_root, path)

    async def close(self) -> None:
        self._emit_summary()
        try:
            await self._inner.close()
        finally:
            # Every read awaited its executor work, so the pool is idle.
            self._executor.shutdown(wait=True)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_bytes": self.hit_bytes,
                "miss_bytes": self.miss_bytes,
            }

    def _emit_summary(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            hits, misses = self.hits, self.misses
            hit_bytes, miss_bytes = self.hit_bytes, self.miss_bytes
        if not (hits or misses):
            return
        _add_totals(hits=hits, misses=misses, hit_bytes=hit_bytes, miss_bytes=miss_bytes)
        tmetrics.record_cache(hits, misses, hit_bytes, miss_bytes)
        if hits:
            log_event(Event(name="cache.hit", metadata={"count": hits, "bytes": hit_bytes}))
        if misses:
            log_event(Event(name="cache.miss", metadata={"count": misses, "bytes": miss_bytes}))
        logger.debug(
            "cache: %d hits (%.1f MB local), %d misses (%.1f MB from origin)",
            hits,
            hit_bytes / 1e6,
            misses,
            miss_bytes / 1e6,
        )


# ----------------------------------------------------------------- wiring


def maybe_wrap_cache_reads(storage: StoragePlugin, metadata: Any) -> StoragePlugin:
    """Wrap a snapshot's (possibly CAS-wrapped) read storage with the host
    cache when ``TPUSNAP_CACHE_DIR`` is set, and the cache with the peer
    tier (peer.py) when ``TPUSNAP_PEER_FETCH`` and a coordination store are
    set: a local hit never touches the network, a miss asks the fleet
    before origin.  A directory that cannot be set up warns and leaves
    reads on origin: the cache is never needed for a correct result."""
    cache_dir = knobs.get_cache_dir()
    if not cache_dir:
        return storage
    try:
        store = CacheStore(cache_dir)
    except OSError:
        logger.warning("chunk cache disabled: cannot initialize %s", cache_dir, exc_info=True)
        return storage
    reader = CacheReaderPlugin(inner=storage, store=store, namespace=snapshot_fingerprint(metadata))
    return peer.maybe_wrap_peer_reads(reader)


def find_reader(storage: StoragePlugin) -> Optional[CacheReaderPlugin]:
    """The CacheReaderPlugin in a wrapped storage stack, or None."""
    for _ in range(8):
        if storage is None:
            return None
        if isinstance(storage, CacheReaderPlugin):
            return storage
        storage = getattr(storage, "_inner", None)
    return None


def reader_stats(storage: StoragePlugin) -> Optional[Dict[str, int]]:
    reader = find_reader(storage)
    return reader.stats() if reader is not None else None


# -------------------------------------------------------------------- warm


def payload_locations(metadata: Any) -> List[Tuple[str, int]]:
    """Distinct ``(location, best-known nbytes)`` of every payload a
    manifest references: the unit a warm pre-faults (whole objects, so any
    later ranged read slices a resident entry)."""
    sizes: Dict[str, int] = {}
    for _, entry in iter_payload_entries(metadata.manifest):
        byte_range = getattr(entry, "byte_range", None)
        if byte_range:
            size = int(byte_range[1])
        else:
            try:
                size = array_nbytes(entry.shape, entry.dtype)
            except (AttributeError, ValueError):
                size = 0
        sizes[entry.location] = max(sizes.get(entry.location, 0), size)
    return sorted(sizes.items())


def warm_snapshot(
    storage: StoragePlugin,
    metadata: Any,
    concurrency: int = 8,
    max_in_flight_bytes: int = 2 << 30,
    items: Optional[List[Tuple[str, int]]] = None,
) -> Dict[str, int]:
    """Pre-fault every payload of a snapshot into the cache: one whole read
    per distinct location through ``storage`` (already cache- and
    CAS-wrapped), over a thread pool.  In-flight bytes stay under
    ``max_in_flight_bytes`` (each object is buffered whole until its
    populate lands; an object over the limit is admitted alone).  ``items``
    narrows the warm to some locations (a rollout warms a step's delta).
    Returns the totals: locations, bytes, the cache reader's hits and
    misses, and, through the peer tier, its counts as ``peer_*``."""
    if items is None:
        items = payload_locations(metadata)
    limit = max(1, max_in_flight_bytes)
    cv = threading.Condition()
    in_flight = [0]

    def _one(item: Tuple[str, int]) -> int:
        location, expected = item
        cost = min(max(expected, 1), limit)
        with cv:
            while in_flight[0] + cost > limit:
                cv.wait(0.2)
            in_flight[0] += cost
        try:
            read_io = ReadIO(path=location)
            storage.sync_read(read_io)
            return memoryview(read_io.buf).nbytes
        finally:
            with cv:
                in_flight[0] -= cost
                cv.notify_all()

    total_bytes = 0
    with ThreadPoolExecutor(max_workers=max(1, concurrency), thread_name_prefix="tpusnap_warm") as pool:
        for nbytes in pool.map(_one, items):
            total_bytes += nbytes
    out = {"locations": len(items), "bytes": total_bytes}
    stats = reader_stats(storage)
    if stats is not None:
        out.update(stats)
    pstats = peer.reader_stats(storage)
    if pstats is not None:
        out.update({f"peer_{k}": v for k, v in pstats.items()})
    return out


def residency(store: CacheStore, metadata: Any, namespace: str) -> Dict[str, int]:
    """How much of a snapshot's payload set is resident (whole-object
    entries only; range-keyed entries are not counted)."""
    items = payload_locations(metadata)
    resident = resident_bytes = total_bytes = 0
    for location, nbytes in items:
        total_bytes += nbytes
        key, _ = full_key_for(namespace, location)
        got = store.resident_nbytes(key)
        if got is not None:
            resident += 1
            resident_bytes += got
    return {
        "locations": len(items),
        "resident": resident,
        "bytes_total": total_bytes,
        "bytes_resident": resident_bytes,
    }
