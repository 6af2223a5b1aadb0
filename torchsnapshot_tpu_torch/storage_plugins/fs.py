"""Local/posix filesystem storage plugin (counterpart of
``torchsnapshot_tpu/storage_plugins/fs.py``).

Every payload moves through the native data plane (native_io), with the
GIL released for the whole C call:

- writes land in a temp file then ``os.replace`` (readers never see a
  partial payload); with ``WriteIO.want_part_hashes`` the write and each
  part's digest are one fused call (``supports_write_hash``), and slabs
  write their parts scatter-gather (``supports_scatter``);
- small fused writes that arrive while sibling writes are in flight
  (``WriteIO.batch_hint``) coalesce into one native batch call
  (:class:`_FusedWriteBatcher`, ``TPUSNAP_NATIVE_BATCH``);
- ``TPUSNAP_DIRECT_IO=1`` moves the process's payload writes off the page
  cache (io_uring, else ``O_DIRECT`` pwrite, else buffered with one
  ``native.degraded`` event);
- ``durable`` writes (the ``.snapshot_metadata`` commit) fsync the file
  before and the directory after the rename;
- reads land in the caller's ``into`` buffer, or in an uninitialised one
  of the range's length: a read whose consumer verifies a digest gets it
  fused with the read (striped "xxh64s" payloads read and hash their
  stripes in parallel, plain "xxh64" payloads stream sequentially); an
  unverified read of ``_PARALLEL_READ_MIN_BYTES`` or more takes the faster
  of one sequential stream and the native parallel read, measured once per
  plugin and re-measured every ``_ADAPTIVE_REPROBE_EVERY`` reads, unless
  ``TPUSNAP_PARALLEL_READ_WAYS`` pins it; smaller ones read sequentially.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Set, Tuple

import numpy as np

from .. import integrity, knobs, phase_stats
from ..io_types import ReadIO, ScatterBuffer, StoragePlugin, WriteIO
from ..native_io import NativeFileIO

_DEFAULT_IO_THREADS = 16
_PARALLEL_READ_MIN_BYTES = 64 * 1024 * 1024
_ADAPTIVE_REPROBE_EVERY = 16

# Only payloads at or below this join a micro-batch: the gain is per-call
# dispatch, which matters for small files, and a large slab behind the gate
# would serialise its siblings behind its write.
_BATCH_MAX_MEMBER_BYTES = 8 * 1024 * 1024

# Per-process sequence for unique temp-file names.
_TMP_SEQ = itertools.count()


class _FusedWriteBatcher:
    """Group-commit gate in front of ``write_parts_hash_batch``: small fused
    writes arriving on concurrent fs_io threads coalesce into ONE native
    call and one pool submission per batch.

    No gather window: the first free member leads whatever is pending right
    now (possibly itself alone, which costs what the single call costs), and
    members arriving while that call runs pile up for the next leader, so a
    batch's size follows arrival rate times call duration and a lone write
    never waits on a gate nobody else joins.  A member's failure is its own
    (its OSError re-raises on its own thread); a failed whole call falls
    back to one native single call per member."""

    def __init__(self, native: NativeFileIO, max_batch: int) -> None:
        self._native = native
        self._max = max_batch
        self._cond = threading.Condition()
        self._pending: list = []
        self._leader_active = False

    def write(self, path: str, parts) -> List[int]:
        """Write ``parts`` to ``path`` in the current batch; blocks until
        this member's digests are back, and raises its own OSError."""
        member = {"path": path, "parts": parts, "done": False, "result": None, "error": None}
        begin = time.monotonic()
        with self._cond:
            self._pending.append(member)
            while not member["done"]:
                if self._leader_active or not self._pending:
                    # A batch is running (ours may be in it): wait for the
                    # results or for the next leadership vacancy.
                    self._cond.wait()
                    continue
                # Lead: take up to max_batch pending members and run them
                # outside the lock.
                self._leader_active = True
                batch = self._pending[: self._max]
                del self._pending[: self._max]
                self._cond.release()
                try:
                    self._execute(batch)
                finally:
                    self._cond.acquire()
                    self._leader_active = False
                    self._cond.notify_all()
        phase_stats.add(
            "native_write_batched",
            time.monotonic() - begin,
            sum(memoryview(p).nbytes for p in parts),
        )
        if member["error"] is not None:
            raise member["error"]
        return member["result"]

    def _execute(self, batch: list) -> None:
        # Every member must come out done (result or error): a member left
        # pending would park its fs_io thread for good.
        try:
            nbytes = sum(memoryview(p).nbytes for m in batch for p in m["parts"])
            try:
                with phase_stats.timed("native_write_batch", nbytes):
                    results = self._native.write_parts_hash_batch(
                        [(m["path"], m["parts"]) for m in batch]
                    )
            except Exception:  # noqa: BLE001 — the whole call failed
                results = None
            if results is None:
                for m in batch:
                    try:
                        m["result"] = self._native.write_parts_hash(m["path"], m["parts"])
                    except Exception as e:  # noqa: BLE001 — re-raised by its member
                        m["error"] = e
            else:
                for m, res in zip(batch, results):
                    if isinstance(res, OSError):
                        m["error"] = res
                    else:
                        m["result"] = res
        finally:
            with self._cond:
                for m in batch:
                    if m["result"] is None and m["error"] is None:
                        m["error"] = RuntimeError(f"batched write of {m['path']} aborted")
                    m["done"] = True
                self._cond.notify_all()


class FSStoragePlugin(StoragePlugin):
    supports_scatter = True
    supports_write_hash = True

    def __init__(self, root: str) -> None:
        self.root = root
        knobs.get_native_sanitize()  # a typo raises, also once loaded
        self._native = NativeFileIO.get()
        self._dir_cache: Set[str] = set()
        self._executor = ThreadPoolExecutor(
            max_workers=_DEFAULT_IO_THREADS, thread_name_prefix="fs_io"
        )
        # The direct-I/O mode is process-global (one atomic in the native
        # library) and the knob is its source of truth.  It is set only
        # when the knob disagrees with it: setting it from every plugin
        # would flip it under sibling plugins mid-take and clear the
        # buffered fallback a rejected O_DIRECT left.
        self._direct_io = knobs.direct_io_enabled()
        if self._direct_io != (self._native.direct_io_mode() != 0):
            self._native.configure_direct_io(self._direct_io)
        batch_max = knobs.get_native_batch()
        self._write_batcher = (
            _FusedWriteBatcher(self._native, batch_max) if batch_max > 1 else None
        )
        # The adaptive strategy of large unchecksummed reads: the first two
        # qualifying reads measure sequential and parallel, and the faster
        # sticks.  No static choice is right everywhere: a sequential stream
        # rides the kernel's readahead, parallel reads fill an NVMe queue.
        self._adaptive_lock = threading.Lock()
        self._seq_gbps: Optional[float] = None
        self._par_gbps: Optional[float] = None
        self._reads_since_probe = 0

    def _prepare_parent(self, path: str) -> None:
        parent = os.path.dirname(path)
        if parent not in self._dir_cache:
            os.makedirs(parent, exist_ok=True)
            self._dir_cache.add(parent)

    def _blocking_write(self, path: str, write_io: WriteIO) -> None:
        self._prepare_parent(path)
        # Unique per call: two writers of one path must not share a temp.
        tmp = f"{path}.tmp.{os.getpid()}.{next(_TMP_SEQ)}"
        buf = write_io.buf
        parts = buf.parts if isinstance(buf, ScatterBuffer) else [buf]
        nbytes = sum(memoryview(p).nbytes for p in parts)
        fused = write_io.want_part_hashes
        try:
            with phase_stats.timed("native_write_hash" if fused else "fs_write", nbytes):
                if fused and (
                    self._write_batcher is not None
                    and write_io.batch_hint
                    and nbytes <= _BATCH_MAX_MEMBER_BYTES
                ):
                    write_io.part_hash64 = self._write_batcher.write(tmp, parts)
                elif fused:
                    write_io.part_hash64 = self._native.write_parts_hash(tmp, parts)
                else:
                    self._native.write_file_parts(tmp, parts)
                if write_io.durable:
                    _fsync_path(tmp)
                os.replace(tmp, path)
                if write_io.durable:
                    _fsync_path(os.path.dirname(path) or ".")
            if self._direct_io:
                # One event per process if this write (or an earlier one)
                # fell back to buffered I/O.
                self._native.check_direct_io_degrade()
        except BaseException:
            if os.path.exists(tmp):  # unique per call: no other writer
                os.unlink(tmp)
            raise

    def _blocking_read(self, path: str, read_io: ReadIO) -> Tuple[object, Optional[int]]:
        begin = time.monotonic()
        if read_io.byte_range is None:
            offset, end = 0, self._native.file_size(path)
        else:
            offset, end = read_io.byte_range
        nbytes = end - offset
        if read_io.into is not None:
            buf = read_io.into
            if memoryview(buf).nbytes != nbytes:
                raise ValueError(
                    f"into-view is {memoryview(buf).nbytes} bytes, range is {nbytes}"
                )
        else:
            # Every byte is overwritten by the read: no zero fill.
            buf = memoryview(np.empty(nbytes, dtype=np.uint8))
        view = memoryview(buf).cast("B")
        hash64, phase = self._read_into(path, offset, view, read_io)
        phase_stats.add(phase, time.monotonic() - begin, nbytes)
        return buf, hash64

    def _read_into(
        self, path: str, offset: int, view: memoryview, read_io: ReadIO
    ) -> Tuple[Optional[int], str]:
        """Fill ``view`` from ``[offset, offset + view.nbytes)``; returns the
        read-fused digest (or None) and the phase the read ran under."""
        nbytes = view.nbytes
        if read_io.want_hash and integrity.checksums_enabled():
            # One range: the native call hashes it fused with the read
            # (striped and parallel for xxh64s-sized payloads).  The algo is
            # the size policy's, which is what was recorded.
            hashes = self._native.read_ranges_into(
                path, [(offset, offset + nbytes)], [view], want_hash=True
            )
            hash64 = hashes[0] if hashes else None
            if integrity.digest_algo_for(nbytes) != read_io.hash_algo:
                hash64 = None  # a digest of another algo: verify re-hashes
            return hash64, "native_read"
        if nbytes >= _PARALLEL_READ_MIN_BYTES and self._use_parallel():
            return None, self._timed_parallel(path, offset, view)
        self._timed_sequential(path, offset, view, record=nbytes >= _PARALLEL_READ_MIN_BYTES)
        return None, "fs_read"

    def _use_parallel(self) -> bool:
        """The strategy of a large unchecksummed read: a pinned
        ``TPUSNAP_PARALLEL_READ_WAYS`` wins; otherwise the first qualifying
        read measures sequential, the next parallel, then the faster is
        used, and every ``_ADAPTIVE_REPROBE_EVERY`` reads the slower is
        measured again (one early sample, cold or contended, must not decide
        for the plugin's lifetime)."""
        pinned = knobs.get_parallel_read_ways()
        if pinned is not None:
            return pinned > 1
        with self._adaptive_lock:
            if self._seq_gbps is None:
                return False
            if self._par_gbps is None:
                return True
            self._reads_since_probe += 1
            if self._reads_since_probe >= _ADAPTIVE_REPROBE_EVERY:
                self._reads_since_probe = 0
                if self._par_gbps > self._seq_gbps:
                    self._seq_gbps = None  # this read re-measures sequential
                    return False
                self._par_gbps = None
                return True
            return self._par_gbps > self._seq_gbps

    def _timed_sequential(self, path: str, offset: int, view: memoryview, record: bool) -> None:
        begin = time.monotonic()
        self._native.read_file_into(path, offset, view)
        if record:
            gbps = view.nbytes / 1e9 / max(time.monotonic() - begin, 1e-6)
            with self._adaptive_lock:
                if self._seq_gbps is None:
                    self._seq_gbps = gbps

    def _timed_parallel(self, path: str, offset: int, view: memoryview) -> str:
        begin = time.monotonic()
        phase = self._parallel_read_into(path, offset, view)
        gbps = view.nbytes / 1e9 / max(time.monotonic() - begin, 1e-6)
        with self._adaptive_lock:
            if self._par_gbps is None:
                self._par_gbps = gbps
        return phase

    def _parallel_read_into(self, path: str, offset: int, view: memoryview) -> str:
        """The parallel unchecksummed read: ONE native multi-range call,
        which splits the range into 8 MiB pread tasks on the native pool, so
        its width is the pool's (a pinned way count above 1 selects it)."""
        self._native.read_ranges_into(path, [(offset, offset + view.nbytes)], [view])
        return "native_read"

    async def write(self, write_io: WriteIO) -> None:
        path = os.path.join(self.root, write_io.path)
        await asyncio.get_running_loop().run_in_executor(
            self._executor, self._blocking_write, path, write_io
        )

    async def read(self, read_io: ReadIO) -> None:
        path = os.path.join(self.root, read_io.path)
        read_io.buf, read_io.hash64 = await asyncio.get_running_loop().run_in_executor(
            self._executor, self._blocking_read, path, read_io
        )

    def _get_executor(self) -> ThreadPoolExecutor:
        return self._executor

    async def list_dir(self, path: str) -> List[str]:
        try:
            return sorted(os.listdir(os.path.join(self.root, path)))
        except FileNotFoundError:
            return []

    async def copy_from_sibling(self, src_root: str, path: str) -> bool:
        """A hard link from the sibling snapshot: no bytes move, the new
        snapshot stays self-contained, and removing the base is safe."""

        def _link() -> bool:
            src = os.path.join(src_root, path)
            dst = os.path.join(self.root, path)
            try:
                self._prepare_parent(dst)
                if os.path.exists(dst):
                    os.unlink(dst)
                os.link(src, dst)
                return True
            except OSError:
                return False

        return await asyncio.get_running_loop().run_in_executor(self._executor, _link)

    async def exists(self, path: str) -> bool:
        # os.stat, not os.path.exists: permission/transport errors propagate.
        try:
            os.stat(os.path.join(self.root, path))
            return True
        except (FileNotFoundError, NotADirectoryError):
            return False

    async def delete(self, path: str) -> None:
        os.remove(os.path.join(self.root, path))

    async def delete_dir(self, path: str) -> None:
        shutil.rmtree(os.path.join(self.root, path), ignore_errors=True)

    async def close(self) -> None:
        self._executor.shutdown()


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
