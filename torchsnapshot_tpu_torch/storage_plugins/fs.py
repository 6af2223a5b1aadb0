"""Local/posix filesystem storage plugin (counterpart of
``torchsnapshot_tpu/storage_plugins/fs.py``).

Every payload moves through the native data plane (native_io), with the
GIL released for the whole C call:

- writes land in a temp file then ``os.replace`` (readers never see a
  partial payload); with ``WriteIO.want_part_hashes`` the write and each
  part's digest are one fused call (``supports_write_hash``), and slabs
  write their parts scatter-gather (``supports_scatter``);
- ``durable`` writes (the ``.snapshot_metadata`` commit) fsync the file
  before and the directory after the rename;
- reads go through one parallel multi-range pread: a read whose consumer
  verifies a digest gets it fused with the read — striped "xxh64s"
  payloads read and hash their stripes in parallel, plain "xxh64" payloads
  stream sequentially — and an unverified large read splits into
  ``PARALLEL_READ_CHUNK_BYTES`` ranges (at most ``PARALLEL_READ_MAX_WAYS``).
"""

from __future__ import annotations

import asyncio
import itertools
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Set, Tuple

from .. import integrity, phase_stats
from ..io_types import ReadIO, ScatterBuffer, StoragePlugin, WriteIO
from ..native_io import NativeFileIO

# Taken from torchsnapshot_tpu/storage_plugins/_ranged.py: the intra-file
# chunk size and way cap of parallel reads.
PARALLEL_READ_CHUNK_BYTES = 32 * 1024 * 1024
PARALLEL_READ_MAX_WAYS = 8

_DEFAULT_IO_THREADS = 16

# Per-process sequence for unique temp-file names.
_TMP_SEQ = itertools.count()


def _split_ranges(offset: int, nbytes: int) -> List[Tuple[int, int]]:
    """``[(start, end), ...]`` covering ``[offset, offset + nbytes)``: one
    range, or up to PARALLEL_READ_MAX_WAYS for a large read."""
    ways = min(PARALLEL_READ_MAX_WAYS, max(1, nbytes // PARALLEL_READ_CHUNK_BYTES))
    step = -(-nbytes // ways) if nbytes else 0
    if ways <= 1 or step == 0:
        return [(offset, offset + nbytes)]
    return [
        (offset + o, offset + min(o + step, nbytes)) for o in range(0, nbytes, step)
    ]


class FSStoragePlugin(StoragePlugin):
    supports_scatter = True
    supports_write_hash = True

    def __init__(self, root: str) -> None:
        self.root = root
        self._native = NativeFileIO.get()
        self._dir_cache: Set[str] = set()
        self._executor = ThreadPoolExecutor(
            max_workers=_DEFAULT_IO_THREADS, thread_name_prefix="fs_io"
        )

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
                if fused:
                    write_io.part_hash64 = self._native.write_parts_hash(tmp, parts)
                else:
                    self._native.write_file_parts(tmp, parts)
                if write_io.durable:
                    _fsync_path(tmp)
                os.replace(tmp, path)
                if write_io.durable:
                    _fsync_path(os.path.dirname(path) or ".")
        except BaseException:
            if os.path.exists(tmp):  # unique per call: no other writer
                os.unlink(tmp)
            raise

    def _blocking_read(self, path: str, read_io: ReadIO) -> Tuple[object, Optional[int]]:
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
            buf = bytearray(nbytes)
        view = memoryview(buf).cast("B")
        want_hash = read_io.want_hash and integrity.checksums_enabled()
        with phase_stats.timed("native_read", nbytes):
            if want_hash:
                # One range: the native call hashes it fused with the read
                # (striped and parallel for xxh64s-sized payloads).  The
                # algo is the size policy's, which is what was recorded.
                hashes = self._native.read_ranges_into(
                    path, [(offset, end)], [view], want_hash=True
                )
                hash64 = hashes[0] if hashes else None
                if integrity.digest_algo_for(nbytes) != read_io.hash_algo:
                    hash64 = None  # a digest of another algo: verify re-hashes
            else:
                ranges = _split_ranges(offset, nbytes)
                views = [view[s - offset : e - offset] for s, e in ranges]
                self._native.read_ranges_into(path, ranges, views)
                hash64 = None
        return buf, hash64

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
