"""In-memory storage fake for tests (counterpart of
``torchsnapshot_tpu/storage_plugins/memory.py``): a class-level registry
keyed by root, so take and restore in one process share state.  It writes
no digests itself, so the scheduler hashes each staged buffer before the
write."""

from __future__ import annotations

import threading
from typing import Dict, Optional

from .. import phase_stats
from ..io_types import ReadIO, StoragePlugin, WriteIO, contiguous

_REGISTRY: Dict[str, Dict[str, bytes]] = {}
_LOCK = threading.Lock()


class MemoryStoragePlugin(StoragePlugin):
    def __init__(self, root: str) -> None:
        self.root = root
        with _LOCK:
            self._files = _REGISTRY.setdefault(root, {})

    async def write(self, write_io: WriteIO) -> None:
        data = contiguous(write_io.buf)
        with phase_stats.timed("mem_write", memoryview(data).nbytes):
            data = bytes(data)
            with _LOCK:
                self._files[write_io.path] = data

    async def read(self, read_io: ReadIO) -> None:
        with _LOCK:
            data = self._files.get(read_io.path)
        if data is None:
            raise FileNotFoundError(read_io.path)
        if read_io.byte_range is not None:
            offset, end = read_io.byte_range
            data = data[offset:end]
        with phase_stats.timed("mem_read", len(data)):
            read_io.buf = bytearray(data)

    async def exists(self, path: str) -> bool:
        with _LOCK:
            return path in self._files

    async def delete(self, path: str) -> None:
        with _LOCK:
            if self._files.pop(path, None) is None:
                raise FileNotFoundError(path)

    async def delete_dir(self, path: str) -> None:
        prefix = path.rstrip("/") + "/" if path else ""
        with _LOCK:
            for k in [k for k in self._files if k.startswith(prefix)]:
                del self._files[k]

    async def close(self) -> None:
        pass

    @classmethod
    def reset(cls, root: Optional[str] = None) -> None:
        with _LOCK:
            if root is None:
                _REGISTRY.clear()
            else:
                _REGISTRY.pop(root, None)
