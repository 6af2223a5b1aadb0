"""In-memory storage fake for tests (counterpart of
``torchsnapshot_tpu/storage_plugins/memory.py``): a class-level registry
keyed by root, so take and restore in one process share state.  It writes
no digests itself, so the scheduler hashes each staged buffer before the
write."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .. import phase_stats
from ..io_types import ReadIO, StoragePlugin, WriteIO, contiguous

_REGISTRY: Dict[str, Dict[str, bytes]] = {}
_LOCK = threading.Lock()


class MemoryStoragePlugin(StoragePlugin):
    def __init__(self, root: str) -> None:
        self.root = root
        with _LOCK:
            self._files = _REGISTRY.setdefault(root, {})

    def _resolve(self, path: str):
        """(files, key) owning ``path``: the nested registry whose root
        prefixes it (a root-level plugin addressing
        ``step_1/.snapshot_metadata`` must reach what the step's own plugin
        wrote), else this plugin's own files.  Called under ``_LOCK``."""
        if path not in self._files:
            full = f"{self.root}/{path}"
            for reg_root, files in _REGISTRY.items():
                if reg_root != self.root and full.startswith(reg_root + "/"):
                    return files, full[len(reg_root) + 1 :]
        return self._files, path

    async def write(self, write_io: WriteIO) -> None:
        data = contiguous(write_io.buf)
        with phase_stats.timed("mem_write", memoryview(data).nbytes):
            data = bytes(data)
            with _LOCK:
                files, key = self._resolve(write_io.path)
                files[key] = data

    async def read(self, read_io: ReadIO) -> None:
        with _LOCK:
            files, key = self._resolve(read_io.path)
            data = files.get(key)
        if data is None:
            raise FileNotFoundError(read_io.path)
        if read_io.byte_range is not None:
            offset, end = read_io.byte_range
            data = data[offset:end]
        with phase_stats.timed("mem_read", len(data)):
            read_io.buf = bytearray(data)

    async def exists(self, path: str) -> bool:
        with _LOCK:
            files, key = self._resolve(path)
            return key in files

    async def list_dir(self, path: str) -> List[str]:
        prefix = path.rstrip("/") + "/" if path else ""
        base = f"{self.root}/{path}".rstrip("/")
        children = set()
        with _LOCK:
            for key in self._files:
                if key.startswith(prefix):
                    children.add(key[len(prefix) :].split("/", 1)[0])
            for reg_root, files in _REGISTRY.items():
                if reg_root.startswith(base + "/") and files:
                    children.add(reg_root[len(base) + 1 :].split("/", 1)[0])
        return sorted(c for c in children if c)

    async def delete(self, path: str) -> None:
        with _LOCK:
            files, key = self._resolve(path)
            if files.pop(key, None) is None:
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
