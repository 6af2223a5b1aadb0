"""Core I/O contracts: write/read requests, stagers, consumers, storage ABC.

Counterpart of ``torchsnapshot_tpu/io_types.py``.  A ``WriteReq`` pairs a
storage path with a ``BufferStager`` that produces host bytes (for CUDA
tensors: a pinned host buffer filled by an async D2H copy); a ``ReadReq``
pairs a path and byte range with a ``BufferConsumer`` that moves the bytes
into the restore target (for CUDA targets: an async H2D copy).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Callable, Generic, List, Optional, TypeVar

from .utils.loops import run_coro

BufferType = Any  # bytes | bytearray | memoryview | ScatterBuffer

T = TypeVar("T")


class ScatterBuffer:
    """Ordered host buffers forming one logical payload (a slab).

    Storage that writes scatter-gather (the native fs data plane) writes
    the parts from their own memory; others call :meth:`join` — one
    memcpy, the contiguous-slab behaviour.
    """

    __slots__ = ("parts", "nbytes")

    def __init__(self, parts) -> None:
        self.parts = [memoryview(p).cast("B") for p in parts]
        self.nbytes = sum(p.nbytes for p in self.parts)

    def join(self) -> memoryview:
        from . import phase_stats

        if len(self.parts) == 1:
            return self.parts[0]
        out = bytearray(self.nbytes)
        offset = 0
        with phase_stats.timed("slab_pack", self.nbytes):
            for part in self.parts:
                out[offset : offset + part.nbytes] = part
                offset += part.nbytes
        return memoryview(out)


def contiguous(buf: BufferType) -> BufferType:
    """The payload as one contiguous buffer (joins a ScatterBuffer)."""
    return buf.join() if isinstance(buf, ScatterBuffer) else buf


class Future(Generic[T]):
    """Holds a value produced during read consumption."""

    def __init__(self, obj: Optional[T] = None) -> None:
        self.obj = obj


@dataclass
class WriteIO:
    path: str
    buf: BufferType
    # Crash-durability request (the ``.snapshot_metadata`` commit marker):
    # fs fsyncs the file before and its directory after the atomic rename.
    durable: bool = False
    # Fused write+hash request (scheduler → plugins advertising
    # ``supports_write_hash``): the plugin fills ``part_hash64`` with one
    # digest per part (ScatterBuffer members in order, or the whole buffer).
    want_part_hashes: bool = False
    part_hash64: Optional[List[int]] = None
    # Scheduler hint that sibling writes are in flight or queued: a plugin
    # that micro-batches small fused writes into one native call (fs with
    # TPUSNAP_NATIVE_BATCH) routes this write through its group-commit
    # gate.  False for a lone write, which skips the gate.
    batch_hint: bool = False


@dataclass
class ReadIO:
    path: str
    byte_range: Optional[List[int]] = None
    buf: Optional[Any] = None
    # Preallocated destination the plugin reads straight into (it then sets
    # buf = into and the consumer skips its copy).
    into: Optional[memoryview] = None
    # Set when the consumer verifies the WHOLE payload against a recorded
    # digest of algorithm ``hash_algo``: a plugin that can fuse hashing into
    # the read does so and sets ``hash64``.
    want_hash: bool = False
    hash_algo: Optional[str] = None
    hash64: Optional[int] = None


class BufferStager(abc.ABC):
    """Produces the host buffer for one write."""

    @abc.abstractmethod
    async def stage_buffer(self, executor: Any = None) -> BufferType:
        ...

    @abc.abstractmethod
    def get_staging_cost_bytes(self) -> int:
        """Peak transient host memory needed to stage (admission control)."""
        ...


@dataclass
class WriteReq:
    path: str
    buffer_stager: BufferStager


class BufferConsumer(abc.ABC):
    """Consumes the bytes read for one request."""

    @abc.abstractmethod
    async def consume_buffer(self, buf: BufferType, executor: Any = None) -> None:
        ...

    @abc.abstractmethod
    def get_consuming_cost_bytes(self) -> int:
        ...


@dataclass
class ReadReq:
    path: str
    buffer_consumer: BufferConsumer
    byte_range: Optional[List[int]] = None
    # Tiled reads (one tensor split under a buffer budget) are never merged.
    no_merge: bool = False
    # Read-into-place destination, fixed at plan time (CPU targets) ...
    into: Optional[memoryview] = None
    # ... or allocated when the scheduler admits the read (the pinned host
    # buffer of a CUDA target, so pinned memory stays under the read budget).
    # Requests carrying either are never merged.
    into_factory: Optional[Callable[[], memoryview]] = None


class StoragePlugin(abc.ABC):
    """Async storage backend contract."""

    # True when write() consumes a ScatterBuffer part-by-part with no join.
    supports_scatter: bool = False

    # True when write() honours WriteIO.want_part_hashes; for everything
    # else the scheduler hashes the staged buffer before the write, so
    # manifests are identical either way.
    supports_write_hash: bool = False

    @abc.abstractmethod
    async def write(self, write_io: WriteIO) -> None:
        ...

    @abc.abstractmethod
    async def read(self, read_io: ReadIO) -> None:
        ...

    @abc.abstractmethod
    async def exists(self, path: str) -> bool:
        ...

    @abc.abstractmethod
    async def delete(self, path: str) -> None:
        ...

    @abc.abstractmethod
    async def delete_dir(self, path: str) -> None:
        ...

    @abc.abstractmethod
    async def close(self) -> None:
        ...

    async def list_dir(self, path: str) -> List[str]:
        """Immediate child names under ``path`` (files and directory-like
        prefixes); raises NotImplementedError where the backend cannot list."""
        raise NotImplementedError(f"{type(self).__name__} cannot list")

    async def copy_from_sibling(self, src_root: str, path: str) -> bool:
        """Duplicate ``src_root``'s ``path`` (a sibling snapshot on the same
        backend) into this plugin's ``path`` without moving the bytes
        through this host.  False when the backend cannot (the caller then
        writes normally): incremental takes use it for unchanged payloads."""
        return False

    def sync_write(self, write_io: WriteIO) -> None:
        run_coro(lambda: self.write(write_io))

    def sync_read(self, read_io: ReadIO) -> None:
        run_coro(lambda: self.read(read_io))

    def sync_exists(self, path: str) -> bool:
        return run_coro(lambda: self.exists(path))

    def sync_list_dir(self, path: str) -> List[str]:
        return run_coro(lambda: self.list_dir(path))

    def sync_delete(self, path: str) -> None:
        run_coro(lambda: self.delete(path))

    def sync_delete_dir(self, path: str) -> None:
        run_coro(lambda: self.delete_dir(path))

    def sync_close(self) -> None:
        run_coro(lambda: self.close())
