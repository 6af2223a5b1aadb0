"""Per-tensor write/read planning: the core preparer.

Counterpart of ``torchsnapshot_tpu/io_preparers/array.py``.  Differences by
design:

- JAX arrays are immutable, so the JAX package assembles restored bytes in
  a host buffer and builds a NEW array (``ArrayAssembly.finalize``,
  ``_device_put_like``).  Torch tensors are mutable: this port restores IN
  PLACE into the caller's tensor, as upstream torchsnapshot does — the same
  ``data_ptr()`` before and after.
- CPU targets that are contiguous and of the entry's dtype and shape are
  read into place: storage preads land straight in the tensor's memory.
- CUDA targets read each piece into a pinned host buffer (allocated when
  the scheduler admits the read, so pinned memory stays under the read
  budget) and copy it into the target's bytes with
  ``copy_(non_blocking=True)`` on a side stream (:class:`H2DBatcher`).  A
  target of another dtype, or a non-contiguous one, receives the bytes in a
  device temporary first and then ``target.copy_(temp)`` on the same
  stream, which converts like ``np.copyto``.

Compression (``TPUSNAP_COMPRESSION``): the codec is chosen at plan time
from the payload's size (:func:`plan_codec`), the stager frames the staged
bytes on the pipeline's executor (compression.py) and the frame is what
storage writes and what the checksum covers.  A framed payload is read
whole (byte offsets inside a frame mean nothing, so no tiles and no
read-into-place), verified, then decoded straight into its destination:
the CPU target's own bytes, or a pinned buffer of the piece's size that
is then uploaded like any other piece.
"""

from __future__ import annotations

import asyncio
import math
import threading
import time
from collections import deque
from concurrent.futures import Executor
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import compression, integrity, knobs, phase_stats, serialization
from ..io_types import (
    BufferConsumer,
    BufferStager,
    BufferType,
    Future,
    ReadReq,
    WriteReq,
)
from ..manifest import TensorEntry
from ..serialization import Serializer
from ..staging import begin_d2h, finish_d2h, is_cuda_tensor, pinned_empty

# Pieces below this read through the batcher's merged spanning reads
# instead of into their own destination.
_INTO_PLACE_MIN_BYTES = 1 << 20
# Pieces above this verify/copy on the executor instead of the event loop.
_EXECUTOR_MIN_BYTES = 1 << 20


def plan_codec(nbytes: int) -> Optional[str]:
    """The codec a payload of ``nbytes`` will be framed with, decided at
    plan time (the batcher must know which payloads keep their
    dtype×shape size), or None for bare bytes: below the size floor, or
    when the configured codec has no backend here (the save then stays in
    the bare format)."""
    codec, _ = knobs.get_compression()
    if codec == "raw" or nbytes < knobs.get_compression_min_bytes():
        return None
    resolved = compression.resolve(codec)
    return None if resolved == "raw" else resolved


def _dtype_of(obj: Any) -> Any:
    return obj.dtype if isinstance(obj, torch.Tensor) else np.asarray(obj).dtype


def _is_contiguous(obj: Any) -> bool:
    if isinstance(obj, torch.Tensor):
        return obj.is_contiguous()
    return np.asarray(obj).flags.c_contiguous


class ArrayIOPreparer:
    @classmethod
    def prepare_write(
        cls, storage_path: str, obj: Any, is_async_snapshot: bool = False
    ) -> Tuple[TensorEntry, List[WriteReq]]:
        entry = TensorEntry(
            location=storage_path,
            serializer=Serializer.BUFFER_PROTOCOL.value,
            dtype=serialization.dtype_to_string(_dtype_of(obj)),
            shape=list(np.shape(obj)) if not isinstance(obj, torch.Tensor)
            else list(obj.shape),
            replicated=False,
        )
        # The stager frames at stage time and may record "raw" (framed,
        # not compressed) when the payload does not shrink.
        entry.codec = plan_codec(serialization.array_nbytes(entry.shape, entry.dtype))
        stager = ArrayBufferStager(
            obj=obj, entry=entry, is_async_snapshot=is_async_snapshot
        )
        return entry, [WriteReq(path=storage_path, buffer_stager=stager)]

    @staticmethod
    def can_load_inplace(entry: TensorEntry, obj: Any) -> bool:
        """Read-into-place needs a writable CPU tensor or numpy array,
        contiguous, of the entry's dtype and shape."""
        if isinstance(obj, torch.Tensor):
            if obj.is_cuda or not obj.is_contiguous():
                return False
            if obj.is_conj() or obj.is_neg():
                return False
            if list(obj.shape) != list(entry.shape):
                return False
            return serialization.is_supported_dtype(obj.dtype) and (
                serialization.dtype_to_string(obj.dtype) == entry.dtype
            )
        if not isinstance(obj, np.ndarray) or not obj.flags.writeable:
            return False
        if not obj.flags.c_contiguous or list(obj.shape) != list(entry.shape):
            return False
        return str(obj.dtype) == entry.dtype

    @classmethod
    def prepare_read(
        cls,
        entry: TensorEntry,
        obj_out: Optional[Any] = None,
        buffer_size_limit_bytes: Optional[int] = None,
        h2d_batch: Optional["H2DBatcher"] = None,
        device: Optional[torch.device] = None,
    ) -> Tuple[List[ReadReq], Future]:
        """Plan reads for one tensor entry.

        ``obj_out``: a tensor or numpy array restored in place where
        possible; None → a fresh tensor on ``device`` (CPU when None).
        ``h2d_batch`` carries the uploads of CUDA targets; the owner drains
        it after the read pipeline.
        """
        assembly = ArrayAssembly(
            entry=entry, obj_out=obj_out, h2d_batch=h2d_batch, device=device
        )
        total = serialization.array_nbytes(entry.shape, entry.dtype)
        if (
            compression.is_framed(entry)
            or buffer_size_limit_bytes is None
            or buffer_size_limit_bytes <= 0
            or total <= buffer_size_limit_bytes
        ):
            read_reqs = [
                assembly.read_req(
                    entry.location,
                    entry.byte_range,
                    flat_offset=0,
                    nbytes=total,
                    checksum=entry.checksum,
                    frame_entry=entry,
                )
            ]
        else:
            # Tiled read: byte-ranged pieces each under the limit.  Partial
            # payloads are never verified (checksum=None) nor merged.
            base = entry.byte_range[0] if entry.byte_range else 0
            tile = math.ceil(total / math.ceil(total / buffer_size_limit_bytes))
            read_reqs = []
            for offset in range(0, total, tile):
                length = min(tile, total - offset)
                read_reqs.append(
                    assembly.read_req(
                        entry.location,
                        [base + offset, base + offset + length],
                        flat_offset=offset,
                        nbytes=length,
                        no_merge=True,
                    )
                )
        assembly.expect(len(read_reqs))
        return read_reqs, assembly.fut


class ArrayBufferStager(BufferStager):
    """Stages one tensor or numpy array.  ``is_async_snapshot`` (an async
    take in host mode) copies a CPU value instead of viewing it: JAX arrays
    are immutable, but torch CPU tensors and numpy arrays are not, and the
    caller may mutate them as soon as ``async_take`` returns."""

    def __init__(self, obj: Any, entry: TensorEntry, is_async_snapshot: bool = False) -> None:
        self._obj = obj
        self._entry = entry
        self._is_async_snapshot = is_async_snapshot
        # Deferred-digest contract with the scheduler: one sink per buffer
        # part, resolved at write time — fused into the native write+hash
        # where the storage supports it, else by one pre-write hash pass.
        self.hash_sinks: Optional[list] = None

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        obj = self._obj
        if is_cuda_tensor(obj):
            # Enqueue the D2H copy now (the scheduler just admitted this
            # stager) and wait for it on the executor, so concurrent
            # stagers' copies overlap.
            handle = begin_d2h(obj)
            if executor is not None:
                host = await asyncio.get_running_loop().run_in_executor(
                    executor, finish_d2h, handle
                )
            else:
                host = finish_d2h(handle)
        else:
            host = serialization.host_bytes(obj)
            if self._is_async_snapshot and _is_contiguous(obj):
                # A contiguous value was viewed in place; a non-contiguous
                # one was already copied by host_bytes.
                host = host.copy()
        self._obj = None
        mv = serialization.array_as_memoryview(host)
        entry = self._entry
        if compression.is_framed(entry):
            # Frame on the executor, so one payload's codec pass overlaps
            # other stagers' D2H and the writes in flight.  The digest
            # covers the frame: the bytes storage writes.
            level = knobs.get_compression()[1]
            if executor is not None and mv.nbytes > _EXECUTOR_MIN_BYTES:
                frame, inner = await asyncio.get_running_loop().run_in_executor(
                    executor, compression.encode, mv, entry.codec, level
                )
            else:
                frame, inner = compression.encode(mv, entry.codec, level)
            del mv, host  # the staged copy (a pinned buffer) goes back now
            entry.codec = inner
            entry.compressed_nbytes = memoryview(frame).nbytes
            mv = memoryview(frame).cast("B")
        if integrity.save_checksums_enabled():

            def _set(digest_str) -> None:
                entry.checksum = digest_str

            self.hash_sinks = [_set]
        return mv

    @property
    def source(self) -> Any:
        """The value this stager writes."""
        return self._obj

    def restage(self, staged: Any) -> None:
        """Swap in a snapshot-stable copy of the value (a device-staged
        async take): staging then copies nothing more."""
        self._obj = staged
        self._is_async_snapshot = False

    def get_staging_cost_bytes(self) -> int:
        """A CUDA tensor costs its pinned host buffer (plus its contiguous
        device copy when it is not contiguous); a contiguous CPU value is
        viewed in place and costs nothing, unless an async take copies it.
        A framed payload adds its frame (at most the payload's size: the
        raw-in-frame fallback bounds it), since the staged bytes and the
        frame coexist while the codec runs; the scheduler credits back
        down to the frame's size once staged, which is where a good ratio
        hands budget to the next stager."""
        nbytes = serialization.array_nbytes(self._entry.shape, self._entry.dtype)
        frame = nbytes if compression.is_framed(self._entry) else 0
        obj = self._obj
        contiguous = _is_contiguous(obj)
        if is_cuda_tensor(obj):
            return (nbytes if contiguous else 2 * nbytes) + frame
        return (0 if contiguous and not self._is_async_snapshot else nbytes) + frame


class H2DBatcher:
    """Paced host→device uploads for the restore path (counterpart of
    ``torchsnapshot_tpu/io_preparers/array.py`` ``H2DBatcher``).

    Each upload is a ``copy_(non_blocking=True)`` from a pinned buffer on a
    side stream (one per device, which first waits on the caller's current
    stream) followed by a recorded event.  The pacing contract:

    - the bytes dispatched but not yet landed stay under
      ``inflight_cap_bytes``: a new upload first waits on the oldest events;
    - a pinned buffer (and a device temporary) is held until its event has
      fired, so it is never freed or reused under an in-flight copy;
    - :meth:`drain` returns only when every upload has landed.

    Dispatch time lands in the ``h2d_dispatch`` phase and landing waits in
    ``h2d_land``, both with bytes.  Thread-safe: uploads come from the read
    pipeline's loop thread, drain from the caller.
    """

    _DEFAULT_INFLIGHT_CAP_BYTES = 512 << 20

    def __init__(self, inflight_cap_bytes: int = _DEFAULT_INFLIGHT_CAP_BYTES) -> None:
        self._cap = inflight_cap_bytes
        self._lock = threading.Lock()
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        # (event, objects kept alive until it fires, bytes)
        self._inflight: Deque[Tuple[Any, Tuple[Any, ...], int]] = deque()
        self._unlanded_bytes = 0
        self.uploaded_bytes = 0

    def _side_stream(self, device: torch.device) -> "torch.cuda.Stream":
        # Called under the lock.  The side stream re-syncs with the caller's
        # current stream before every enqueue, so the copy lands after any
        # work the caller queued on its target.
        stream = self._streams.get(device)
        if stream is None:
            stream = torch.cuda.Stream(device=device)
            self._streams[device] = stream
        stream.wait_stream(torch.cuda.current_stream(device))
        return stream

    def upload(self, src: torch.Tensor, dst_u8: torch.Tensor) -> None:
        """Copy the pinned uint8 ``src`` into the device uint8 view
        ``dst_u8`` (same length)."""
        nbytes = src.numel()
        if dst_u8.numel() != nbytes:
            raise ValueError(
                f"H2D upload of {nbytes} bytes into a {dst_u8.numel()}-byte view"
            )
        self._wait_for_room(nbytes)
        with self._lock:
            begin = time.monotonic()
            stream = self._side_stream(dst_u8.device)
            with torch.cuda.stream(stream):
                dst_u8.copy_(src, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
            self._inflight.append((event, (src,), nbytes))
            self._unlanded_bytes += nbytes
            self.uploaded_bytes += nbytes
            phase_stats.add("h2d_dispatch", time.monotonic() - begin, nbytes)

    def copy_on_device(self, target: torch.Tensor, src: torch.Tensor) -> None:
        """``target.copy_(src)`` on the side stream, after the uploads into
        ``src``: the dtype-converting / strided finish of a restore."""
        with self._lock:
            stream = self._side_stream(target.device)
            with torch.cuda.stream(stream), torch.no_grad():
                target.copy_(src)
                event = torch.cuda.Event()
                event.record(stream)
            self._inflight.append((event, (src,), 0))

    def _land_oldest(self) -> bool:
        with self._lock:
            if not self._inflight:
                return False
            event, _keep, nbytes = self._inflight.popleft()
        begin = time.monotonic()
        event.synchronize()
        phase_stats.add("h2d_land", time.monotonic() - begin, nbytes)
        with self._lock:
            self._unlanded_bytes -= nbytes
        return True

    def _wait_for_room(self, nbytes: int) -> None:
        while True:
            with self._lock:
                if (
                    self._unlanded_bytes == 0
                    or self._unlanded_bytes + nbytes <= self._cap
                ):
                    return
            self._land_oldest()

    def drain(self) -> None:
        """Block until every enqueued copy has landed."""
        while self._land_oldest():
            pass


class ArrayAssembly:
    """Restore target of one logical tensor: the destination that one or
    more read pieces fill, finalized exactly once.

    Two destination kinds:

    - host: a CPU tensor or numpy array — the target itself when it can be
      loaded in place, else a fresh CPU tensor copied into the target (or
      returned) at finalize;
    - cuda: the CUDA target's own bytes when it is contiguous and of the
      entry's dtype and shape, else a device temporary that finalize copies
      into the target.  A fresh read onto a CUDA ``device`` allocates the
      target there.
    """

    def __init__(
        self,
        entry: TensorEntry,
        obj_out: Optional[Any],
        h2d_batch: Optional[H2DBatcher] = None,
        device: Optional[torch.device] = None,
    ) -> None:
        self.entry = entry
        self.fut: Future = Future()
        self._pending = 0
        self._h2d = h2d_batch
        target = obj_out
        fresh = target is None
        if fresh and device is not None and device.type != "cpu":
            target = torch.empty(
                entry.shape,
                dtype=serialization.host_dtype(entry.dtype),
                device=device,
            )
        elif isinstance(target, torch.Tensor) or (
            isinstance(target, np.ndarray) and str(target.dtype) != entry.dtype
        ):
            # A dtype torch lacks can only fill a target of its own dtype:
            # raises DtypeUnavailableError.
            serialization.string_to_torch_dtype(entry.dtype)
        self.target = target
        self.is_cuda = is_cuda_tensor(target)
        self._inplace = False
        if self.is_cuda:
            if h2d_batch is None:
                raise ValueError("restoring into a CUDA tensor needs an H2DBatcher")
            if self._same_layout(target):
                self.dev = target
            else:
                self.dev = torch.empty(
                    entry.shape,
                    dtype=serialization.host_dtype(entry.dtype),
                    device=target.device,
                )
            self.dev_u8 = serialization.tensor_u8(self.dev)
        else:
            self._inplace = ArrayIOPreparer.can_load_inplace(entry, target)
            if self._inplace:
                self.host = target
            else:
                self.host = torch.empty(
                    entry.shape, dtype=serialization.host_dtype(entry.dtype)
                )
            self.host_u8 = serialization.host_bytes(self.host)

    def _same_layout(self, t: torch.Tensor) -> bool:
        return (
            t.is_contiguous()
            and list(t.shape) == list(self.entry.shape)
            and t.dtype == serialization.host_dtype(self.entry.dtype)
        )

    def read_req(
        self,
        location: str,
        byte_range: Optional[List[int]],
        flat_offset: int,
        nbytes: int,
        checksum: Optional[str] = None,
        no_merge: bool = False,
        frame_entry: Optional[TensorEntry] = None,
    ) -> ReadReq:
        """The read request for bytes ``[flat_offset, flat_offset+nbytes)``
        of this tensor — the single policy point for the dense, tiled and
        chunked paths: pieces of 1 MiB and more read straight into their
        destination (the CPU target's memory, or a pinned buffer allocated
        at admission for a CUDA target); smaller ones merge.  A framed
        ``frame_entry`` reads its whole frame and decodes on consume."""
        framed = frame_entry is not None and compression.is_framed(frame_entry)
        consumer = ArrayBufferConsumer(
            assembly=self,
            flat_offset=flat_offset,
            nbytes=nbytes,
            checksum=checksum,
            location=location,
            frame_nbytes=frame_entry.compressed_nbytes if framed else None,
            framed=framed,
        )
        into = None
        into_factory = None
        if nbytes >= _INTO_PLACE_MIN_BYTES and not framed:
            if self.is_cuda:
                into_factory = consumer.alloc_pinned
            else:
                into = memoryview(self.host_u8)[flat_offset : flat_offset + nbytes]
                consumer.into = into
        return ReadReq(
            path=location,
            byte_range=byte_range,
            buffer_consumer=consumer,
            no_merge=no_merge,
            into=into,
            into_factory=into_factory,
        )

    def expect(self, n: int) -> None:
        self._pending = n
        if n == 0:
            self.finalize()

    def stage_piece(
        self,
        flat_offset: int,
        buf: BufferType,
        in_place: bool,
        pinned: Optional[torch.Tensor],
        framed: bool = False,
        nbytes: int = 0,
        location: str = "",
    ) -> Optional[torch.Tensor]:
        """Put one piece's bytes where they belong (executor-safe).  Host
        destinations get the bytes copied in (unless the read landed in
        place); CUDA destinations get back the pinned source to upload.  A
        frame is decoded straight into the destination: the host bytes, or
        a pinned buffer of the piece's size."""
        if framed:
            if self.is_cuda:
                src = pinned_empty(nbytes)
                if nbytes:
                    compression.decode(buf, nbytes, location, out=memoryview(src.numpy()))
                return src
            dst = self.host_u8[flat_offset : flat_offset + nbytes]
            compression.decode(buf, nbytes, location, out=memoryview(dst) if nbytes else None)
            return None
        view = np.frombuffer(memoryview(buf).cast("B"), dtype=np.uint8)
        if self.is_cuda:
            if in_place:
                return pinned
            src = pinned_empty(view.nbytes)
            src.numpy()[:] = view
            return src
        if not in_place:
            with phase_stats.timed("consume_copy", view.nbytes):
                self.host_u8[flat_offset : flat_offset + view.nbytes] = view
        return None

    def upload_piece(self, flat_offset: int, src: torch.Tensor) -> None:
        assert self._h2d is not None
        self._h2d.upload(src, self.dev_u8[flat_offset : flat_offset + src.numel()])

    def piece_done(self) -> None:
        self._pending -= 1
        if self._pending == 0:
            self.finalize()

    def finalize(self) -> None:
        target = self.target
        if self.is_cuda:
            if self.dev is target:
                self.fut.obj = target
            elif list(target.shape) == list(self.entry.shape):
                assert self._h2d is not None
                self._h2d.copy_on_device(target, self.dev)
                self.fut.obj = target
            else:
                self.fut.obj = self.dev  # shape changed: a fresh tensor
            return
        if self._inplace or target is None:
            self.fut.obj = self.host
            return
        if list(np.shape(target)) != list(self.entry.shape):
            self.fut.obj = self.host
            return
        if isinstance(target, torch.Tensor):
            with torch.no_grad():
                target.copy_(self.host)  # converts dtype like np.copyto
        else:
            np.copyto(target, self.host.numpy(), casting="unsafe")
        self.fut.obj = target


class ArrayBufferConsumer(BufferConsumer):
    # Leaf consumer (1 read : 1 payload): a read-fused digest of the
    # request's bytes is valid for this verify.
    accepts_hash64 = True

    def __init__(
        self,
        assembly: ArrayAssembly,
        flat_offset: int,
        nbytes: int,
        checksum: Optional[str] = None,
        location: str = "",
        frame_nbytes: Optional[int] = None,
        framed: bool = False,
    ) -> None:
        self._assembly = assembly
        self._flat_offset = flat_offset
        self._nbytes = nbytes
        self._checksum = checksum
        self._location = location
        self._frame_nbytes = frame_nbytes
        self.framed = framed
        # The read-into-place destination (CPU), or the pinned buffer
        # alloc_pinned handed the storage (CUDA).
        self.into: Optional[memoryview] = None
        self.pinned: Optional[torch.Tensor] = None
        self.precomputed_hash64: Optional[int] = None
        self.wants_read_hash = checksum is not None
        self.hash_algo = integrity.hash_algo_of(checksum)

    def alloc_pinned(self) -> memoryview:
        """The pinned host buffer this piece is read into (a CUDA target's
        ReadReq.into_factory, called when the scheduler admits the read)."""
        self.pinned = pinned_empty(self._nbytes)
        self.into = memoryview(self.pinned.numpy())
        return self.into

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        in_place = self.into is not None and buf is self.into

        def _stage() -> Optional[torch.Tensor]:
            integrity.verify(
                buf,
                self._checksum,
                self._location,
                precomputed=self.precomputed_hash64,
            )
            return self._assembly.stage_piece(
                self._flat_offset,
                buf,
                in_place,
                self.pinned,
                framed=self.framed,
                nbytes=self._nbytes,
                location=self._location,
            )

        if executor is not None and self._nbytes > _EXECUTOR_MIN_BYTES:
            src = await asyncio.get_running_loop().run_in_executor(executor, _stage)
        else:
            src = _stage()
        self.pinned = None
        self.into = None
        if src is not None:
            self._assembly.upload_piece(self._flat_offset, src)
        self._assembly.piece_done()

    def get_consuming_cost_bytes(self) -> int:
        if self.framed:
            # The read frame and the decoded payload coexist while decoding.
            return self._nbytes + (self._frame_nbytes or self._nbytes)
        return self._nbytes
