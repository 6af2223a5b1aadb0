"""Sharded (DTensor) write planning and overlap-region resharding reads.

Counterpart of ``torchsnapshot_tpu/io_preparers/sharded_array.py``.  Both
packages write one :class:`ShardedArrayEntry` per sharded tensor: the
concrete boxes (offsets, sizes, payload) and the logical layout (mesh
shape, axis names, partition spec).

Write: each rank plans writes for its box of the DTensor (one box per rank:
``DTensor.to_local()`` at the offsets torch's
``compute_local_shape_and_global_offset`` gives; empty boxes of uneven
sharding are skipped).  A box above the shard-size knob
(``TPUSNAP_MAX_SHARD_SIZE_BYTES``, 512 MiB) is subdivided along its largest
dim, and each piece goes through :class:`ArrayIOPreparer` as a view of the
local tensor, so staging holds one piece at a time.  Ranks that hold the
same box (the ``Replicate`` mesh dims of an HSDP layout) plan the same
``sharded/...`` piece paths, and the partitioner keeps one writer for each.

Read: the resharding engine.  For every target box the overlap with every
saved piece is pure index arithmetic (:func:`_overlap`), so a snapshot
restores into any world size and any placement.  Each overlapping saved
piece is read once and scattered into every target box it overlaps.
Targets, restored in place:

- a DTensor: its ``to_local()`` tensor.  On CUDA a piece that lands whole
  in one contiguous region of the local tensor is uploaded straight into
  it from the pinned read buffer; any other overlap uploads the piece into
  a device temporary and copies each overlap view on the device (one
  ``copy_`` per view, on the :class:`H2DBatcher`'s side stream).  On the
  CPU such a piece is read by storage straight into the local tensor's
  memory, others are copied from the read buffer.
- a plain tensor or numpy array of the entry's shape: assembled in place
  the same way;
- nothing (``read_object``): a fresh tensor on the requested device.

A compressed piece (compression.py) is always read whole, never as a
partial row span, and decoded before its scatter: on CUDA straight into
the pinned buffer it is uploaded from.

The JAX package instead assembles host buffers and builds new arrays with
``device_put`` and ``make_array_from_single_device_arrays``, since JAX
arrays are immutable.
"""

from __future__ import annotations

import asyncio
import warnings
from concurrent.futures import Executor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import compression, integrity, knobs, phase_stats, serialization, staging
from ..io_types import BufferConsumer, BufferType, Future, ReadReq, WriteReq
from ..compression import is_framed
from ..manifest import Shard, ShardedArrayEntry, TensorEntry
from ..serialization import Serializer
from .array import _EXECUTOR_MIN_BYTES, _INTO_PLACE_MIN_BYTES, ArrayIOPreparer, H2DBatcher

Box = Tuple[int, ...]
# (target box offsets, view into the saved piece, view into the target box)
Scatter = List[Tuple[Box, Tuple[slice, ...], Tuple[slice, ...]]]


def _subdivide(
    offsets: Sequence[int],
    sizes: Sequence[int],
    dtype_str: str,
    max_shard_sz_bytes: int,
) -> List[Tuple[List[int], List[int]]]:
    """Split one box into pieces <= max_shard_sz_bytes along its largest
    dim."""
    total = serialization.array_nbytes(list(sizes), dtype_str)
    if total <= max_shard_sz_bytes or not sizes:
        return [(list(offsets), list(sizes))]
    dim = int(np.argmax(sizes))
    if sizes[dim] <= 1:
        return [(list(offsets), list(sizes))]
    slice_bytes = total // sizes[dim]
    n_per_piece = max(1, max_shard_sz_bytes // max(slice_bytes, 1))
    pieces = []
    for start in range(0, sizes[dim], n_per_piece):
        n = min(n_per_piece, sizes[dim] - start)
        p_off = list(offsets)
        p_off[dim] += start
        p_sz = list(sizes)
        p_sz[dim] = n
        pieces.append((p_off, p_sz))
    return pieces


def _overlap(
    a_off: Sequence[int],
    a_sz: Sequence[int],
    b_off: Sequence[int],
    b_sz: Sequence[int],
) -> Optional[Tuple[List[int], List[int]]]:
    """Intersection box (offsets, sizes) of two boxes, or None."""
    starts, sizes = [], []
    for ao, asz, bo, bsz in zip(a_off, a_sz, b_off, b_sz):
        start = max(ao, bo)
        end = min(ao + asz, bo + bsz)
        if end <= start:
            return None
        starts.append(start)
        sizes.append(end - start)
    return starts, sizes


def _box_slices(
    box_off: Sequence[int], box_sz: Sequence[int], base_off: Sequence[int]
) -> Tuple[slice, ...]:
    return tuple(slice(o - b, o - b + s) for o, s, b in zip(box_off, box_sz, base_off))


def as_sharded_entry(entry: Any) -> ShardedArrayEntry:
    """A dense or chunked tensor entry seen as a sharded one (one shard, or
    one shard per chunk), so it restores into a sharded DTensor target
    through the overlap reads."""
    if isinstance(entry, ShardedArrayEntry):
        return entry
    if isinstance(entry, TensorEntry):
        shards = [Shard(offsets=[0] * len(entry.shape), sizes=list(entry.shape), tensor=entry)]
    else:  # ChunkedTensorEntry
        shards = list(entry.chunks)
    return ShardedArrayEntry(dtype=entry.dtype, shape=list(entry.shape), shards=shards)


class ShardedArrayIOPreparer:
    @staticmethod
    def storage_path_for_piece(storage_path: str, offsets: Sequence[int]) -> str:
        return f"{storage_path}.{'_'.join(str(x) for x in offsets)}"

    @classmethod
    def prepare_write(
        cls,
        storage_path: str,
        obj: Any,
        is_async_snapshot: bool = False,
    ) -> Tuple[ShardedArrayEntry, List[WriteReq]]:
        dtype_str = serialization.dtype_to_string(obj.dtype)
        max_shard_sz = knobs.get_max_shard_size_bytes()
        shards: List[Shard] = []
        write_reqs: List[WriteReq] = []
        for offsets, data in staging.local_shards(obj):
            sizes = list(data.shape)
            for p_off, p_sz in _subdivide(offsets, sizes, dtype_str, max_shard_sz):
                if list(p_off) == list(offsets) and p_sz == sizes:
                    piece = data
                else:
                    piece = data[_box_slices(p_off, p_sz, offsets)]
                location = cls.storage_path_for_piece(storage_path, p_off)
                tensor_entry, piece_reqs = ArrayIOPreparer.prepare_write(
                    storage_path=location,
                    obj=piece,
                    is_async_snapshot=is_async_snapshot,
                )
                shards.append(Shard(offsets=p_off, sizes=p_sz, tensor=tensor_entry))
                write_reqs += piece_reqs
        spec = staging.partition_spec_of(obj)
        mesh_shape, axis_names, partition_spec = spec if spec else (None, None, None)
        entry = ShardedArrayEntry(
            dtype=dtype_str,
            shape=list(obj.shape),
            shards=shards,
            mesh_shape=mesh_shape,
            axis_names=axis_names,
            partition_spec=partition_spec,
        )
        return entry, write_reqs

    @classmethod
    def prepare_read(
        cls,
        entry: ShardedArrayEntry,
        obj_out: Optional[Any] = None,
        h2d_batch: Optional[H2DBatcher] = None,
        device: Optional[torch.device] = None,
    ) -> Tuple[List[ReadReq], Future]:
        restore = _ShardedRestore(entry, obj_out, h2d_batch=h2d_batch, device=device)
        return cls._plan_reads(entry, restore)

    @staticmethod
    def _scatter_for(
        shard_offsets: Sequence[int], shard_sizes: Sequence[int], restore: "_ShardedRestore"
    ) -> Scatter:
        scatter: Scatter = []
        for t_off, t_sz in restore.targets():
            ov = _overlap(shard_offsets, shard_sizes, t_off, t_sz)
            if ov is None:
                continue
            ov_off, ov_sz = ov
            scatter.append(
                (
                    t_off,
                    _box_slices(ov_off, ov_sz, shard_offsets),  # view of the piece
                    _box_slices(ov_off, ov_sz, t_off),  # view of the target box
                )
            )
        return scatter

    @staticmethod
    def _partial_shard(shard: Shard, scatter: Scatter) -> Optional[Shard]:
        """The saved piece shrunk to the dim-0 row span its scatter
        intersects, when that saves at least the knob's floor of bytes: a
        rank restoring a slice of a piece then reads only those rows.  The
        sub-piece carries no checksum (the recorded digest covers bytes the
        read skips).  None when the whole piece is the right read: not a
        raw buffer, a frame, rows the plan (nearly) all needs, or a
        geometry that does not match its bytes."""
        tensor = shard.tensor
        if not knobs.partial_reads_enabled():
            return None
        if not shard.sizes or shard.sizes[0] <= 1:
            return None
        if tensor.serializer != Serializer.BUFFER_PROTOCOL.value or is_framed(tensor):
            return None
        if list(tensor.shape) != list(shard.sizes):
            return None
        r_lo = min(sv[0].start for _, sv, _ in scatter)
        r_hi = max(sv[0].stop for _, sv, _ in scatter)
        if r_lo <= 0 and r_hi >= shard.sizes[0]:
            return None
        try:
            nbytes = serialization.array_nbytes(list(shard.sizes), tensor.dtype)
        except ValueError:
            return None
        row_bytes = nbytes // shard.sizes[0]
        if row_bytes * shard.sizes[0] != nbytes:
            return None
        saved = (shard.sizes[0] - (r_hi - r_lo)) * row_bytes
        if saved < knobs.get_partial_read_min_saved_bytes():
            return None
        if tensor.byte_range is not None and (
            tensor.byte_range[1] - tensor.byte_range[0] != nbytes
        ):
            return None
        base = tensor.byte_range[0] if tensor.byte_range is not None else 0
        sub_sizes = [r_hi - r_lo] + list(shard.sizes[1:])
        sub_offsets = list(shard.offsets)
        sub_offsets[0] += r_lo
        sub_tensor = TensorEntry(
            location=tensor.location,
            serializer=tensor.serializer,
            dtype=tensor.dtype,
            shape=sub_sizes,
            replicated=tensor.replicated,
            byte_range=[base + r_lo * row_bytes, base + r_hi * row_bytes],
            checksum=None,
        )
        return Shard(offsets=sub_offsets, sizes=sub_sizes, tensor=sub_tensor)

    @classmethod
    def _plan_reads(
        cls, entry: ShardedArrayEntry, restore: "_ShardedRestore"
    ) -> Tuple[List[ReadReq], Future]:
        read_reqs: List[ReadReq] = []
        for shard in entry.shards:
            scatter = cls._scatter_for(shard.offsets, shard.sizes, restore)
            if not scatter:
                continue
            sub = cls._partial_shard(shard, scatter)
            if sub is not None:
                # Overlap views against the sub-piece, so source views index
                # the smaller buffer the read returns.
                shard = sub
                scatter = cls._scatter_for(shard.offsets, shard.sizes, restore)
            consumer = _ShardedArrayBufferConsumer(
                restore=restore,
                piece_entry=shard.tensor,
                piece_sizes=list(shard.sizes),
                scatter=scatter,
            )
            into, into_factory = restore.read_destination(consumer)
            read_reqs.append(
                ReadReq(
                    path=shard.tensor.location,
                    byte_range=shard.tensor.byte_range,
                    buffer_consumer=consumer,
                    into=into,
                    into_factory=into_factory,
                )
            )
        restore.expect(len(read_reqs))
        return read_reqs, restore.fut


class _ShardedRestore:
    """The target boxes of one sharded entry and their destination tensors;
    resolves the future once every piece has been scattered."""

    def __init__(
        self,
        entry: ShardedArrayEntry,
        obj_out: Optional[Any],
        h2d_batch: Optional[H2DBatcher] = None,
        device: Optional[torch.device] = None,
    ) -> None:
        self.entry = entry
        self.fut: Future = Future()
        self._pending = 0
        self._h2d = h2d_batch
        self.saved_dtype = serialization.host_dtype(entry.dtype)
        # target box offsets -> the tensor that box is restored into
        self._boxes: Dict[Box, torch.Tensor] = {}
        zero: Box = tuple([0] * len(entry.shape))
        self._result: Any = obj_out
        if staging.is_dtensor(obj_out):
            staging.check_placements(obj_out, "restore target")
            self._check_torch_dtype()
            if list(obj_out.shape) != list(entry.shape):
                raise ValueError(
                    f"DTensor target of shape {list(obj_out.shape)} cannot hold a "
                    f"saved tensor of shape {list(entry.shape)}"
                )
            for offsets, local in staging.local_shards(obj_out):
                self._boxes[tuple(offsets)] = local
        elif isinstance(obj_out, torch.Tensor) and list(obj_out.shape) == list(entry.shape):
            self._check_torch_dtype()
            self._boxes[zero] = obj_out
        elif (
            isinstance(obj_out, np.ndarray)
            and obj_out.flags.writeable
            and list(obj_out.shape) == list(entry.shape)
            and _torch_view(obj_out) is not None
        ):
            self._boxes[zero] = _torch_view(obj_out)
        else:
            fresh = torch.empty(
                entry.shape,
                dtype=self.saved_dtype,
                device=device if device is not None else "cpu",
            )
            self._boxes[zero] = fresh
            self._result = fresh
        if any(staging.is_cuda_tensor(t) for t in self._boxes.values()) and h2d_batch is None:
            raise ValueError("restoring into a CUDA tensor needs an H2DBatcher")

    def _check_torch_dtype(self) -> None:
        # A dtype torch lacks can only be read without a target: raises
        # DtypeUnavailableError.
        serialization.string_to_torch_dtype(self.entry.dtype)

    def targets(self) -> List[Tuple[Box, List[int]]]:
        return [(offsets, list(t.shape)) for offsets, t in self._boxes.items()]

    def box(self, offsets: Box) -> torch.Tensor:
        return self._boxes[offsets]

    def _whole_piece_region(self, consumer: "_ShardedArrayBufferConsumer") -> Optional[torch.Tensor]:
        """The target region a piece fills byte for byte, when it has one:
        one overlap, the whole piece, a contiguous region of the saved
        dtype.  Its bytes can be read (CPU) or uploaded (CUDA) in place."""
        scatter = consumer.scatter
        if len(scatter) != 1 or consumer.nbytes < _INTO_PLACE_MIN_BYTES or consumer.framed:
            return None
        t_off, src_view, dst_view = scatter[0]
        if any(s.start != 0 or s.stop != n for s, n in zip(src_view, consumer.piece_sizes)):
            return None
        dst = self.box(t_off)[dst_view]
        if dst.dtype != self.saved_dtype or not dst.is_contiguous():
            return None
        if dst.is_conj() or dst.is_neg():
            return None
        return dst

    def read_destination(self, consumer: "_ShardedArrayBufferConsumer"):
        """(into, into_factory) of a piece's read request: CPU regions it
        fills whole are read into in place; every CUDA-bound piece of 1 MiB
        or more is read into a pinned buffer allocated at admission."""
        if consumer.serializer != Serializer.BUFFER_PROTOCOL.value:
            return None, None
        region = self._whole_piece_region(consumer)
        cuda = any(staging.is_cuda_tensor(self.box(t_off)) for t_off, _, _ in consumer.scatter)
        if cuda:
            consumer.direct_region = region
            if consumer.nbytes >= _INTO_PLACE_MIN_BYTES and not consumer.framed:
                return None, consumer.alloc_pinned
            return None, None
        if region is not None:
            into = memoryview(serialization.host_bytes(region)).cast("B")
            consumer.into = into
            return into, None
        return None, None

    def upload(self, consumer: "_ShardedArrayBufferConsumer", pinned: torch.Tensor) -> None:
        """Move a piece's bytes from its pinned buffer into its CUDA target
        regions (loop thread)."""
        assert self._h2d is not None
        if consumer.direct_region is not None:
            self._h2d.upload(pinned, serialization.tensor_u8(consumer.direct_region))
            return
        device = next(
            self.box(t_off).device
            for t_off, _, _ in consumer.scatter
            if staging.is_cuda_tensor(self.box(t_off))
        )
        temp = torch.empty(consumer.piece_sizes, dtype=self.saved_dtype, device=device)
        self._h2d.upload(pinned, serialization.tensor_u8(temp))
        for t_off, src_view, dst_view in consumer.scatter:
            self._h2d.copy_on_device(self.box(t_off)[dst_view], temp[src_view])

    def expect(self, n: int) -> None:
        self._pending = n
        if n == 0:
            self.finalize()

    def piece_done(self) -> None:
        self._pending -= 1
        if self._pending == 0:
            self.finalize()

    def finalize(self) -> None:
        self.fut.obj = self._result


def _torch_view(arr: np.ndarray) -> Optional[torch.Tensor]:
    """A tensor sharing a numpy array's memory, or None for a dtype torch
    cannot view."""
    try:
        return torch.from_numpy(arr)
    except TypeError:
        return None


def _piece_tensor(buf: BufferType, dtype: torch.dtype, sizes: List[int]) -> torch.Tensor:
    """A read-only tensor view of a piece's bytes (never written)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # read-only buffer
        u8 = torch.frombuffer(memoryview(buf).cast("B"), dtype=torch.uint8)
    return u8.view(dtype).reshape(sizes)


class _ShardedArrayBufferConsumer(BufferConsumer):
    """Verifies one saved piece and scatters every overlap view into its
    target boxes."""

    # Leaf consumer (1 read : 1 piece payload): read-fused digests apply.
    accepts_hash64 = True

    def __init__(
        self,
        restore: _ShardedRestore,
        piece_entry: TensorEntry,
        piece_sizes: List[int],
        scatter: Scatter,
    ) -> None:
        self._restore = restore
        self._piece_entry = piece_entry
        self.piece_sizes = piece_sizes
        self.scatter = scatter
        self.serializer = piece_entry.serializer
        self.framed = is_framed(piece_entry)
        self.nbytes = serialization.array_nbytes(piece_sizes, piece_entry.dtype)
        self.into: Optional[memoryview] = None
        self.pinned: Optional[torch.Tensor] = None
        self.direct_region: Optional[torch.Tensor] = None
        self.precomputed_hash64: Optional[int] = None
        self.wants_read_hash = piece_entry.checksum is not None
        self.hash_algo = integrity.hash_algo_of(piece_entry.checksum)

    def alloc_pinned(self) -> memoryview:
        """The pinned host buffer this piece is read into (the read
        request's into_factory, called when the scheduler admits it)."""
        self.pinned = staging.pinned_empty(self.nbytes)
        self.into = memoryview(self.pinned.numpy())
        return self.into

    def _stage(self, buf: BufferType, in_place: bool) -> Optional[torch.Tensor]:
        """Verify, then put the bytes in their host targets; returns the
        pinned source to upload when the targets are on CUDA."""
        integrity.verify(
            buf,
            self._piece_entry.checksum,
            self._piece_entry.location,
            precomputed=self.precomputed_hash64,
        )
        if self.serializer != Serializer.BUFFER_PROTOCOL.value:
            raise ValueError(
                f"{self._piece_entry.location}: a sharded piece must be a raw "
                f"buffer, not {self.serializer!r}"
            )
        if self.nbytes == 0:
            return None
        restore = self._restore
        location = self._piece_entry.location
        if staging.is_cuda_tensor(restore.box(self.scatter[0][0])):
            if self.pinned is not None and in_place:
                return self.pinned
            src = staging.pinned_empty(self.nbytes)
            if self.framed:
                # The frame (verified above) decodes straight into the
                # pinned buffer the upload reads from.
                compression.decode(buf, self.nbytes, location, out=memoryview(src.numpy()))
            else:
                src.numpy()[:] = np.frombuffer(memoryview(buf).cast("B"), dtype=np.uint8)
            return src
        if in_place:
            return None  # storage read the bytes into the target
        if self.framed:
            buf = compression.decode(buf, self.nbytes, location)
        piece = _piece_tensor(buf, restore.saved_dtype, self.piece_sizes)
        with phase_stats.timed("scatter_copy", self.nbytes), torch.no_grad():
            for t_off, src_view, dst_view in self.scatter:
                restore.box(t_off)[dst_view].copy_(piece[src_view])
        return None

    async def consume_buffer(self, buf: BufferType, executor: Optional[Executor] = None) -> None:
        in_place = self.into is not None and buf is self.into
        if executor is not None and self.nbytes > _EXECUTOR_MIN_BYTES:
            src = await asyncio.get_running_loop().run_in_executor(executor, self._stage, buf, in_place)
        else:
            src = self._stage(buf, in_place)
        self.into = None
        self.pinned = None
        if src is not None:
            self._restore.upload(self, src)
        self._restore.piece_done()

    def get_consuming_cost_bytes(self) -> int:
        if self.framed:
            # The read frame and the decoded piece coexist while decoding.
            return self.nbytes + (self._piece_entry.compressed_nbytes or self.nbytes)
        return self.nbytes
