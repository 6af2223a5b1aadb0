"""Type-dispatched write/read planning + storage-path namespace.

Counterpart of ``torchsnapshot_tpu/io_preparer.py``, in its dispatch order.
On write:

1. python primitives → inlined :class:`PrimitiveEntry` (no storage I/O)
2. DTensors with a ``Shard`` placement → :class:`ShardedArrayIOPreparer`
   (``Partial`` and ``_StridedShard`` placements raise a ``TypeError``); a
   DTensor whose placements are all ``Replicate`` is its local tensor,
   marked replicated by the caller
3. tensors and numpy arrays above the chunk knob (512 MB) →
   :class:`ChunkedArrayIOPreparer`
4. other tensors and numpy arrays of a registry dtype →
   :class:`ArrayIOPreparer` (a tensor of another dtype raises: torch cannot
   unpickle those)
5. everything else → pickle :class:`ObjectIOPreparer`

(The JAX package's typed PRNG-key branch has no torch counterpart.)
Storage paths: ``sharded/`` for sharded entries (pieces shared across
ranks), ``replicated/`` for replicated values (one writer, chosen by the
partitioner), ``<rank>/`` for rank-private payloads.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from . import knobs, serialization, staging
from .io_preparers.array import ArrayIOPreparer, H2DBatcher
from .io_preparers.chunked_array import ChunkedArrayIOPreparer
from .io_preparers.object import ObjectIOPreparer
from .io_preparers.sharded_array import ShardedArrayIOPreparer, as_sharded_entry
from .io_types import Future, ReadReq, WriteReq
from .manifest import (
    ChunkedTensorEntry,
    Entry,
    ObjectEntry,
    PrimitiveEntry,
    ShardedArrayEntry,
    TensorEntry,
)
from .serialization import Serializer


def get_storage_path(obj: Any, logical_path: str, rank: int, replicated: bool) -> str:
    if staging.is_sharded(obj):
        return f"sharded/{logical_path}"
    if replicated:
        return f"replicated/{logical_path}"
    return f"{rank}/{logical_path}"


def prepare_write(
    obj: Any,
    logical_path: str,
    rank: int,
    replicated: bool = False,
    is_async_snapshot: bool = False,
) -> Tuple[Entry, List[WriteReq]]:
    """``replicated``: every rank holds the same value, and one of them
    writes it (partitioner.py).  ``is_async_snapshot``: an async take that
    stages on the host — CPU tensors and numpy arrays are copied at
    staging, since the caller may mutate them once ``async_take``
    returns."""
    if PrimitiveEntry.supports(obj) and not isinstance(obj, np.generic):
        return PrimitiveEntry.from_object(obj, replicated=replicated), []

    if staging.is_dtensor(obj):
        staging.check_placements(obj, logical_path)
        if staging.is_sharded(obj):
            return ShardedArrayIOPreparer.prepare_write(
                storage_path=get_storage_path(obj, logical_path, rank, replicated),
                obj=obj,
                is_async_snapshot=is_async_snapshot,
            )
        obj = obj.to_local()  # every rank holds the whole tensor

    storage_path = get_storage_path(obj, logical_path, rank, replicated)
    entry, write_reqs = _prepare_write_local(obj, logical_path, storage_path, is_async_snapshot)
    entry.replicated = replicated  # type: ignore[attr-defined]
    return entry, write_reqs


def _prepare_write_local(
    obj: Any, logical_path: str, storage_path: str, is_async_snapshot: bool
) -> Tuple[Entry, List[WriteReq]]:
    if isinstance(obj, torch.Tensor) and not serialization.is_supported_dtype(obj.dtype):
        # torch cannot unpickle tensors of these dtypes, so no pickle
        # fallback: refuse at plan time.
        raise TypeError(
            f"{logical_path}: tensor dtype {obj.dtype} is outside the snapshot "
            "dtype registry"
        )
    if staging.is_array_like(obj) and serialization.is_supported_dtype(obj.dtype):
        dtype_str = serialization.dtype_to_string(obj.dtype)
        shape = list(np.shape(obj)) if not isinstance(obj, torch.Tensor) else list(obj.shape)
        chunk_size = knobs.get_max_chunk_size_bytes()
        if serialization.array_nbytes(shape, dtype_str) > chunk_size:
            instruction = ChunkedArrayIOPreparer.chunk_instructions(
                shape=shape, dtype_str=dtype_str, chunk_size_bytes=chunk_size
            )
            return ChunkedArrayIOPreparer.prepare_write(
                storage_path=storage_path,
                obj=obj,
                chunking_instruction=instruction,
                is_async_snapshot=is_async_snapshot,
            )
        return ArrayIOPreparer.prepare_write(
            storage_path=storage_path, obj=obj, is_async_snapshot=is_async_snapshot
        )

    return ObjectIOPreparer.prepare_write(storage_path=storage_path, obj=obj)


def prepare_read(
    entry: Entry,
    obj_out: Optional[Any] = None,
    buffer_size_limit_bytes: Optional[int] = None,
    h2d_batch: Optional[H2DBatcher] = None,
    device: Optional[torch.device] = None,
) -> Tuple[List[ReadReq], Future]:
    """Read dispatch by entry type.  ``h2d_batch`` carries CUDA uploads (the
    caller drains it after the read pipeline); ``device`` places tensors
    that have no target (CPU when None)."""
    if isinstance(entry, PrimitiveEntry):
        return [], Future(obj=entry.get_value())
    if staging.is_dtensor(obj_out) and (
        isinstance(entry, (ShardedArrayEntry, ChunkedTensorEntry))
        or (isinstance(entry, TensorEntry) and entry.serializer != Serializer.PICKLE.value)
    ):
        # A DTensor restores in place into its local tensor, whatever the
        # saved layout: a dense or chunked entry is a sharded one of one
        # shard or one shard per chunk.
        return ShardedArrayIOPreparer.prepare_read(
            as_sharded_entry(entry), obj_out, h2d_batch=h2d_batch, device=device
        )
    if isinstance(entry, ShardedArrayEntry):
        return ShardedArrayIOPreparer.prepare_read(
            entry, obj_out, h2d_batch=h2d_batch, device=device
        )
    if isinstance(entry, ChunkedTensorEntry):
        return ChunkedArrayIOPreparer.prepare_read(
            entry, obj_out, h2d_batch=h2d_batch, device=device
        )
    if isinstance(entry, TensorEntry):
        if entry.serializer == Serializer.PICKLE.value:
            return ObjectIOPreparer.prepare_read(entry)
        return ArrayIOPreparer.prepare_read(
            entry,
            obj_out,
            buffer_size_limit_bytes,
            h2d_batch=h2d_batch,
            device=device,
        )
    if isinstance(entry, ObjectEntry):
        return ObjectIOPreparer.prepare_read(entry)
    raise TypeError(f"Cannot prepare read for entry type: {type(entry)}")
