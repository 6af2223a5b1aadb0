"""Type-dispatched write/read planning + storage-path namespace.

Counterpart of ``torchsnapshot_tpu/io_preparer.py``, in its dispatch order.
On write:

1. python primitives → inlined :class:`PrimitiveEntry` (no storage I/O)
2. (sharded arrays: DTensor state belongs to a later slice and raises)
3. tensors and numpy arrays above the chunk knob (512 MB) →
   :class:`ChunkedArrayIOPreparer`
4. other tensors and numpy arrays of a registry dtype →
   :class:`ArrayIOPreparer` (a tensor of another dtype raises: torch cannot
   unpickle those)
5. everything else → pickle :class:`ObjectIOPreparer`

(The JAX package's typed PRNG-key branch has no torch counterpart.)
Rank-private payloads live under ``<rank>/``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from . import knobs, serialization, staging
from .io_preparers.array import ArrayIOPreparer, H2DBatcher
from .io_preparers.chunked_array import ChunkedArrayIOPreparer
from .io_preparers.object import ObjectIOPreparer
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


def get_storage_path(logical_path: str, rank: int) -> str:
    return f"{rank}/{logical_path}"


def prepare_write(
    obj: Any, logical_path: str, rank: int
) -> Tuple[Entry, List[WriteReq]]:
    if PrimitiveEntry.supports(obj) and not isinstance(obj, np.generic):
        return PrimitiveEntry.from_object(obj), []

    storage_path = get_storage_path(logical_path, rank)

    if staging.is_dtensor(obj):
        raise NotImplementedError(
            f"{logical_path}: sharded (DTensor) state is not supported by "
            "torchsnapshot_tpu_torch yet"
        )

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
            )
        return ArrayIOPreparer.prepare_write(storage_path=storage_path, obj=obj)

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
    if isinstance(entry, ShardedArrayEntry):
        raise NotImplementedError(
            "sharded array entries are not supported by "
            "torchsnapshot_tpu_torch yet; restore this snapshot with "
            "torchsnapshot_tpu"
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
