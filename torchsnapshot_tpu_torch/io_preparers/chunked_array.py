"""Chunked writes/reads for tensors larger than the chunk budget.

Counterpart of ``torchsnapshot_tpu/io_preparers/chunked_array.py``:
tensors above 512 MB (``TPUSNAP_MAX_CHUNK_SIZE_BYTES``) split along dim 0
into chunk views, each written by the array preparer to
``<path>_<offsets>``.  Chunking caps the staging buffer (the memory-budget
admission unit: one pinned chunk, not the whole tensor) and the file size.
A dim-0 slice of a contiguous tensor is itself contiguous, so each chunk's
D2H copy is one ``view(torch.uint8)`` of it.

Restore reads every chunk into its byte range of the one target
(:class:`ArrayAssembly`): in place for CPU targets, through a pinned buffer
and an H2D copy per chunk for CUDA targets.  A compressed chunk is read
whole and decoded into that byte range (or its pinned buffer).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .. import serialization
from ..io_types import Future, ReadReq, WriteReq
from ..manifest import Chunk, ChunkedTensorEntry, Shard, TensorEntry
from ..serialization import Serializer
from .array import ArrayAssembly, ArrayIOPreparer, H2DBatcher


class ChunkedArrayIOPreparer:
    @staticmethod
    def chunk_instructions(
        shape: List[int], dtype_str: str, chunk_size_bytes: int
    ) -> List[Chunk]:
        """Split along dim 0 into pieces of at most ``chunk_size_bytes``.
        0-d tensors and an unsplittable dim 0 produce a single chunk."""
        total = serialization.array_nbytes(shape, dtype_str)
        if not shape or shape[0] <= 1 or total <= chunk_size_bytes:
            return [Chunk(offsets=[0] * len(shape), sizes=list(shape), dtype=dtype_str)]
        row_bytes = total // shape[0]
        rows_per_chunk = max(1, chunk_size_bytes // max(row_bytes, 1))
        chunks: List[Chunk] = []
        for start in range(0, shape[0], rows_per_chunk):
            rows = min(rows_per_chunk, shape[0] - start)
            chunks.append(
                Chunk(
                    offsets=[start] + [0] * (len(shape) - 1),
                    sizes=[rows] + list(shape[1:]),
                    dtype=dtype_str,
                )
            )
        return chunks

    @classmethod
    def prepare_write(
        cls,
        storage_path: str,
        obj: Any,
        chunking_instruction: List[Chunk],
        is_async_snapshot: bool = False,
    ) -> Tuple[ChunkedTensorEntry, List[WriteReq]]:
        write_reqs: List[WriteReq] = []
        chunks: List[Shard] = []
        for chunk in chunking_instruction:
            suffix = "_".join(str(x) for x in chunk.offsets)
            view = (
                obj[chunk.offsets[0] : chunk.offsets[0] + chunk.sizes[0]]
                if chunk.offsets
                else obj
            )
            chunk_entry, chunk_write_reqs = ArrayIOPreparer.prepare_write(
                storage_path=f"{storage_path}_{suffix}",
                obj=view,
                is_async_snapshot=is_async_snapshot,
            )
            chunks.append(
                Shard(offsets=chunk.offsets, sizes=chunk.sizes, tensor=chunk_entry)
            )
            write_reqs += chunk_write_reqs
        return (
            ChunkedTensorEntry(
                dtype=chunks[0].tensor.dtype,
                shape=list(np.shape(obj)) if not isinstance(obj, torch.Tensor)
                else list(obj.shape),
                chunks=chunks,
                replicated=False,
            ),
            write_reqs,
        )

    @classmethod
    def prepare_read(
        cls,
        entry: ChunkedTensorEntry,
        obj_out: Optional[Any] = None,
        h2d_batch: Optional[H2DBatcher] = None,
        device: Optional[torch.device] = None,
    ) -> Tuple[List[ReadReq], Future]:
        """Every chunk reads into its byte range of one assembly, finalized
        once."""
        pseudo_entry = TensorEntry(
            location="<chunked>",
            serializer=Serializer.BUFFER_PROTOCOL.value,
            dtype=entry.dtype,
            shape=entry.shape,
            replicated=entry.replicated,
        )
        assembly = ArrayAssembly(
            entry=pseudo_entry, obj_out=obj_out, h2d_batch=h2d_batch, device=device
        )
        itemsize = serialization.per_element_nbytes(entry.dtype)
        row_elems = int(np.prod(entry.shape[1:])) if len(entry.shape) > 1 else 1
        read_reqs: List[ReadReq] = []
        for chunk in entry.chunks:
            if any(off != 0 for off in chunk.offsets[1:]):
                raise ValueError(
                    "ChunkedTensorEntry with non-dim-0 chunking is not supported"
                )
            flat_offset = chunk.offsets[0] * row_elems * itemsize if chunk.offsets else 0
            tensor_entry = chunk.tensor
            read_reqs.append(
                assembly.read_req(
                    tensor_entry.location,
                    tensor_entry.byte_range,
                    flat_offset=flat_offset,
                    nbytes=serialization.array_nbytes(chunk.sizes, entry.dtype),
                    checksum=tensor_entry.checksum,
                    frame_entry=tensor_entry,
                )
            )
        assembly.expect(len(read_reqs))
        return read_reqs, assembly.fut
