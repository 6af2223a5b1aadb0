"""Pickle fallback for arbitrary objects (counterpart of
``torchsnapshot_tpu/io_preparers/object.py``).  Kept off the hot path by
the dispatch order in io_preparer.py.

A ``jax_prng_key`` object from a torchsnapshot_tpu snapshot comes back as
its envelope dict (implementation name and raw key data): this package
holds no JAX key type to rebuild.
"""

from __future__ import annotations

import sys
import time
from concurrent.futures import Executor
from typing import Any, List, Optional, Tuple

from .. import integrity, phase_stats, serialization
from ..io_types import BufferConsumer, BufferStager, BufferType, Future, ReadReq, WriteReq
from ..manifest import ObjectEntry, TensorEntry


class ObjectIOPreparer:
    @classmethod
    def prepare_write(
        cls, storage_path: str, obj: Any
    ) -> Tuple[ObjectEntry, List[WriteReq]]:
        entry = ObjectEntry(
            location=storage_path,
            serializer="pickle",
            obj_type=type(obj).__name__,
            replicated=False,
        )
        return entry, [
            WriteReq(
                path=storage_path,
                buffer_stager=ObjectBufferStager(obj=obj, entry=entry),
            )
        ]

    @classmethod
    def prepare_read(cls, entry: Any) -> Tuple[List[ReadReq], Future]:
        """Read one pickled payload: an ObjectEntry, or a TensorEntry whose
        serializer is ``pickle`` (torchsnapshot_tpu's fallback for arrays of
        dtypes outside the registry).  The value is returned, not restored
        in place: arbitrary objects have no in-place contract."""
        fut: Future = Future()
        byte_range = entry.byte_range if isinstance(entry, TensorEntry) else None
        return (
            [
                ReadReq(
                    path=entry.location,
                    byte_range=byte_range,
                    buffer_consumer=ObjectBufferConsumer(fut=fut, entry=entry),
                )
            ],
            fut,
        )


class ObjectBufferStager(BufferStager):
    def __init__(self, obj: Any, entry: ObjectEntry) -> None:
        self._obj = obj
        self._entry = entry
        # Deferred digest (see ArrayBufferStager).
        self.hash_sinks: Optional[list] = None

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        begin = time.monotonic()
        data = serialization.pickle_save_as_bytes(self._obj)
        phase_stats.add("serialize", time.monotonic() - begin, len(data))
        if integrity.save_checksums_enabled():
            entry = self._entry

            def _set(digest_str) -> None:
                entry.checksum = digest_str

            self.hash_sinks = [_set]
        return data

    def get_staging_cost_bytes(self) -> int:
        # sys.getsizeof is knowingly inaccurate; pickling to measure would
        # defeat the lazy staging.
        return max(sys.getsizeof(self._obj), 4096)


class ObjectBufferConsumer(BufferConsumer):
    # Leaf consumer (1 read : 1 payload): read-fused digests apply.
    accepts_hash64 = True

    def __init__(self, fut: Future, entry: Any) -> None:
        self._fut = fut
        self._entry = entry
        self.precomputed_hash64: Optional[int] = None
        self.wants_read_hash = entry.checksum is not None
        self.hash_algo = integrity.hash_algo_of(entry.checksum)

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        integrity.verify(
            buf,
            self._entry.checksum,
            self._entry.location,
            precomputed=self.precomputed_hash64,
        )
        self._fut.obj = serialization.pickle_load_from_bytes(bytes(buf))

    def get_consuming_cost_bytes(self) -> int:
        return 4096
