"""Request batching: coalesce small writes into slab files, merge ranged reads.

Counterpart of ``torchsnapshot_tpu/batcher.py``, with the slab layout
unchanged: batchable small writes pack into ``batched/<digest>`` slab files
up to the slab threshold (128 MB knob), and their manifest entries are
rewritten in place to (slab location, byte_range).  Only buffer-protocol
tensor stagers are batchable: their byte size is known from dtype×shape
before staging, so slab offsets are assigned up front.  A slab stages all
its members concurrently (their D2H copies overlap) and hands storage a
:class:`ScatterBuffer` of the member views — no pack memcpy on storage that
writes scatter-gather.

Read side: byte-ranged reads of one file merge into one spanning read
fanned out to sub-consumers, within a bounded gap.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
from collections import defaultdict
from concurrent.futures import Executor
from typing import Dict, List, Optional, Tuple

from . import chunker, knobs, serialization
from .compression import is_framed
from .io_preparers.array import ArrayBufferStager
from .io_types import (
    BufferConsumer,
    BufferStager,
    BufferType,
    ReadReq,
    ScatterBuffer,
    WriteReq,
)
from .manifest import (
    ChunkedTensorEntry,
    Manifest,
    ShardedArrayEntry,
    TensorEntry,
)
from .serialization import Serializer
from .telemetry import trace as ttrace

logger = logging.getLogger(__name__)


def _index_tensor_entries(entries: Manifest) -> Dict[str, TensorEntry]:
    """location → TensorEntry for every array payload, including those nested
    in sharded/chunked entries (needed to rewrite locations in place)."""
    index: Dict[str, TensorEntry] = {}
    for entry in entries.values():
        if isinstance(entry, TensorEntry):
            index[entry.location] = entry
        elif isinstance(entry, (ShardedArrayEntry, ChunkedTensorEntry)):
            shards = entry.shards if isinstance(entry, ShardedArrayEntry) else entry.chunks
            for shard in shards:
                index[shard.tensor.location] = shard.tensor
    return index


def is_batchable(write_req: WriteReq, entry_index: Dict[str, TensorEntry]) -> bool:
    stager = write_req.buffer_stager
    if not isinstance(stager, ArrayBufferStager):
        return False
    entry = entry_index.get(write_req.path)
    if entry is None or entry.serializer != Serializer.BUFFER_PROTOCOL.value:
        return False
    # A framed payload's stored size is known only once staged, and slab
    # offsets are assigned now: it is never batched.  The compression size
    # floor keeps the small payloads slabs exist for raw and batchable.
    return not is_framed(entry)


def batch_write_requests(
    entries: Manifest,
    write_reqs: List[WriteReq],
    scatter_ok: bool = False,
) -> Tuple[Manifest, List[WriteReq]]:
    """``scatter_ok``: the destination storage writes ScatterBuffer parts
    without joining (fs native data plane) — slabs then cost no side
    allocation.  Backends that join at write time (memory) keep the slab
    total in the staging cost so the memory budget stays honest."""
    with ttrace.span("batch_write_plan", n_reqs=len(write_reqs)):
        return _batch_write_requests_impl(entries, write_reqs, scatter_ok)


def _batch_write_requests_impl(
    entries: Manifest,
    write_reqs: List[WriteReq],
    scatter_ok: bool,
) -> Tuple[Manifest, List[WriteReq]]:
    entry_index = _index_tensor_entries(entries)
    slab_threshold = knobs.get_slab_size_threshold_bytes()

    batchable: List[Tuple[WriteReq, TensorEntry, int]] = []
    passthrough: List[WriteReq] = []
    for wr in write_reqs:
        if is_batchable(wr, entry_index):
            entry = entry_index[wr.path]
            nbytes = serialization.array_nbytes(entry.shape, entry.dtype)
            if nbytes < slab_threshold:
                batchable.append((wr, entry, nbytes))
                continue
        passthrough.append(wr)

    if len(batchable) < 2:
        return entries, write_reqs

    out_reqs = passthrough

    def _emit(slab: List[Tuple[WriteReq, TensorEntry, int]]) -> None:
        if len(slab) == 1:
            out_reqs.append(slab[0][0])
            return
        # Deterministic location (digest of the member paths): two
        # snapshots of the same app state produce identically-named
        # slabs, so incremental saves can dedup an unchanged slab by
        # path+checksum — a uuid name would defeat dedup for every
        # payload under the slab threshold.  Member sets are disjoint
        # within one snapshot, so names cannot collide.
        member_key = "|".join(wr.path for wr, _, _ in slab).encode()
        location = f"batched/{hashlib.sha1(member_key).hexdigest()[:24]}"
        offset = 0
        members: List[Tuple[BufferStager, int, int]] = []
        for wr, entry, nbytes in slab:
            entry.location = location
            entry.byte_range = [offset, offset + nbytes]
            members.append((wr.buffer_stager, offset, nbytes))
            offset += nbytes
        out_reqs.append(
            WriteReq(
                path=location,
                buffer_stager=BatchedBufferStager(
                    members=members, total=offset, scatter_ok=scatter_ok
                ),
            )
        )

    # Structural slab edges (plan-order packing); with content-defined
    # chunking on, the CAS writer cuts the physical chunk edges inside each
    # slab at write time (chunker.py).
    for group, _ in chunker.plan_slabs(
        batchable, [nbytes for _, _, nbytes in batchable], slab_threshold
    ):
        _emit(group)
    logger.debug(
        "Batcher: %d small writes coalesced into %d slabs (%d passthrough)",
        len(batchable),
        len(out_reqs) - len(passthrough),
        len(passthrough),
    )
    return entries, out_reqs


class BatchedBufferStager(BufferStager):
    """Stages all slab members concurrently (their D2H DMAs overlap) and
    hands storage a :class:`ScatterBuffer` of the member views in offset
    order — no pack memcpy; backends without scatter-gather join lazily.
    """

    def __init__(
        self,
        members: List[Tuple[BufferStager, int, int]],
        total: int,
        scatter_ok: bool = False,
    ) -> None:
        self._members = members
        self._total = total
        self._scatter_ok = scatter_ok
        # Member digest sinks, aligned with the ScatterBuffer parts (member
        # order IS parts order): the scheduler resolves them at write time,
        # fused into ONE native write+hash call for the whole slab on the
        # scatter path.  None when members resolved during staging (the
        # join path) or recording is off.
        self.hash_sinks: Optional[list] = None

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        async def _stage_one(stager: BufferStager, nbytes: int) -> memoryview:
            buf = await stager.stage_buffer(executor)
            view = memoryview(buf).cast("B")
            if view.nbytes != nbytes:
                raise RuntimeError(
                    f"Batched member staged {view.nbytes} bytes, expected {nbytes}"
                )
            return view

        views = await asyncio.gather(
            *(_stage_one(s, n) for s, _, n in self._members)
        )
        member_sinks = [
            getattr(s, "hash_sinks", None) for s, _, _ in self._members
        ]
        scatter = ScatterBuffer(views)
        if self._scatter_ok:
            if all(sinks and len(sinks) == 1 for sinks in member_sinks):
                # One sink per member, parts-aligned: the whole slab's
                # digests come back from the fused write.
                self.hash_sinks = [sinks[0] for sinks in member_sinks]
            else:
                # Checksum recording off (no member deferred) — or an
                # unexpected mix; resolve whatever exists now.
                await self._resolve_member_sinks(member_sinks, views, executor)
            return scatter
        # Join path (backend can't scatter, so it can't fuse either):
        # resolve member digests from the views before the pack memcpy.
        await self._resolve_member_sinks(member_sinks, views, executor)
        # The destination would join() scatter parts at write time; do it
        # HERE, during staging, where the slab-sized allocation is covered
        # by the declared staging cost (parts + total) and the scheduler
        # re-credits the parts once staging returns.  Joining at write time
        # instead would allocate io-concurrency x slab bytes outside any
        # budget window.  The memcpy runs on the executor: a 128 MB inline
        # copy would stall the event loop driving every other transfer.
        if executor is not None:
            return await asyncio.get_running_loop().run_in_executor(
                executor, scatter.join
            )
        return scatter.join()

    @staticmethod
    async def _resolve_member_sinks(member_sinks, views, executor) -> None:
        from . import integrity

        async def _one(sinks, view) -> None:
            digest = await integrity.compute_on(view, executor)
            for sink in sinks:
                sink(digest)

        # Concurrent, like the member staging itself: the hashers release
        # the GIL, so an 8-member slab hashes across the executor instead
        # of one member at a time.
        await asyncio.gather(
            *(
                _one(sinks, view)
                for sinks, view in zip(member_sinks, views)
                if sinks
            )
        )

    def get_staging_cost_bytes(self) -> int:
        cost = sum(s.get_staging_cost_bytes() for s, _, _ in self._members)
        if not self._scatter_ok:
            # Parts and the joined slab coexist during the staging-time pack.
            cost += self._total
        return cost


def batch_read_requests(read_reqs: List[ReadReq]) -> List[ReadReq]:
    """Merge ranged reads per file into spanning reads — but only within a
    bounded gap.

    The reference merges every ranged read on a path unconditionally and
    flags the resulting read-amplification itself (reference
    batcher.py:441-445 TODO: two entries at opposite ends of a 128 MB slab
    become one whole-slab read).  Here reads are sorted by offset and merged
    greedily only while the hole between a request and the group's end stays
    under the ``max_read_merge_gap_bytes`` knob (8 MB default) — sparse
    elastic restores read roughly the bytes they need.

    Tiled reads (``no_merge``) pass through untouched: they were split
    precisely to bound buffering, and they all target one location.
    """
    max_gap = knobs.get_max_read_merge_gap_bytes()
    by_path: Dict[str, List[ReadReq]] = defaultdict(list)
    passthrough: List[ReadReq] = []
    for rr in read_reqs:
        if (
            rr.byte_range is not None
            and not rr.no_merge
            and rr.into is None
            and rr.into_factory is None
        ):
            by_path[rr.path].append(rr)
        else:
            passthrough.append(rr)

    out = passthrough

    def _flush_group(path: str, group: List[ReadReq]) -> None:
        if len(group) == 1:
            out.append(group[0])
            return
        start = group[0].byte_range[0]
        end = max(r.byte_range[1] for r in group)
        members = [
            (r.byte_range[0] - start, r.byte_range[1] - start, r.buffer_consumer)
            for r in group
        ]
        out.append(
            ReadReq(
                path=path,
                byte_range=[start, end],
                buffer_consumer=BatchedBufferConsumer(
                    members=members, total=end - start
                ),
            )
        )

    for path, reqs in by_path.items():
        reqs.sort(key=lambda r: r.byte_range[0])
        group: List[ReadReq] = []
        group_end = 0
        for rr in reqs:
            if group and rr.byte_range[0] - group_end > max_gap:
                _flush_group(path, group)
                group = []
            group.append(rr)
            group_end = max(group_end, rr.byte_range[1])
        if group:
            _flush_group(path, group)
    return out


class BatchedBufferConsumer(BufferConsumer):
    def __init__(
        self, members: List[Tuple[int, int, BufferConsumer]], total: int
    ) -> None:
        self._members = members
        self._total = total

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        view = memoryview(buf)
        await asyncio.gather(
            *(
                consumer.consume_buffer(view[start:end], executor)
                for start, end, consumer in self._members
            )
        )

    def get_consuming_cost_bytes(self) -> int:
        return self._total + sum(c.get_consuming_cost_bytes() for _, _, c in self._members)
