"""Write-load partitioning: dedup and balance shared payloads across ranks.

Counterpart of ``torchsnapshot_tpu/partitioner.py``, unchanged in
substance.  Ranks dedup **by storage path**; two classes of shared paths
exist:

- ``replicated/...``: fully replicated values (a DTensor with only
  ``Replicate`` placements, or a path matched by ``replicated=``); every
  rank plans an identical write;
- ``sharded/...`` pieces: a shard piece that several ranks hold (the
  ``Replicate`` mesh dims of an HSDP layout); its candidates are the ranks
  that planned it.

Rank 0 greedily assigns each shared path (largest first) to its least-loaded
candidate, seeding the loads with each rank's private (``<rank>/``) bytes;
the assignment is broadcast, and each rank keeps only its assigned write
requests and prunes its manifest entries to match (replicated entries
survive only on their writer; sharded entries keep only locally written
pieces; replicated chunked entries keep only assigned chunks).
:func:`consolidate_replicated_entries` then collects the writers'
replicated entries into rank 0's manifest, merging chunk lists.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from .io_types import WriteReq
from .manifest import (
    ChunkedTensorEntry,
    Entry,
    Manifest,
    ObjectEntry,
    ShardedArrayEntry,
    TensorEntry,
)
from .manifest_utils import is_fully_replicated_entry
from .pg_wrapper import PGWrapper

logger = logging.getLogger(__name__)


def _is_shared_path(path: str) -> bool:
    return path.startswith("replicated/") or path.startswith("sharded/")


def _payload_sizes(entries: Manifest) -> Dict[str, int]:
    """location → storage bytes, from manifest geometry (loads balance by
    storage size: staging cost is the wrong measure, 0 for zero-copy host
    buffers)."""
    from . import serialization

    sizes: Dict[str, int] = {}
    for entry in entries.values():
        if isinstance(entry, TensorEntry):
            sizes[entry.location] = serialization.array_nbytes(
                entry.shape, entry.dtype
            )
        elif isinstance(entry, (ShardedArrayEntry, ChunkedTensorEntry)):
            shards = (
                entry.shards
                if isinstance(entry, ShardedArrayEntry)
                else entry.chunks
            )
            for shard in shards:
                sizes[shard.tensor.location] = serialization.array_nbytes(
                    shard.tensor.shape, shard.tensor.dtype
                )
    return sizes


def partition_write_reqs(
    entries: Manifest, write_reqs: List[WriteReq], pg: PGWrapper
) -> Tuple[Manifest, List[WriteReq]]:
    """Returns (pruned entries, this rank's write reqs after dedup/balance)."""
    world_size = pg.get_world_size()
    if world_size == 1:
        return entries, write_reqs

    payload_sizes = _payload_sizes(entries)
    local_sizes: Dict[str, int] = {}
    private_bytes = 0
    for wr in write_reqs:
        cost = payload_sizes.get(
            wr.path, wr.buffer_stager.get_staging_cost_bytes()
        )
        if _is_shared_path(wr.path):
            local_sizes[wr.path] = cost
        else:
            private_bytes += cost

    # Rank 0 alone needs the per-rank loads: gather-to-root, not all-gather.
    gathered = pg.gather_object_root((local_sizes, private_bytes))

    assignment_list: List[Dict[str, int]] = [{}]
    if gathered is not None:
        loads = [g[1] for g in gathered]
        candidates: Dict[str, List[int]] = {}
        sizes: Dict[str, int] = {}
        for rank, (rank_sizes, _) in enumerate(gathered):
            for path, size in rank_sizes.items():
                candidates.setdefault(path, []).append(rank)
                sizes[path] = max(sizes.get(path, 0), size)
        assignment: Dict[str, int] = {}
        for path in sorted(sizes, key=lambda p: sizes[p], reverse=True):
            cand = candidates[path]
            chosen = min(cand, key=lambda r: loads[r])
            loads[chosen] += sizes[path]
            assignment[path] = chosen
        assignment_list[0] = assignment
    pg.broadcast_object_list(assignment_list, src=0)
    assignment = assignment_list[0]

    rank = pg.get_rank()

    def _mine(path: str) -> bool:
        return not _is_shared_path(path) or assignment.get(path) == rank

    kept_reqs = [wr for wr in write_reqs if _mine(wr.path)]

    pruned: Manifest = {}
    for logical_path, entry in entries.items():
        pruned_entry = _prune_entry(entry, _mine)
        if pruned_entry is not None:
            pruned[logical_path] = pruned_entry

    dropped = len(write_reqs) - len(kept_reqs)
    if dropped:
        logger.debug("[rank %d] partitioner dropped %d duplicate writes", rank, dropped)
    return pruned, kept_reqs


def _prune_entry(entry: Entry, mine) -> Optional[Entry]:
    """Drop (parts of) an entry whose payload this rank will not write.
    Container/primitive entries carry no payload and always survive."""
    if isinstance(entry, ShardedArrayEntry):
        shards = [s for s in entry.shards if mine(s.tensor.location)]
        if not shards and entry.shards:
            return None
        return ShardedArrayEntry(
            dtype=entry.dtype,
            shape=entry.shape,
            shards=shards,
            mesh_shape=entry.mesh_shape,
            axis_names=entry.axis_names,
            partition_spec=entry.partition_spec,
        )
    if isinstance(entry, ChunkedTensorEntry) and entry.replicated:
        chunks = [c for c in entry.chunks if mine(c.tensor.location)]
        if not chunks:
            return None
        return ChunkedTensorEntry(
            dtype=entry.dtype,
            shape=entry.shape,
            chunks=chunks,
            replicated=True,
        )
    if isinstance(entry, (TensorEntry, ObjectEntry)) and entry.replicated:
        if not mine(entry.location):
            return None
        return entry
    return entry


def consolidate_replicated_entries(
    rank_to_entries: List[Manifest],
) -> List[Manifest]:
    """Collect writer-rank replicated entries into rank 0's manifest, merging
    partitioned chunked entries.  Restore re-injects them for every rank
    (manifest_ops._manifest_for_existing_rank)."""
    chunked_groups: Dict[str, List[ChunkedTensorEntry]] = {}
    replicated: Dict[str, Entry] = {}
    out: List[Manifest] = []
    for entries in rank_to_entries:
        kept: Manifest = {}
        for logical_path, entry in entries.items():
            if not is_fully_replicated_entry(entry):
                kept[logical_path] = entry
                continue
            if isinstance(entry, ChunkedTensorEntry):
                chunked_groups.setdefault(logical_path, []).append(entry)
            elif logical_path not in replicated:
                replicated[logical_path] = entry
        out.append(kept)

    for logical_path, group in chunked_groups.items():
        merged_chunks = sorted(
            (chunk for e in group for chunk in e.chunks),
            key=lambda c: c.offsets,
        )
        replicated[logical_path] = ChunkedTensorEntry(
            dtype=group[0].dtype,
            shape=group[0].shape,
            chunks=merged_chunks,
            replicated=True,
        )

    if out:
        out[0].update(replicated)
    return out
