"""Manifest transforms: per-rank views, shard merging, elastic reconciliation.

Counterpart of ``torchsnapshot_tpu/manifest_ops.py``, unchanged in
substance.  The global manifest keys are ``"<rank>/<logical_path>"``;
these transforms make elastic restore work:

- :func:`get_manifest_for_rank` splits the global manifest into this rank's
  view, injects rank 0's fully replicated entries, and merges
  ShardedArray shards across all ranks so every rank can read any shard
  (the precondition of resharding).  Ranks beyond the saved world size get
  only container and replicated entries.
- :func:`handle_sharded_array_elasticity` reconciles which sharded entries
  a rank loads against its state dict's requests.

Shard merging dedups by (offsets, sizes): with path-dedup partitioning a
replicated shard is written once, but an unpartitioned save may leave
identical shard records on several ranks, and one survives.
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import Dict, List, Tuple

from .manifest import Entry, Manifest, ShardedArrayEntry, SnapshotMetadata
from .manifest_utils import (
    is_container_entry,
    is_dict_entry,
    is_fully_replicated_entry,
)


def get_manifest_for_rank(
    metadata: SnapshotMetadata, rank: int
) -> Tuple[Manifest, Dict[str, Entry]]:
    rank_to_manifest = _get_rank_to_manifest(metadata)
    merged_entries = _get_merged_sharded_entries(rank_to_manifest)
    if rank < metadata.world_size:
        local = _manifest_for_existing_rank(rank_to_manifest, merged_entries, rank)
    else:
        local = _manifest_for_new_rank(rank_to_manifest)
    return local, merged_entries


def _get_rank_to_manifest(metadata: SnapshotMetadata) -> List[Dict[str, Entry]]:
    """Per-rank views of the global manifest.

    Only container entries are copied: they are the only objects the restore
    path mutates (elasticity appends/removes container keys), and a blanket
    deepcopy of multi-MB manifests costs ~0.25 s per stateful at 8B-param
    scale.  Leaf entries are shared read-only with ``metadata.manifest``.
    """
    rank_to_manifest: List[Dict[str, Entry]] = [
        {} for _ in range(metadata.world_size)
    ]
    for path, entry in metadata.manifest.items():
        rank_str, _, logical_path = path.partition("/")
        if is_container_entry(entry):
            entry = copy.deepcopy(entry)
        rank_to_manifest[int(rank_str)][logical_path] = entry
    return rank_to_manifest


def _get_merged_sharded_entries(
    rank_to_manifest: List[Dict[str, Entry]],
) -> Dict[str, Entry]:
    groups: Dict[str, List[ShardedArrayEntry]] = defaultdict(list)
    for manifest in rank_to_manifest:
        for logical_path, entry in manifest.items():
            if isinstance(entry, ShardedArrayEntry):
                groups[logical_path].append(entry)

    merged: Dict[str, Entry] = {}
    for logical_path, group in groups.items():
        seen = set()
        shards = []
        for entry in group:
            for shard in entry.shards:
                key = (tuple(shard.offsets), tuple(shard.sizes))
                if key in seen:
                    continue
                seen.add(key)
                shards.append(shard)
        shards.sort(key=lambda s: s.offsets)
        first = group[0]
        merged[logical_path] = ShardedArrayEntry(
            dtype=first.dtype,
            shape=first.shape,
            shards=shards,
            mesh_shape=first.mesh_shape,
            axis_names=first.axis_names,
            partition_spec=first.partition_spec,
        )
    return merged


def _manifest_for_existing_rank(
    rank_to_manifest: List[Dict[str, Entry]],
    merged_entries: Dict[str, Entry],
    rank: int,
) -> Manifest:
    local = dict(rank_to_manifest[rank])
    # Fully-replicated entries were consolidated into rank 0's manifest at
    # save time; re-inject them.
    for logical_path, entry in rank_to_manifest[0].items():
        if is_fully_replicated_entry(entry):
            local[logical_path] = entry
    for logical_path, entry in local.items():
        if isinstance(entry, ShardedArrayEntry):
            local[logical_path] = merged_entries[logical_path]
    return local


def _manifest_for_new_rank(rank_to_manifest: List[Dict[str, Entry]]) -> Manifest:
    local = dict(rank_to_manifest[0])
    for logical_path in list(local.keys()):
        entry = local[logical_path]
        if is_container_entry(entry) or is_fully_replicated_entry(entry):
            continue
        _remove_entry(local, logical_path)
    return local


def handle_sharded_array_elasticity(
    manifest: Manifest,
    merged_entries: Dict[str, Entry],
    tensor_requests: List[str],
) -> None:
    """Add requested-but-absent sharded entries; drop unrequested ones."""
    requests = [tr for tr in tensor_requests if tr in merged_entries]

    for logical_path in requests:
        if logical_path not in manifest:
            manifest[logical_path] = merged_entries[logical_path]
            parent_path, _, key = logical_path.rpartition("/")
            parent = manifest.get(parent_path)
            if parent is not None and is_dict_entry(parent) and key not in parent.keys:
                parent.keys.append(key)

    for logical_path in list(manifest.keys()):
        if (
            isinstance(manifest[logical_path], ShardedArrayEntry)
            and logical_path not in requests
        ):
            del manifest[logical_path]


def _remove_entry(manifest: Manifest, logical_path: str) -> None:
    """Remove an entry and unlink it from its parent container's key list."""
    if logical_path not in manifest:
        return
    del manifest[logical_path]
    parent_path, _, key = logical_path.rpartition("/")
    if not parent_path or parent_path not in manifest:
        return
    parent = manifest[parent_path]
    if is_dict_entry(parent):
        if key in parent.keys:
            parent.keys.remove(key)
        elif key.isdigit() and int(key) in parent.keys:
            parent.keys.remove(int(key))
