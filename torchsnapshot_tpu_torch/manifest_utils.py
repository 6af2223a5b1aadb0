"""Manifest entry predicates and replica-group math.

Counterpart of ``torchsnapshot_tpu/manifest_utils.py``.  An entry is
sharded iff it is a :class:`ShardedArrayEntry`; a DTensor whose placements
are all ``Replicate`` is written as a plain tensor entry with
``replicated=True`` by the dispatch layer (io_preparer.py).

Replica groups of partially replicated (HSDP-style) entries come from
``mesh_shape``/``axis_names``/``partition_spec``: mesh axes not named in
the partition spec are replication axes, and slicing the rank grid along
the sharded axes yields the rank sets that hold identical shards.  The
write-side partitioner dedups concretely by storage path, so this math is
advisory, not load-bearing, for correctness.
"""

from __future__ import annotations

import itertools
from typing import List, Set

import numpy as np

from .manifest import (
    DictEntry,
    Entry,
    ListEntry,
    NamedTupleEntry,
    OrderedDictEntry,
    ShardedArrayEntry,
    TupleEntry,
)


def is_container_entry(entry: Entry) -> bool:
    return isinstance(
        entry,
        (ListEntry, TupleEntry, NamedTupleEntry, DictEntry, OrderedDictEntry),
    )


def is_dict_entry(entry: Entry) -> bool:
    return isinstance(entry, (DictEntry, OrderedDictEntry))


def is_sharded_entry(entry: Entry) -> bool:
    return isinstance(entry, ShardedArrayEntry)


def is_fully_replicated_entry(entry: Entry) -> bool:
    if isinstance(entry, ShardedArrayEntry):
        return False
    return bool(getattr(entry, "replicated", False))


def is_partially_replicated_entry(entry: Entry) -> bool:
    """Sharded with at least one pure replication mesh axis (HSDP)."""
    if not isinstance(entry, ShardedArrayEntry):
        return False
    if entry.mesh_shape is None or entry.partition_spec is None:
        return False
    sharded_axes = _sharded_axes(entry.partition_spec)
    assert entry.axis_names is not None
    return 0 < len(sharded_axes) < len(entry.axis_names)


def _sharded_axes(partition_spec: List[List[str]]) -> Set[str]:
    """Mesh axis names that shard some dim of the array."""
    return {axis for dim in partition_spec for axis in (dim or [])}


def get_replicated_rank_sets(entry: ShardedArrayEntry, world_size: int) -> List[Set[int]]:
    """Rank sets that hold identical shards, from the logical sharding.

    Assumes the canonical process grid layout: processes laid out across the
    mesh in device order, ``world_size`` dividing the device count evenly.
    Returns [] when the sharding metadata is absent or inconsistent (callers
    must then fall back to concrete (offsets, sizes) dedup).
    """
    if (
        entry.mesh_shape is None
        or entry.axis_names is None
        or entry.partition_spec is None
    ):
        return []
    n_devices = int(np.prod(entry.mesh_shape))
    if world_size <= 0 or n_devices % world_size != 0:
        return []
    devices_per_rank = n_devices // world_size
    rank_grid = (
        np.arange(n_devices).reshape(entry.mesh_shape) // devices_per_rank
    )
    sharded_axes = _sharded_axes(entry.partition_spec)
    slices_per_dim = []
    for axis_name, size in zip(entry.axis_names, entry.mesh_shape):
        if axis_name in sharded_axes:
            slices_per_dim.append([slice(i, i + 1) for i in range(size)])
        else:
            slices_per_dim.append([slice(None)])
    return [
        set(int(r) for r in rank_grid[s].flatten())
        for s in itertools.product(*slices_per_dim)
    ]
