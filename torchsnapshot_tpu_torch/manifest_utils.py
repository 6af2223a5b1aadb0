"""Manifest entry predicates (counterpart of
``torchsnapshot_tpu/manifest_utils.py``; its sharded-entry predicates and
replica-group math arrive with the distributed slice)."""

from __future__ import annotations

from .manifest import (
    DictEntry,
    Entry,
    ListEntry,
    NamedTupleEntry,
    OrderedDictEntry,
    TupleEntry,
)


def is_container_entry(entry: Entry) -> bool:
    return isinstance(
        entry,
        (ListEntry, TupleEntry, NamedTupleEntry, DictEntry, OrderedDictEntry),
    )
