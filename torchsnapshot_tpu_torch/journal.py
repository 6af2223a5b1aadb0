"""Delta-journal checkpointing: append-only segments and replayed recovery.

Counterpart of ``torchsnapshot_tpu/journal.py``, with the same layout and
metadata, so a chain may mix segments of both packages and either
package's manager replays it.  Each manager save appends a small
**journal segment** and a compactor periodically folds the accumulated
deltas into a fresh full step.

Layout (all under the ``SnapshotManager`` root, siblings of ``step_N``)::

    <root>/
      cas/<algo>/...                 # chunks, shared with full steps
      step_B/.snapshot_metadata      # base: a FULL manifest (chunk refs)
      seg_N/.snapshot_metadata       # delta segment for training step N
      seg_N/telemetry/...            # per-op sidecars, as for steps

A segment is a normal content-addressed take whose manifest is filtered at
commit time to the entries whose serialized form changed since the prior
merged view (:func:`compute_delta`), plus a ``journal`` block recording
the replay chain::

    {"base_step": B, "prior_segments": [..], "deleted": [..],
     "entries_total": M, "entries_delta": D, "delta_bytes": n}

- **Append ∝ change.**  Payload bytes go through the chunk store, so an
  unchanged payload writes nothing, and the manifest holds only the
  changed entries.
- **The commit contract of steps.**  A segment commits with the durable
  marker; a torn segment is an orphan for ``gc``.  Compaction writes the
  folded step's marker durably before it deletes any segment, so a crash
  in between leaves base and segments intact.
- **Replayed recovery.**  ``restore_latest`` and ``restore_at`` resolve a
  segment by replaying base + chain (:func:`merged_metadata`); a broken
  chain piece raises :class:`JournalReplayError`, and ``restore_latest``
  falls back to the next-newest point.

Segments declare manifest version 0.5.0, and ``Snapshot.restore`` refuses
one outside the replay path (a delta alone is partial state).
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, List, Optional, Set, Tuple

from .io_types import ReadIO, StoragePlugin
from .manifest import (
    JOURNAL_MANIFEST_VERSION,
    Entry,
    SnapshotMetadata,
    _entry_from_dict,
    _entry_to_dict,
    iter_payload_entries,
    manifest_version_for,
)

logger = logging.getLogger(__name__)

SEG_RE = re.compile(r"^seg_(\d+)$")
SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"


class JournalReplayError(RuntimeError):
    """A segment's replay chain cannot be resolved (a missing or corrupt
    base or prior segment): the restore point is unusable."""


def segment_dirname(step: int) -> str:
    return f"seg_{step}"


def segment_path(root: str, step: int) -> str:
    return f"{root}/seg_{step}"


# ----------------------------------------------------------------- discovery


def _segments(storage: StoragePlugin, committed: bool) -> List[int]:
    try:
        names = storage.sync_list_dir("")
    except (NotImplementedError, FileNotFoundError):
        return []
    out = []
    for name in names:
        m = SEG_RE.match(name)
        if m and storage.sync_exists(f"{name}/{SNAPSHOT_METADATA_FNAME}") == committed:
            out.append(int(m.group(1)))
    return sorted(out)


def committed_segments(storage: StoragePlugin) -> List[int]:
    """Committed segments under a root, ascending: the durable metadata
    marker exists, the commit signal of steps too."""
    return _segments(storage, committed=True)


def orphan_segments(storage: StoragePlugin) -> List[int]:
    """Segment directories without a marker: a crashed segment take's
    debris, or an async segment save still in flight.  Ascending."""
    return _segments(storage, committed=False)


def _read_metadata(storage: StoragePlugin, path: str) -> SnapshotMetadata:
    read_io = ReadIO(path=path)
    storage.sync_read(read_io)
    return SnapshotMetadata.from_json(bytes(read_io.buf).decode("utf-8"))


def read_segment_metadata(storage: StoragePlugin, step: int) -> SnapshotMetadata:
    return _read_metadata(storage, f"{segment_dirname(step)}/{SNAPSHOT_METADATA_FNAME}")


# --------------------------------------------------------------- delta math


def entry_logical_bytes(entry: Entry) -> int:
    """Logical payload bytes of one leaf entry: the stored frame size when
    compressed, dtype×shape otherwise; objects count 0 (the manifest does
    not record their size)."""
    from . import serialization

    compressed = getattr(entry, "compressed_nbytes", None)
    if compressed:
        return int(compressed)
    dtype = getattr(entry, "dtype", None)
    shape = getattr(entry, "shape", None)
    if dtype is None or shape is None:
        return 0
    try:
        return serialization.array_nbytes(shape, dtype)
    except ValueError:
        return 0


def manifest_logical_bytes(manifest: Dict[str, Entry]) -> int:
    """Logical bytes of a manifest, each distinct stored piece once."""
    seen = set()
    total = 0
    for _, entry in iter_payload_entries(manifest):
        byte_range = getattr(entry, "byte_range", None)
        key = (entry.location, tuple(byte_range) if byte_range else None)
        if key in seen:
            continue
        seen.add(key)
        total += entry_logical_bytes(entry)
    return total


def view_of(manifest: Dict[str, Entry]) -> Dict[str, dict]:
    """The comparison form of a manifest: path → canonical entry dict.
    Content-addressed locations make it an exact change detector: the same
    bytes give the same ``cas://`` reference and an identical dict."""
    return {path: _entry_to_dict(entry) for path, entry in manifest.items()}


def manifest_of(view: Dict[str, dict]) -> Dict[str, Entry]:
    return {path: _entry_from_dict(d) for path, d in view.items()}


def compute_delta(
    metadata: SnapshotMetadata,
    prior_view: Dict[str, dict],
    base_step: int,
    prior_segments: List[int],
) -> SnapshotMetadata:
    """Filter a full gathered manifest to the journal delta against the
    prior merged view, with the replay-chain ``journal`` block.  Pure
    computation (rank 0, commit time): no storage read, so the transform
    cannot fail transiently."""
    delta: Dict[str, Entry] = {}
    for path, entry in metadata.manifest.items():
        if prior_view.get(path) != _entry_to_dict(entry):
            delta[path] = entry
    deleted = sorted(set(prior_view) - set(metadata.manifest))
    return SnapshotMetadata(
        version=JOURNAL_MANIFEST_VERSION,
        world_size=metadata.world_size,
        manifest=delta,
        journal={
            "base_step": base_step,
            "prior_segments": list(prior_segments),
            "deleted": deleted,
            "entries_total": len(metadata.manifest),
            "entries_delta": len(delta),
            "delta_bytes": manifest_logical_bytes(delta),
        },
    )


def sidecar_summary(journal_info: Dict[str, Any]) -> Dict[str, Any]:
    """The compact per-step record of a segment in telemetry sidecars and
    ``journal.commit`` events (the ``deleted`` list as a count)."""
    return {
        "base_step": journal_info.get("base_step"),
        "segments_since_base": len(journal_info.get("prior_segments", [])) + 1,
        "entries_total": journal_info.get("entries_total"),
        "entries_delta": journal_info.get("entries_delta"),
        "delta_bytes": journal_info.get("delta_bytes"),
        "deleted": len(journal_info.get("deleted", [])),
    }


# ------------------------------------------------------------------- replay


def _apply_segment(view: Dict[str, Any], seg_md: SnapshotMetadata) -> None:
    for path in seg_md.journal.get("deleted", []):
        view.pop(path, None)
    view.update(seg_md.manifest)


def merged_metadata(storage: StoragePlugin, step: int) -> Tuple[SnapshotMetadata, Dict[str, Any]]:
    """Replay a segment's chain into a self-contained ``SnapshotMetadata``
    (``journal=None``, restorable through the normal path) and the
    segment's own journal block.  Later deltas overlay earlier ones, so
    every entry resolves to its newest segment.

    Raises :class:`JournalReplayError` naming the first unusable piece."""
    try:
        seg_md = read_segment_metadata(storage, step)
    except Exception as e:
        raise JournalReplayError(f"seg_{step}: metadata unreadable ({e})") from e
    info = seg_md.journal
    if info is None:
        # A full manifest committed at a segment path is self-contained.
        return seg_md, {}
    base_step = info["base_step"]
    try:
        base_md = _read_metadata(storage, f"step_{base_step}/{SNAPSHOT_METADATA_FNAME}")
    except Exception as e:
        raise JournalReplayError(f"seg_{step}: base step_{base_step} unreadable ({e})") from e
    if base_md.journal is not None:
        raise JournalReplayError(f"seg_{step}: base step_{base_step} is itself a delta segment")
    view: Dict[str, Entry] = dict(base_md.manifest)
    for prior in info.get("prior_segments", []):
        try:
            prior_md = read_segment_metadata(storage, prior)
        except Exception as e:
            raise JournalReplayError(f"seg_{step}: chain segment seg_{prior} unreadable ({e})") from e
        if prior_md.journal is None:
            raise JournalReplayError(f"seg_{step}: chain segment seg_{prior} is not a delta")
        _apply_segment(view, prior_md)
    _apply_segment(view, seg_md)
    return (
        SnapshotMetadata(version=manifest_version_for(view), world_size=seg_md.world_size, manifest=view),
        info,
    )


def referenced_chunk_relpaths_of_segment(storage: StoragePlugin, step: int) -> Set[str]:
    """Chunk paths one committed segment's delta manifest references: the
    compactor's reclamation candidates."""
    from . import cas

    return cas.referenced_chunk_relpaths(read_segment_metadata(storage, step).manifest)


# -------------------------------------------------------------- journal state


class JournalState:
    """Rank 0's journal bookkeeping: the base step, the committed segments
    since it, the merged view (comparison form) and the summed delta bytes
    of the byte compaction trigger.  Kept across saves so a delta needs no
    storage read; rebuilt from storage after a restart (:func:`load_state`)."""

    def __init__(
        self,
        base_step: Optional[int],
        segments: List[int],
        view: Dict[str, dict],
        world_size: int,
        delta_bytes: int = 0,
    ) -> None:
        self.base_step = base_step
        self.segments = segments
        self.view = view
        self.world_size = world_size
        self.delta_bytes = delta_bytes


def load_state(storage: StoragePlugin, committed_steps: List[int]) -> JournalState:
    """:class:`JournalState` from storage: the newest committed full step
    is the base, and the committed segments newer than it are the live
    chain (older ones are compaction leftovers for gc).  A root with no
    committed full step gives ``base_step=None``: the next save writes a
    base."""
    base = committed_steps[-1] if committed_steps else None
    if base is None:
        return JournalState(None, [], {}, 1)
    base_md = _read_metadata(storage, f"step_{base}/{SNAPSHOT_METADATA_FNAME}")
    if base_md.journal is not None:
        raise JournalReplayError(f"step_{base} unexpectedly carries journal metadata")
    view = view_of(base_md.manifest)
    segments: List[int] = []
    delta_bytes = 0
    world_size = base_md.world_size
    for seg in committed_segments(storage):
        if seg <= base:
            continue  # subsumed by a newer full step (a crashed compaction)
        seg_md = read_segment_metadata(storage, seg)
        if seg_md.journal is None:
            continue
        for path in seg_md.journal.get("deleted", []):
            view.pop(path, None)
        view.update(view_of(seg_md.manifest))
        segments.append(seg)
        delta_bytes += int(seg_md.journal.get("delta_bytes", 0))
        world_size = seg_md.world_size
    return JournalState(base, segments, view, world_size, delta_bytes)
