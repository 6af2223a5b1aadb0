"""Incremental snapshots: unchanged payloads are linked, not rewritten.

Counterpart of ``torchsnapshot_tpu/incremental.py``.
``Snapshot.take(..., incremental_from=base)`` wraps the take's storage:
every payload's staged bytes are hashed and, when the digest equals the
base snapshot's entry at the same relative path, the base's object is
duplicated into the new snapshot without moving its bytes through this
host: a hard link on fs, a server-side copy on S3 (CopyObject, or
UploadPartCopy over 5 GiB) and on GCS (``rewriteTo``), same bucket only.  Every snapshot stays
self-contained, so removing the base is safe.  Slabs dedup whole: their
locations are deterministic (a digest of the member paths, batcher.py),
and a slab matches when every member's digest equals the base's at the
same byte range.  A mismatch, a missing
base file or a backend that cannot link falls back to a normal write.

The base may have been written by either package.  With ``TPUSNAP_CAS``
on, the CAS digest index already dedups against every committed step
(the base included) by content, so this wrapper steps aside.  A base on
another backend scheme or, on an object store, in another bucket is
ignored with a warning.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Dict, Optional

from .io_types import ReadIO, ScatterBuffer, StoragePlugin, WriteIO, contiguous
from .manifest import SnapshotMetadata, iter_payload_entries

logger = logging.getLogger(__name__)


def checksums_by_location(metadata: SnapshotMetadata) -> Dict[str, object]:
    """location → expected digest: a checksum string for a whole-file
    payload, or ``{(start, end): checksum}`` for a slab's members."""
    out: Dict[str, object] = {}
    for _, entry in iter_payload_entries(metadata.manifest):
        if entry.checksum is None:
            continue
        byte_range = getattr(entry, "byte_range", None)
        if byte_range is None:
            out[entry.location] = entry.checksum
            continue
        ranges = out.setdefault(entry.location, {})
        if isinstance(ranges, dict):
            ranges[tuple(byte_range)] = entry.checksum
    return out


def _slab_matches(buf: Any, expected: Dict[tuple, str]) -> bool:
    """Whether a staged slab equals the base's member by member: the base's
    ranges tile the incoming bytes and every member digest matches."""
    from . import integrity

    ranges = sorted(expected.items())
    offset = 0
    if isinstance(buf, ScatterBuffer):
        if len(buf.parts) != len(ranges):
            return False
        for ((start, end), checksum), part in zip(ranges, buf.parts):
            if start != offset or end - start != part.nbytes:
                return False
            if integrity.digest_as(part, checksum) != checksum:
                return False
            offset = end
        return True
    view = memoryview(buf).cast("B")
    for (start, end), checksum in ranges:
        if start != offset or end > view.nbytes:
            return False
        if integrity.digest_as(view[start:end], checksum) != checksum:
            return False
        offset = end
    return offset == view.nbytes


class IncrementalStoragePlugin(StoragePlugin):
    """Links unchanged payloads from a base snapshot instead of writing."""

    def __init__(self, inner: StoragePlugin, base_root: str, base_checksums: Dict[str, object]) -> None:
        self._inner = inner
        self._base_root = base_root
        self._base_checksums = base_checksums
        self.links = 0
        # Slabs stay scatter-gather where the inner plugin writes them so;
        # digests come from the scheduler's pre-write hash (a linked
        # payload writes nothing to fuse a hash with).
        self.supports_scatter = getattr(inner, "supports_scatter", False)

    def _get_executor(self):
        getter = getattr(self._inner, "_get_executor", None)
        return getter() if getter is not None else None

    async def write(self, write_io: WriteIO) -> None:
        expected = self._base_checksums.get(write_io.path)
        if expected is not None:

            def _matches() -> bool:
                from . import integrity

                if isinstance(expected, dict):
                    return _slab_matches(write_io.buf, expected)
                return integrity.digest_as(contiguous(write_io.buf), expected) == expected

            unchanged = await asyncio.get_running_loop().run_in_executor(
                self._get_executor(), _matches
            )
            if unchanged:
                try:
                    copied = await self._inner.copy_from_sibling(self._base_root, write_io.path)
                except Exception as e:  # noqa: BLE001 — the payload is written instead
                    logger.debug("Incremental copy of %s failed (%s); writing normally", write_io.path, e)
                    copied = False
                if copied:
                    self.links += 1
                    return
        await self._inner.write(write_io)

    async def read(self, read_io: ReadIO) -> None:
        await self._inner.read(read_io)

    async def exists(self, path: str) -> bool:
        return await self._inner.exists(path)

    async def list_dir(self, path: str):
        return await self._inner.list_dir(path)

    async def delete(self, path: str) -> None:
        await self._inner.delete(path)

    async def delete_dir(self, path: str) -> None:
        await self._inner.delete_dir(path)

    async def close(self) -> None:
        if self.links:
            logger.info(
                "Incremental snapshot: %d payloads deduplicated (hard link / server-side copy)", self.links
            )
        await self._inner.close()


def linked_payloads(storage: Optional[StoragePlugin]) -> Optional[int]:
    """Payloads the take's incremental wrapper linked or copied server-side,
    or None when its storage stack has none."""
    for _ in range(8):
        if storage is None:
            return None
        if isinstance(storage, IncrementalStoragePlugin):
            return storage.links
        storage = getattr(storage, "_inner", None)
    return None


def maybe_wrap_incremental(
    storage: StoragePlugin, base_path: Optional[str], target_path: Optional[str] = None
) -> StoragePlugin:
    """Wrap ``storage`` for incremental writes when the base is a committed
    snapshot on the same backend; otherwise return ``storage``."""
    if base_path is None:
        return storage
    from . import cas
    from .storage_plugin import parse_url

    if cas.find_writer(storage) is not None:
        logger.info(
            "incremental_from=%s delegated to the CAS digest index (TPUSNAP_CAS "
            "is on and dedups against every committed step)",
            base_path,
        )
        return storage
    base_scheme, base_root = parse_url(base_path)
    if target_path is not None and base_scheme != parse_url(target_path)[0]:
        logger.warning(
            "incremental_from ignored: base scheme %s != target scheme %s",
            base_scheme,
            parse_url(target_path)[0],
        )
        return storage
    if target_path is not None and base_scheme in ("s3", "gcs"):
        # Object-store copies are same-bucket only: catch a mismatch once
        # here instead of hashing every payload and refusing every copy.
        base_bucket = base_root.partition("/")[0]
        target_bucket = parse_url(target_path)[1].partition("/")[0]
        if base_bucket != target_bucket:
            logger.warning(
                "incremental_from ignored: base bucket %s != target bucket %s "
                "(server-side copy is same-bucket only)",
                base_bucket,
                target_bucket,
            )
            return storage
    from .snapshot import Snapshot

    try:
        base_metadata = Snapshot(base_path).metadata
    except Exception as e:  # noqa: BLE001 — the take proceeds without dedup
        logger.warning("incremental_from ignored: base metadata unreadable (%s)", e)
        return storage
    if cas.manifest_uses_cas(base_metadata.manifest):
        logger.warning(
            "incremental_from ignored: base %s is a CAS snapshot; enable "
            "TPUSNAP_CAS=1 so the take dedups through the chunk store",
            base_path,
        )
        return storage
    base_checksums = checksums_by_location(base_metadata)
    if not base_checksums:
        return storage
    return IncrementalStoragePlugin(inner=storage, base_root=base_root, base_checksums=base_checksums)
