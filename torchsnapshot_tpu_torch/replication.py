"""Cross-backend snapshot replication (counterpart of
``torchsnapshot_tpu/replication.py``).

``copy_snapshot`` replicates a COMMITTED snapshot between any two storage
backends (fs, ``s3://``, ``gs://``, ``memory://``, in any direction) with the
commit contract of ``Snapshot.take``: every payload lands first and the
``.snapshot_metadata`` marker is written last, so an interrupted copy never
leaves a destination that opens as a snapshot.

Same-backend copies go server-side through ``copy_from_sibling`` (fs hard
links, S3 CopyObject / UploadPartCopy, GCS rewrite); everything else streams
through this host with bounded concurrency and a bound on buffered bytes,
largest payloads first.  A content-addressed step or a journal segment is
copied chunk by chunk through the two roots (``_copy_cas_snapshot``).
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor, wait
from typing import Dict

from . import cas, integrity
from .integrity import ChecksumError
from .io_types import ReadIO, WriteIO
from .journal import read_metadata
from .manifest import (
    ChunkedTensorEntry,
    ObjectEntry,
    ShardedArrayEntry,
    TensorEntry,
    iter_payload_entries,
)
from .serialization import array_nbytes
from .snapshot import SNAPSHOT_METADATA_FNAME, Snapshot
from .storage_plugin import parse_url, url_to_storage_plugin
from .utils.loops import run_coro

logger = logging.getLogger(__name__)

_DEFAULT_IO_CONCURRENCY = 4
_DEFAULT_MAX_IN_FLIGHT_BYTES = 2 << 30


class _CopyCancelled(RuntimeError):
    pass


class _ByteBudget:
    """Caps the bytes that streaming copies buffer at once (largest-first
    ordering would otherwise hold the N biggest payloads in host RAM).  A
    payload bigger than the whole limit is admitted alone.  ``cancel``
    wakes waiters once a sibling copy has failed."""

    def __init__(self, limit: int) -> None:
        self._limit = max(1, limit)
        self._used = 0
        self._cv = threading.Condition()

    def acquire(self, nbytes: int, cancel: threading.Event) -> None:
        nbytes = min(nbytes, self._limit)
        with self._cv:
            while self._used + nbytes > self._limit:
                if cancel.is_set():
                    raise _CopyCancelled("copy aborted by sibling failure")
                self._cv.wait(timeout=0.2)
            self._used += nbytes

    def release(self, nbytes: int) -> None:
        nbytes = min(nbytes, self._limit)
        with self._cv:
            self._used -= nbytes
            self._cv.notify_all()


def _payload_sizes(metadata) -> Dict[str, int]:
    """location → best-known size.  Slab members record byte ranges (the
    largest end wins); standalone tensor payloads record none, so their size
    is dtype × shape.  Objects stay 0: the manifest does not record their
    size, and they are the small tail by construction."""
    sizes: Dict[str, int] = {}

    def _add(entry) -> None:
        byte_range = getattr(entry, "byte_range", None)
        if byte_range:
            size = byte_range[1]
        else:
            try:
                size = array_nbytes(entry.shape, entry.dtype)
            except Exception:
                size = 0
        sizes[entry.location] = max(sizes.get(entry.location, 0), size)

    for entry in metadata.manifest.values():
        if isinstance(entry, TensorEntry):
            _add(entry)
        elif isinstance(entry, ObjectEntry):
            sizes.setdefault(entry.location, 0)
        elif isinstance(entry, ShardedArrayEntry):
            for shard in entry.shards:
                _add(shard.tensor)
        elif isinstance(entry, ChunkedTensorEntry):
            for chunk in entry.chunks:
                _add(chunk.tensor)
    return sizes


def _run_pool(fn, items, describe, io_concurrency: int, src_path: str, dst_path: str) -> None:
    """``fn(item)`` for every item on a pool; the first real failure cancels
    the rest (queued and budget-parked workers alike) and raises, naming
    ``describe(item)``."""
    cancel = threading.Event()
    with ThreadPoolExecutor(max_workers=max(1, io_concurrency), thread_name_prefix="snap_copy") as pool:
        futures = {pool.submit(fn, item, cancel): item for item in items}
        done, not_done = wait(futures, return_when=FIRST_EXCEPTION)
        failed = next(
            (f for f in done if f.exception() is not None and not isinstance(f.exception(), _CopyCancelled)),
            None,
        )
        if failed is not None:
            cancel.set()
            for fut in not_done:
                fut.cancel()
            wait(not_done)
            raise RuntimeError(
                f"copying {describe(futures[failed])} from {src_path} to {dst_path} failed"
            ) from failed.exception()


def _server_side_copy(dst, src_root: str, path: str) -> bool:
    """``dst.copy_from_sibling``: True when the bytes were duplicated without
    passing through this host; False (or a failure) means stream instead."""
    try:
        return bool(run_coro(lambda: dst.copy_from_sibling(src_root, path)))
    except Exception as e:  # noqa: BLE001 — the stream is the fallback
        logger.debug("server-side copy failed for %s (%s); streaming", path, e)
        return False


def copy_snapshot(
    src_path: str,
    dst_path: str,
    *,
    overwrite: bool = False,
    io_concurrency: int = _DEFAULT_IO_CONCURRENCY,
    max_in_flight_bytes: int = _DEFAULT_MAX_IN_FLIGHT_BYTES,
    verify: bool = False,
    force_stream: bool = False,
) -> Snapshot:
    """Replicate the committed snapshot at ``src_path`` to ``dst_path`` and
    return the destination ``Snapshot``.

    ``overwrite=True`` un-commits an existing destination snapshot (its
    marker goes first) and copies again; stale payload files stay,
    unreferenced and harmless.  ``verify=True`` audits every checksummed
    payload on the destination BEFORE the marker is written and raises
    ``ChecksumError`` on any damage; it refuses when checksums are off or
    the source recorded no digests.  Streaming copies buffer at most
    ``max_in_flight_bytes`` of payloads at once.

    fs→fs copies are hard links: ``verify=True`` then proves the shared
    inodes intact, not that an independent replica exists.
    ``force_stream=True`` routes every payload through this host instead."""
    if verify and not integrity.checksums_enabled():
        # A no-op audit must not pass for a clean one.  (The port always has
        # its native hash: a missing library raises where it is first used.)
        raise RuntimeError("cannot verify copy: checksums disabled (TPUSNAP_CHECKSUM=0) or no hash backend available")
    src = url_to_storage_plugin(src_path)
    dst = url_to_storage_plugin(dst_path)
    try:
        metadata = Snapshot(src_path).metadata  # validates that src is committed
        if cas.manifest_uses_cas(metadata.manifest) or metadata.journal is not None:
            # A CAS step's payloads live in its root's shared cas/ store and
            # a journal segment references a replay chain: both copy chunk by
            # chunk through the two roots.
            return _copy_cas_snapshot(
                src_path, dst_path, metadata, overwrite=overwrite, io_concurrency=io_concurrency, verify=verify
            )
        if dst.sync_exists(SNAPSHOT_METADATA_FNAME):
            if not overwrite:
                raise RuntimeError(
                    f"{dst_path} already holds a committed snapshot (pass overwrite=True to replace it)"
                )
            # Un-commit first: a reader must never see the old marker over
            # a half-replaced payload set.
            dst.sync_delete(SNAPSHOT_METADATA_FNAME)
        sizes = _payload_sizes(metadata)
        src_protocol, src_root = parse_url(src_path)
        same_backend = src_protocol == parse_url(dst_path)[0] and not force_stream
        budget = _ByteBudget(max_in_flight_bytes)

        def _copy_one(location: str, cancel: threading.Event) -> None:
            if cancel.is_set():
                raise _CopyCancelled("copy aborted by sibling failure")
            if same_backend and _server_side_copy(dst, src_root, location):
                return
            budget.acquire(sizes[location], cancel)
            try:
                read_io = ReadIO(path=location)
                src.sync_read(read_io)
                if cancel.is_set():
                    raise _CopyCancelled("copy aborted by sibling failure")
                # The read buffer as it is: a second copy would double what
                # the budget promises.
                dst.sync_write(WriteIO(path=location, buf=read_io.buf))
            finally:
                budget.release(sizes[location])

        # Largest first: the copy's tail is many small files, not one slab.
        ordered = sorted(sizes, key=lambda loc: -sizes[loc])
        _run_pool(_copy_one, ordered, lambda loc: loc, io_concurrency, src_path, dst_path)
        if verify:
            # Before the marker: a failed audit leaves an uncommitted copy.
            ok, corrupt, unreadable, problems = integrity.audit(dst, metadata, io_concurrency=io_concurrency)
            if corrupt or unreadable:
                raise ChecksumError(f"copy verification failed for {dst_path}: " + "; ".join(problems))
            if ok == 0:
                raise RuntimeError(f"cannot verify copy of {src_path}: the source manifest records no checksums")
        # The commit point: the marker goes last, verbatim from the source.
        marker = ReadIO(path=SNAPSHOT_METADATA_FNAME)
        src.sync_read(marker)
        dst.sync_write(WriteIO(path=SNAPSHOT_METADATA_FNAME, buf=marker.buf))
    finally:
        src.sync_close()
        dst.sync_close()
    return Snapshot(dst_path)


def _copy_cas_snapshot(
    src_path: str,
    dst_path: str,
    metadata,
    *,
    overwrite: bool,
    io_concurrency: int,
    verify: bool,
) -> Snapshot:
    """Chunk-level replication of a content-addressed step or a journal
    segment, through the two roots: every referenced chunk the destination
    root lacks is copied into its ``cas/`` store (a second step ships only
    its new chunks), then each chain member's non-CAS payloads, then the
    markers, chain members first and the target last.  Chunks, payloads and
    markers are all durable writes.

    A chain member already committed at the destination is trusted as
    shared lineage only when its manifest equals the source's; a torn one
    is copied again.  ``verify=True`` audits every chain member on the
    destination before any marker is written."""
    src_root_url = cas.parent_root_url(src_path)
    dst_root_url = cas.parent_root_url(dst_path)
    if src_root_url is None or dst_root_url is None:
        raise RuntimeError(
            f"cannot replicate {src_path} -> {dst_path}: a content-addressed snapshot must live one "
            "level under the root that owns its cas/ store on BOTH ends"
        )
    src_name = parse_url(src_path)[1].rstrip("/").rsplit("/", 1)[-1]
    dst_name = parse_url(dst_path)[1].rstrip("/").rsplit("/", 1)[-1]
    src_root = url_to_storage_plugin(src_root_url)
    dst_root = url_to_storage_plugin(dst_root_url)
    try:
        # (src dirname, dst dirname, manifest) per chain member, target last.
        chain = []
        if metadata.journal is not None:
            if dst_name != src_name:
                raise RuntimeError(
                    f"cannot rename a journal segment in transit ({src_name} -> {dst_name}): its chain "
                    "references segments by step number"
                )
            info = metadata.journal
            members = [f"step_{info['base_step']}"] + [f"seg_{p}" for p in info.get("prior_segments", [])]
            for dirname in members:
                try:
                    md = read_metadata(src_root, f"{dirname}/{SNAPSHOT_METADATA_FNAME}")
                except Exception as e:
                    raise RuntimeError(
                        f"cannot replicate {src_path}: chain member {dirname} is unreadable at the source ({e})"
                    ) from e
                chain.append((dirname, dirname, md))
        chain.append((src_name, dst_name, metadata))

        target_marker = f"{dst_name}/{SNAPSHOT_METADATA_FNAME}"
        if dst_root.sync_exists(target_marker):
            if not overwrite:
                raise RuntimeError(
                    f"{dst_path} already holds a committed snapshot (pass overwrite=True to replace it)"
                )
            dst_root.sync_delete(target_marker)

        # A same-numbered member from a DIFFERENT run must not become the
        # replica's replay base.
        shared_lineage = set()
        for _, dst_dir, md in chain[:-1]:
            marker = f"{dst_dir}/{SNAPSHOT_METADATA_FNAME}"
            if not dst_root.sync_exists(marker):
                continue
            try:
                dst_md = read_metadata(dst_root, marker)
            except Exception:
                continue  # a torn member (a crashed copy's debris): copy it again
            if dst_md.to_json() != md.to_json():
                raise RuntimeError(
                    f"cannot replicate {src_path}: the destination root already holds a committed "
                    f"{dst_dir} whose manifest differs from the source chain member — different "
                    "lineage; refusing to graft the segment onto foreign base data"
                )
            shared_lineage.add(dst_dir)

        chunks = set()
        for _, _, md in chain:
            chunks |= cas.referenced_chunk_relpaths(md.manifest)
        src_root_path = parse_url(src_root_url)[1]
        same_backend = parse_url(src_root_url)[0] == parse_url(dst_root_url)[0]

        def _copy_chunk(relpath: str) -> bool:
            # Chunks are immutable and digest-named: presence means the
            # bytes are there (verify=True audits them).
            if dst_root.sync_exists(relpath):
                return False
            if same_backend and _server_side_copy(dst_root, src_root_path, relpath):
                return True
            read_io = ReadIO(path=relpath)
            src_root.sync_read(read_io)
            dst_root.sync_write(WriteIO(path=relpath, buf=read_io.buf, durable=True))
            return True

        with ThreadPoolExecutor(max_workers=max(1, io_concurrency), thread_name_prefix="snap_cas_copy") as pool:
            copied_flags = list(pool.map(_copy_chunk, sorted(chunks)))
        copied = sum(copied_flags)
        logger.info(
            "cas copy %s -> %s: %d chunk(s) replicated, %d already present",
            src_path,
            dst_path,
            copied,
            len(copied_flags) - copied,
        )

        # Non-CAS payloads (mixed manifests are legal) of each member not
        # shared: pooled and byte-budgeted like the plain copy.
        payload_items = []
        for src_dir, dst_dir, md in chain:
            if dst_dir in shared_lineage:
                continue
            sizes = _payload_sizes(md)
            for location in sorted(
                {e.location for _, e in iter_payload_entries(md.manifest) if not cas.is_chunk_location(e.location)}
            ):
                payload_items.append((src_dir, dst_dir, location, sizes.get(location, 0)))
        budget = _ByteBudget(_DEFAULT_MAX_IN_FLIGHT_BYTES)

        def _copy_payload(item, cancel: threading.Event) -> None:
            p_src_dir, p_dst_dir, location, size = item
            if cancel.is_set():
                raise _CopyCancelled("copy aborted by sibling failure")
            budget.acquire(size, cancel)
            try:
                read_io = ReadIO(path=f"{p_src_dir}/{location}")
                src_root.sync_read(read_io)
                # Durable like the chunks: the fsynced markers below must
                # never commit over page-cache payload bytes.
                dst_root.sync_write(WriteIO(path=f"{p_dst_dir}/{location}", buf=read_io.buf, durable=True))
            finally:
                budget.release(size)

        _run_pool(_copy_payload, payload_items, lambda item: item[2], io_concurrency, src_path, dst_path)

        if verify:
            # Before ANY marker lands.
            total_ok = 0
            for _, dst_dir, md in chain:
                dst_step = url_to_storage_plugin(f"{dst_root_url}/{dst_dir}")
                wrapped = cas.maybe_wrap_cas_reads(dst_step, f"{dst_root_url}/{dst_dir}", md)
                try:
                    ok, corrupt, unreadable, problems = integrity.audit(wrapped, md, io_concurrency=io_concurrency)
                finally:
                    wrapped.sync_close()
                if corrupt or unreadable:
                    raise ChecksumError(
                        f"copy verification failed for {dst_root_url}/{dst_dir}: " + "; ".join(problems)
                    )
                total_ok += ok
            if total_ok == 0:
                raise RuntimeError(f"cannot verify copy of {src_path}: the source manifests record no checksums")

        # Markers last, in chain order (base, priors, target): every commit
        # a reader can see replays from what already landed.
        for src_dir, dst_dir, _ in chain:
            if dst_dir in shared_lineage:
                continue
            read_io = ReadIO(path=f"{src_dir}/{SNAPSHOT_METADATA_FNAME}")
            src_root.sync_read(read_io)
            dst_root.sync_write(WriteIO(path=f"{dst_dir}/{SNAPSHOT_METADATA_FNAME}", buf=read_io.buf, durable=True))
    finally:
        src_root.sync_close()
        dst_root.sync_close()
    return Snapshot(dst_path)
