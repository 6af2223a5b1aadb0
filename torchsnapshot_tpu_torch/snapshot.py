"""The Snapshot API: take / async_take / restore / read_object.

Counterpart of ``torchsnapshot_tpu/snapshot.py`` for the single-process
slices, in the JAX order:

- ``take``: flatten each stateful's state dict (RNG state last) into a
  manifest, plan one write per leaf (chunking tensors above 512 MB), batch
  small writes into slabs, execute the budgeted pipeline (D2H into pinned
  buffers, fused write+hash), then commit ``.snapshot_metadata`` — the one
  durable write whose existence means "committed".  A take that fails
  before its commit removes its partial directory.
- ``async_take``: the same take, returning a :class:`PendingSnapshot` once
  the state is snapshot-stable (copied on the card, into pinned host
  memory, or staged to the host: device_staging.py); the storage drain and
  the commit run on a background thread.
- ``restore``: per stateful, read every entry in place into the tensors its
  current ``state_dict()`` returns (same ``data_ptr()`` before and after),
  uploading CUDA targets through an :class:`H2DBatcher` that is drained
  before the stateful's ``load_state_dict`` runs.
- ``read_object``: random access to one value; a tensor with no target is
  placed on ``device``, which defaults to ``"cuda"``.

Every entry point runs on N torch.distributed ranks.  The ranks coordinate
through object collectives over a KV store (pg_wrapper.py; the default
process group is ``PGWrapper.from_torch()``), never through a collective
on payloads: rank 0 gathers the per-rank manifests, dedups replicated and
HSDP-replicated payloads so each is written once (partitioner.py), and
commits ``.snapshot_metadata`` once.  DTensors are written as sharded
entries and restore into any world size and placement
(io_preparers/sharded_array.py, manifest_ops.py).  A liveness lease per
operation lets peers of a rank that dies abort in about
``TPUSNAP_LEASE_GRACE_S`` (dist_store.py).

Storage depth: payloads are framed with the ``TPUSNAP_COMPRESSION`` codec
(compression.py); with ``TPUSNAP_CAS`` they are written once into the
content-addressed store of the snapshot's parent directory (cas.py), split
on content-defined edges with ``TPUSNAP_CDC`` (chunker.py), and unchanged
leaves become references before they are staged; ``incremental_from``
hard-links unchanged payloads of a base snapshot (incremental.py).  Reads
resolve chunk references whatever the knobs say.

Telemetry: every committed take and async take, and every restore, writes
a per-rank sidecar under the snapshot's ``telemetry/`` (telemetry/
sidecar.py) that the manager's step history and restore-point times read.
``manifest_transform`` lets the manager's journal (journal.py) commit a
delta manifest; a journal segment is restored only through the manager's
replay (manager.py).
"""

from __future__ import annotations

import fnmatch
import inspect
import logging
import random
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from . import cas, device_staging, io_preparer, journal, knobs, phase_stats, preemption, retry as retry_policy, staging
from .batcher import batch_read_requests, batch_write_requests
from .dist_store import LinearBarrier, StorePeerError, acquire_op_lease, release_op_lease
from .event import Event
from .event_handlers import log_event
from .flatten import flatten, inflate
from .io_preparers.array import H2DBatcher
from .io_types import Future, ReadIO, ReadReq, StoragePlugin, WriteIO, WriteReq
from .manifest import (
    ChunkedTensorEntry,
    Entry,
    Manifest,
    PrimitiveEntry,
    ShardedArrayEntry,
    SnapshotMetadata,
    TensorEntry,
    manifest_version_for,
)
from .manifest_ops import get_manifest_for_rank, handle_sharded_array_elasticity
from .manifest_utils import is_container_entry
from .partitioner import consolidate_replicated_entries, partition_write_reqs
from .pg_wrapper import PGWrapper
from .rng_state import RNGState
from .rss_profiler import RSSWatermark
from .scheduler import (
    DeferredIOWork,
    get_process_memory_budget_bytes,
    sync_execute_read_reqs,
    sync_execute_write_reqs,
)
from .stateful import AppState, Stateful
from .storage_plugin import url_to_storage_plugin
from .telemetry import sidecar as tsidecar

logger = logging.getLogger(__name__)

SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"

Device = Union[str, torch.device, None]


class Snapshot:
    """A committed snapshot at ``path`` (a directory, or ``memory://``)."""

    def __init__(
        self,
        path: str,
        pg: Optional[PGWrapper] = None,
        storage_options: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.path = path
        self._pg = pg or PGWrapper.from_torch()
        self._metadata: Optional[SnapshotMetadata] = None
        self._storage_options = storage_options

    # ------------------------------------------------------------------ take

    @classmethod
    def take(
        cls,
        path: str,
        app_state: AppState,
        pg: Optional[PGWrapper] = None,
        replicated: Optional[List[str]] = None,
        incremental_from: Optional[str] = None,
        storage_options: Optional[Dict[str, Any]] = None,
        cas_index: Optional["cas.DigestIndex"] = None,
        manifest_transform: Optional[Callable[[SnapshotMetadata], SnapshotMetadata]] = None,
    ) -> "Snapshot":
        """Collective over ``pg`` (default: ``PGWrapper.from_torch()``).
        ``replicated``: globs of logical paths that hold the same value on
        every rank; each is written once.  DTensors whose placements are all
        ``Replicate`` are replicated without a glob.  Rank 0's ``path``
        wins.

        ``incremental_from``: a committed base snapshot on the same
        backend; payloads whose bytes are unchanged are hard-linked from it
        instead of written (incremental.py).  ``storage_options``:
        per-plugin settings overriding the environment.  ``cas_index``: a
        caller-maintained ``cas.DigestIndex`` for ``TPUSNAP_CAS`` takes,
        which skips seeding it from the root's manifests.

        ``manifest_transform``: rank 0 applies it to the gathered metadata
        right before the commit write (the journal's delta filter); the
        returned handle keeps the full metadata.  Pure computation; an
        exception fails the take."""
        knobs.warn_unimplemented_knobs()
        pg = pg or PGWrapper.from_torch()
        unique_id = _gen_unique_id(pg)
        event_metadata: Dict[str, Any] = {
            "unique_id": unique_id,
            "rank": pg.get_rank(),
            "action": "take",
        }
        log_event(Event(name="take.start", metadata=dict(event_metadata)))
        begin = time.monotonic()
        phases_before = phase_stats.snapshot()
        rss = RSSWatermark()
        in_flight = _TakeInFlight()
        preemption.track_save(in_flight)
        # Liveness lease: while this rank is inside the take its store-side
        # lease stays fresh, so peers blocked in a wait detect its death in
        # about TPUSNAP_LEASE_GRACE_S (dist_store.OpLease).
        lease = acquire_op_lease(pg.store, pg.get_rank())
        try:
            cls._validate_app_state(app_state)
            path, replicated_patterns = cls._coalesce_path_and_replicated(
                path, pg, replicated or []
            )
            storage = cls._take_storage(path, storage_options, cas_index, incremental_from)
            try:
                try:
                    pending_io_work, entries, _ = cls._take_impl(
                        app_state, replicated_patterns, storage, pg, is_async_snapshot=False
                    )
                    pending_io_work.sync_complete()
                    nbytes = pending_io_work.bytes_total
                    # Every payload landed: point the entries that went
                    # into the chunk store at their chunks before the
                    # manifest is gathered (a no-op without CAS).
                    cas.apply_relocations(storage, entries)
                    # Stagers annotated their entries with digests during the
                    # pipeline, so the manifest is complete only now.
                    global_manifest = cls._gather_manifest(entries, pg)
                    metadata = SnapshotMetadata(
                        version=manifest_version_for(global_manifest),
                        world_size=pg.get_world_size(),
                        manifest=global_manifest,
                    )
                    # Every rank's payloads are durable → rank 0 commits.
                    # The transform shapes only what is written; the handle
                    # keeps the full view.
                    pg.barrier()
                    committed_md = metadata
                    if pg.get_rank() == 0:
                        if manifest_transform is not None:
                            committed_md = manifest_transform(metadata)
                        cls._write_snapshot_metadata(committed_md, storage)
                    pg.barrier()
                except BaseException:
                    cls._cleanup_failed_take(storage, pg)
                    raise
                _write_sidecar(
                    storage,
                    "take",
                    unique_id,
                    pg,
                    time.monotonic() - begin,
                    phases_before,
                    rss,
                    nbytes=nbytes,
                    committed_md=committed_md,
                )
            finally:
                storage.sync_close()
        except Exception:
            event_metadata["duration_s"] = time.monotonic() - begin
            event_metadata["is_success"] = False
            log_event(Event(name="take.end", metadata=event_metadata))
            raise
        finally:
            in_flight.finish()
            release_op_lease(lease)
        snapshot = cls(path=path, pg=pg, storage_options=storage_options)
        snapshot._metadata = metadata
        event_metadata["duration_s"] = time.monotonic() - begin
        event_metadata["bytes"] = nbytes
        cas_stats = cas.writer_stats(storage)
        if cas_stats is not None:
            # Logical against physical bytes: what dedup saved this rank.
            event_metadata["cas"] = cas_stats
        if incremental_from is not None:
            from .incremental import linked_payloads

            event_metadata["incremental_links"] = linked_payloads(storage) or 0
        event_metadata["is_success"] = True
        log_event(Event(name="take.end", metadata=event_metadata))
        return snapshot

    @classmethod
    def async_take(
        cls,
        path: str,
        app_state: AppState,
        pg: Optional[PGWrapper] = None,
        replicated: Optional[List[str]] = None,
        incremental_from: Optional[str] = None,
        storage_options: Optional[Dict[str, Any]] = None,
        cas_index: Optional["cas.DigestIndex"] = None,
        manifest_transform: Optional[Callable[[SnapshotMetadata], SnapshotMetadata]] = None,
    ) -> "PendingSnapshot":
        """Returns once the app state is snapshot-stable; storage I/O and the
        metadata commit continue on a background thread.  The caller may
        mutate, free or reuse every tensor as soon as this returns.

        How the state is made stable depends on the staging mode
        (device_staging.py, ``TPUSNAP_ASYNC_STAGING``): ``pinned_host`` (the
        default on CUDA) copies each CUDA tensor into page-locked host
        memory, ``device`` copies it into fresh device memory, and both copy
        CPU tensors, numpy arrays and objects on this thread; the D2H and the
        storage drain then run in the background.  ``host`` stages every
        buffer to host memory before returning.  Only what this rank writes
        after dedup is copied.  Collective like :meth:`take`; the ranks
        commit once, through a store-based two-phase barrier.
        ``incremental_from``, ``storage_options``, ``cas_index`` and
        ``manifest_transform`` (applied on the commit thread) as in
        :meth:`take`."""
        knobs.warn_unimplemented_knobs()
        pg = pg or PGWrapper.from_torch()
        unique_id = _gen_unique_id(pg)
        event_metadata: Dict[str, Any] = {
            "unique_id": unique_id,
            "rank": pg.get_rank(),
            "action": "async_take",
        }
        log_event(Event(name="async_take.start", metadata=dict(event_metadata)))
        begin = time.monotonic()
        phases_before = phase_stats.snapshot()
        rss = RSSWatermark()
        # Held through the background commit; the PendingSnapshot releases
        # it when its thread finishes.
        lease = acquire_op_lease(pg.store, pg.get_rank())
        try:
            cls._validate_app_state(app_state)
            path, replicated_patterns = cls._coalesce_path_and_replicated(
                path, pg, replicated or []
            )
            storage = cls._take_storage(path, storage_options, cas_index, incremental_from)
            try:
                pending_io_work, _, finalizer = cls._take_impl(
                    app_state, replicated_patterns, storage, pg, is_async_snapshot=True
                )
            except BaseException:
                cls._cleanup_failed_take(storage, pg, action="async_take")
                storage.sync_close()
                raise
        except BaseException:
            # Every async_take.start reaches an async_take.end, also when
            # planning or staging raises before the background thread exists.
            release_op_lease(lease)
            event_metadata["duration_s"] = time.monotonic() - begin
            event_metadata["is_success"] = False
            log_event(Event(name="async_take.end", metadata=event_metadata))
            raise
        return PendingSnapshot(
            path=path,
            pending_io_work=pending_io_work,
            pg=pg,
            finalizer=finalizer,
            storage=storage,
            unique_id=unique_id,
            stall_s=time.monotonic() - begin,
            lease=lease,
            storage_options=storage_options,
            manifest_transform=manifest_transform,
            phases_before=phases_before,
            rss=rss,
        )

    @staticmethod
    def _take_storage(
        path: str,
        storage_options: Optional[Dict[str, Any]],
        cas_index: Optional["cas.DigestIndex"],
        incremental_from: Optional[str],
    ) -> StoragePlugin:
        """The take's storage stack: CAS first, then incremental, which
        steps aside for the CAS writer (content addressing dedups against
        every committed step, the base included)."""
        storage = url_to_storage_plugin(path, storage_options)
        try:
            storage = cas.maybe_wrap_cas_writes(storage, path, storage_options, index=cas_index)
            if incremental_from is not None:
                from .incremental import maybe_wrap_incremental

                storage = maybe_wrap_incremental(storage, incremental_from, target_path=path)
        except BaseException:
            storage.sync_close()
            raise
        return storage

    @classmethod
    def _take_impl(
        cls,
        app_state: AppState,
        replicated_patterns: List[str],
        storage: StoragePlugin,
        pg: PGWrapper,
        is_async_snapshot: bool,
    ) -> Tuple[Any, Optional[Manifest], Optional["_ManifestFinalizer"]]:
        """Flatten, plan, partition, stage (async takes) and start the write
        pipeline.  Returns (I/O work to complete, this rank's entries for a
        synchronous take, the manifest finalizer of an async take)."""
        rank = pg.get_rank()
        world_size = pg.get_world_size()
        app_state = dict(app_state)
        rng_state_item = cls._pop_rng_state(app_state)

        # Taking a snapshot must not perturb the global RNGs.
        py_rng_state, np_rng_state = random.getstate(), np.random.get_state()

        manifest: Manifest = {}
        flattened: Dict[str, Any] = {}
        # _gather_keys checked that every rank has every key, so nothing in
        # the per-key barrier loop below can diverge across ranks.
        for key in cls._gather_keys(app_state, pg):
            # A state_dict() may itself run collectives: one key at a time.
            key_manifest, key_flattened = flatten(
                app_state[key].state_dict(), prefix=key
            )
            manifest.update(key_manifest)
            flattened.update(key_flattened)
            pg.barrier()
        if rng_state_item is not None:
            key, stateful = rng_state_item
            key_manifest, key_flattened = flatten(stateful.state_dict(), prefix=key)
            manifest.update(key_manifest)
            flattened.update(key_flattened)

        random.setstate(py_rng_state)
        np.random.set_state(np_rng_state)

        replicated_paths = cls._calculate_replicated_entries(
            flattened, replicated_patterns, pg
        )

        # Plan on the live state, host-staging semantics (CPU values copied
        # at staging in an async take), then dedup across ranks.
        entries: Manifest = dict(manifest)
        write_reqs: List[WriteReq] = []
        for logical_path, obj in flattened.items():
            entry, obj_write_reqs = io_preparer.prepare_write(
                obj=obj,
                logical_path=logical_path,
                rank=rank,
                replicated=logical_path in replicated_paths,
                is_async_snapshot=is_async_snapshot,
            )
            entries[logical_path] = entry
            write_reqs += obj_write_reqs
        entries, write_reqs = partition_write_reqs(entries, write_reqs, pg)

        # Async takes copy what this rank writes (on the card, into pinned
        # host memory, or on the host for CPU values) so that async_take
        # can return before any D2H of the drain runs (device_staging.py).
        # The JAX package copies every leaf before the partition; copying
        # after it skips the payloads another rank writes.
        staging_mode = "host"
        staging_stats: Dict[str, Any] = {}
        if is_async_snapshot:
            staging_mode = device_staging.resolve_mode(
                {str(i): wr.buffer_stager.source for i, wr in enumerate(write_reqs)},  # type: ignore[attr-defined]
                pg=pg if world_size > 1 else None,
                emit_events=True,
            )
        # Streaming delta detection (cas.prestage_delta_skip): unchanged
        # leaves become chunk references before batching, compression and
        # the pipeline.  Skipped for device-staged async takes, whose D2H
        # belongs to the background thread, not to the caller's stall.
        if not (is_async_snapshot and staging_mode != "host"):
            write_reqs, _ = cas.prestage_delta_skip(storage, entries, write_reqs)
        if is_async_snapshot:
            stagers = [wr.buffer_stager for wr in write_reqs]
            sources = {str(i): st.source for i, st in enumerate(stagers)}  # type: ignore[attr-defined]
            if staging_mode != "host":
                try:
                    staged, staging_stats = device_staging.stage_app_state(
                        sources, staging_mode
                    )
                except Exception as staging_exc:  # noqa: BLE001 — evented
                    logger.warning(
                        "Device-side async staging failed; falling back to host "
                        "staging (stage-before-return)",
                        exc_info=True,
                    )
                    device_staging._log_downgrade_event(
                        staging_mode,
                        "host",
                        f"{type(staging_exc).__name__}: {staging_exc}",
                    )
                    staging_mode = "host"
                else:
                    for i, stager in enumerate(stagers):
                        stager.restage(staged[str(i)])  # type: ignore[attr-defined]
                    staging_mode = staging_stats["mode"]
                    log_event(
                        Event(
                            name="async_take.device_staged",
                            metadata={"rank": rank, **staging_stats},
                        )
                    )

        if not knobs.is_batching_disabled():
            entries, write_reqs = batch_write_requests(
                entries, write_reqs, scatter_ok=storage.supports_scatter
            )
        memory_budget_bytes = get_process_memory_budget_bytes(pg)
        if not is_async_snapshot:
            pending = sync_execute_write_reqs(
                write_reqs=write_reqs,
                storage=storage,
                memory_budget_bytes=memory_budget_bytes,
                rank=rank,
            )
            return pending, entries, None
        # Stagers annotate entries with digests during staging, which for a
        # device-staged take runs on the background thread: the manifest is
        # finalized there.
        if staging_mode == "host":
            pending_io_work: Any = sync_execute_write_reqs(
                write_reqs=write_reqs,
                storage=storage,
                memory_budget_bytes=memory_budget_bytes,
                rank=rank,
            )
        else:
            pending_io_work = DeferredIOWork(
                write_reqs=write_reqs,
                storage=storage,
                memory_budget_bytes=memory_budget_bytes,
                rank=rank,
            )
        finalizer = _ManifestFinalizer(
            entries=entries,
            rank=rank,
            world_size=world_size,
            staging_mode=staging_mode,
            staging_stats=staging_stats,
        )
        return pending_io_work, None, finalizer

    # --------------------------------------------------------------- restore

    def restore(self, app_state: AppState, strict: bool = True) -> None:
        """Restores the app state in place, collectively over this handle's
        process group.  Dense, chunked and sharded CUDA uploads have landed
        when this returns.  DTensors restore into their local tensors from
        any saved world size and layout.  ``strict=False`` is forwarded to
        statefuls whose ``load_state_dict`` accepts it.  A journal delta
        segment is refused unless the manager's replay set its merged
        metadata on this handle."""
        knobs.warn_unimplemented_knobs()
        self._validate_app_state(app_state)
        pg = self._pg
        rank = pg.get_rank()
        unique_id = _gen_unique_id(pg)
        event_metadata: Dict[str, Any] = {
            "unique_id": unique_id,
            "rank": rank,
            "action": "restore",
        }
        log_event(Event(name="restore.start", metadata=dict(event_metadata)))
        begin = time.monotonic()
        phases_before = phase_stats.snapshot()
        rss = RSSWatermark()
        lease = acquire_op_lease(pg.store, rank)
        try:
            storage = url_to_storage_plugin(self.path, self._storage_options)
            try:
                metadata = self._get_metadata(storage)
                storage = self._wrap_reads(storage, metadata)
                app_state = dict(app_state)
                rng_state_item = self._pop_rng_state(app_state)
                global_keys = self._gather_keys(app_state, pg)
                memory_budget_bytes = get_process_memory_budget_bytes(pg)
                for key in global_keys:
                    self._load_stateful(
                        stateful_key=key,
                        stateful=app_state[key],
                        metadata=metadata,
                        storage=storage,
                        memory_budget_bytes=memory_budget_bytes,
                        strict=strict,
                    )
                    pg.barrier()
                # RNG restored last so nothing later perturbs it.
                if rng_state_item is not None:
                    key, stateful = rng_state_item
                    self._load_stateful(
                        stateful_key=key,
                        stateful=stateful,
                        metadata=metadata,
                        storage=storage,
                        memory_budget_bytes=memory_budget_bytes,
                    )
                _write_sidecar(storage, "restore", unique_id, pg, time.monotonic() - begin, phases_before, rss)
            finally:
                storage.sync_close()
        except Exception:
            event_metadata["duration_s"] = time.monotonic() - begin
            event_metadata["is_success"] = False
            log_event(Event(name="restore.end", metadata=event_metadata))
            raise
        finally:
            release_op_lease(lease)
        event_metadata["duration_s"] = time.monotonic() - begin
        event_metadata["is_success"] = True
        log_event(Event(name="restore.end", metadata=event_metadata))

    def _load_stateful(
        self,
        stateful_key: str,
        stateful: Stateful,
        metadata: SnapshotMetadata,
        storage: StoragePlugin,
        memory_budget_bytes: int,
        strict: bool = True,
    ) -> None:
        rank = self._pg.get_rank()
        local_manifest, merged_entries = get_manifest_for_rank(metadata, rank)
        # The current state dict provides the in-place restore targets.
        _, target_flattened = flatten(stateful.state_dict(), prefix=stateful_key)
        tensor_requests = [
            path
            for path, obj in target_flattened.items()
            if isinstance(obj, (torch.Tensor, np.ndarray))
        ]
        handle_sharded_array_elasticity(local_manifest, merged_entries, tensor_requests)
        sub_manifest = _sub_manifest(local_manifest, stateful_key)
        if not sub_manifest:
            logger.warning(
                "No entries for stateful %r in snapshot (rank %d)", stateful_key, rank
            )
            return
        resolved, container_entries = _read_entries(
            sub_manifest,
            targets=target_flattened,
            storage=storage,
            memory_budget_bytes=memory_budget_bytes,
            rank=rank,
            device=None,
        )
        restored_state_dict = inflate(container_entries, resolved, prefix=stateful_key)
        if not strict and _accepts_strict(stateful):
            stateful.load_state_dict(restored_state_dict, strict=False)  # type: ignore[call-arg]
        else:
            stateful.load_state_dict(restored_state_dict)

    # ----------------------------------------------------------- read_object

    def read_object(
        self,
        path: str,
        obj_out: Optional[Any] = None,
        device: Device = None,
        memory_budget_bytes: Optional[int] = None,
    ) -> Any:
        """Random access to one value; ``path`` is ``"<rank>/<logical_path>"``.
        Not collective: any rank may call it alone, for any saved rank.

        ``obj_out``: a tensor, DTensor or numpy array to restore into in
        place.  Without one, a tensor (a sharded one assembled whole) is
        placed on ``device`` (default ``"cuda"``).  ``memory_budget_bytes``
        bounds the read buffers (large dense tensors read in tiles under
        it)."""
        knobs.warn_unimplemented_knobs()
        event_metadata: Dict[str, Any] = {
            "unique_id": uuid.uuid4().hex,
            "rank": self._pg.get_rank(),
            "action": "read_object",
        }
        log_event(Event(name="read_object.start", metadata=dict(event_metadata)))
        begin = time.monotonic()
        try:
            rank_str, _, logical_path = path.partition("/")
            storage = url_to_storage_plugin(self.path, self._storage_options)
            try:
                metadata = self._get_metadata(storage)
                storage = self._wrap_reads(storage, metadata)
                manifest, _ = get_manifest_for_rank(metadata, int(rank_str))
                if logical_path not in manifest:
                    raise RuntimeError(
                        f"Path {path!r} does not exist in the snapshot "
                        f"(available under rank {rank_str}: "
                        f"{sorted(manifest.keys())[:20]}...)"
                    )
                entry = manifest[logical_path]
                value = _read_one(
                    entry,
                    obj_out=obj_out,
                    device=(
                        _resolve_device(device)
                        if obj_out is None and _is_tensor_entry(entry)
                        else None
                    ),
                    storage=storage,
                    memory_budget_bytes=memory_budget_bytes,
                    rank=self._pg.get_rank(),
                )
            finally:
                storage.sync_close()
        except Exception:
            event_metadata["duration_s"] = time.monotonic() - begin
            event_metadata["is_success"] = False
            log_event(Event(name="read_object.end", metadata=event_metadata))
            raise
        event_metadata["duration_s"] = time.monotonic() - begin
        event_metadata["is_success"] = True
        log_event(Event(name="read_object.end", metadata=event_metadata))
        return value

    def get_manifest(self) -> Dict[str, Entry]:
        """A copy of the global manifest."""
        return dict(self.metadata.manifest)

    def get_state_dict_for_key(
        self, key: str, device: Device = None, replicate_from_rank0: bool = False
    ) -> Dict[str, Any]:
        """Materialize the state dict saved under an app-state key for this
        rank, without a target stateful; tensors land on ``device`` (default
        ``"cuda"``).  This rank's view holds its own entries, the replicated
        ones and every sharded entry whole.  ``replicate_from_rank0`` reads
        rank 0's view instead (a snapshot taken at a smaller world size,
        where this rank has no view of its own).  Not collective."""
        storage = url_to_storage_plugin(self.path, self._storage_options)
        try:
            metadata = self._get_metadata(storage)
            storage = self._wrap_reads(storage, metadata)
            rank = 0 if replicate_from_rank0 else self._pg.get_rank()
            local_manifest, _ = get_manifest_for_rank(metadata, rank)
            sub_manifest = _sub_manifest(local_manifest, key)
            if not sub_manifest:
                raise RuntimeError(f"Key {key!r} not found in snapshot manifest")
            resolved, container_entries = _read_entries(
                sub_manifest,
                targets={},
                storage=storage,
                memory_budget_bytes=get_process_memory_budget_bytes(PGWrapper()),
                rank=self._pg.get_rank(),
                device=(
                    _resolve_device(device)
                    if any(_is_tensor_entry(e) for e in sub_manifest.values())
                    else None
                ),
            )
        finally:
            storage.sync_close()
        return inflate(container_entries, resolved, prefix=key)

    # --------------------------------------------------------------- helpers

    def _wrap_reads(self, storage: StoragePlugin, metadata: SnapshotMetadata) -> StoragePlugin:
        """Chunk references resolve against the root's store.  A journal
        delta segment holds partial state and is refused outside the
        manager's replay, which sets the merged metadata on the handle."""
        if metadata.journal is not None:
            raise RuntimeError(
                f"{self.path} is a journal delta segment (manifest version "
                f"{metadata.version}); restore it via "
                "SnapshotManager.restore_latest()/restore_at(), which replay "
                "the journal over its base snapshot"
            )
        try:
            return cas.maybe_wrap_cas_reads(storage, self.path, metadata, self._storage_options)
        except BaseException:
            storage.sync_close()
            raise

    @property
    def metadata(self) -> SnapshotMetadata:
        storage = url_to_storage_plugin(self.path, self._storage_options)
        try:
            return self._get_metadata(storage)
        finally:
            storage.sync_close()

    def _get_metadata(self, storage: StoragePlugin) -> SnapshotMetadata:
        if self._metadata is None:
            read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
            try:
                storage.sync_read(read_io)
            except OSError as e:
                raise RuntimeError(
                    f"{self.path} does not appear to be a valid snapshot: "
                    f"missing or unreadable {SNAPSHOT_METADATA_FNAME} ({e}). "
                    "The snapshot may be incomplete (metadata commits last)."
                ) from None
            self._metadata = SnapshotMetadata.from_json(
                bytes(read_io.buf).decode("utf-8")
            )
        return self._metadata

    @staticmethod
    def _write_snapshot_metadata(
        metadata: SnapshotMetadata, storage: StoragePlugin
    ) -> None:
        """Rank 0's commit: a durable write (fsync + atomic rename + parent
        fsync on fs), retried on transient failures."""
        payload = metadata.to_json().encode("utf-8")
        retry_policy.call_with_retries(
            lambda: storage.sync_write(
                WriteIO(path=SNAPSHOT_METADATA_FNAME, buf=payload, durable=True)
            ),
            stage="commit",
        )

    @staticmethod
    def _cleanup_failed_take(
        storage: StoragePlugin, pg: PGWrapper, action: str = "take"
    ) -> None:
        """Remove the partial directory of a take that failed before its
        commit (rank 0, and only while the commit marker is absent).  A
        failing cleanup is logged: the take's own error is what raises."""
        if pg.get_rank() != 0:
            return
        try:
            if storage.sync_exists(SNAPSHOT_METADATA_FNAME):
                return
            storage.sync_delete_dir("")
            logger.warning("%s failed before commit; removed its partial snapshot", action)
        except Exception:  # noqa: BLE001 — never mask the take's error
            logger.warning(
                "%s failed before commit and its cleanup failed too",
                action,
                exc_info=True,
            )

    @staticmethod
    def install_preemption_handler(
        signum: Optional[int] = None, chain: bool = True
    ) -> "preemption.PreemptionHandler":
        """Register the SIGTERM emergency-flush handler (preemption.py): on
        preemption the process enters deadline mode for the
        ``TPUSNAP_SAVE_DEADLINE_S`` budget (io concurrency raised) and
        drives any in-flight ``async_take`` to a committed state inside the
        grace window, bracketed by ``preemption.flush`` start/end events.
        Main thread only; returns a handler with ``.uninstall()``."""
        return preemption.install_handler(signum=signum, chain=chain)

    @staticmethod
    def _validate_app_state(app_state: AppState) -> None:
        for key, value in app_state.items():
            if not (
                hasattr(value, "state_dict") and hasattr(value, "load_state_dict")
            ):
                raise TypeError(
                    f"app_state[{key!r}] (type {type(value).__name__}) is not "
                    "Stateful: it must define state_dict()/load_state_dict(). "
                    "Wrap plain values in torchsnapshot_tpu_torch.StateDict."
                )

    @staticmethod
    def _pop_rng_state(
        app_state: Dict[str, Stateful],
    ) -> Optional[Tuple[str, RNGState]]:
        """RNG statefuls are saved and restored last, so other statefuls'
        state_dict calls cannot perturb them."""
        rng_keys = [k for k, v in app_state.items() if isinstance(v, RNGState)]
        if len(rng_keys) > 1:
            raise RuntimeError(
                f"App state cannot have more than one RNGState: {rng_keys}"
            )
        if rng_keys:
            key = rng_keys[0]
            return key, app_state.pop(key)  # type: ignore[return-value]
        return None

    @staticmethod
    def _gather_keys(app_state: AppState, pg: PGWrapper) -> List[str]:
        """Sorted union of the app-state keys across ranks, with coverage
        checked symmetrically: every rank learns (through one reduce and
        broadcast) which ranks miss which keys, and every rank raises the
        same error.  A divergence found by one rank inside the per-key
        barrier loop would instead park its peers in that loop's barrier
        until the timeout."""

        def _reduce(per_rank: List[List[str]]):
            union: Set[str] = set().union(*map(set, per_rank))
            missing = {
                rank: sorted(union - set(keys))
                for rank, keys in enumerate(per_rank)
                if union - set(keys)
            }
            return sorted(union), missing

        union, missing = pg.all_reduce_object(sorted(app_state.keys()), _reduce)
        if missing:
            raise RuntimeError(
                "app_state keys diverge across ranks; all ranks must "
                "snapshot/restore the same keys: "
                + "; ".join(
                    f"rank {rank} is missing {keys}"
                    for rank, keys in sorted(missing.items())
                )
            )
        return union

    @staticmethod
    def _coalesce_path_and_replicated(
        path: str, pg: PGWrapper, replicated: List[str]
    ) -> Tuple[str, List[str]]:
        """Rank 0's path wins; the ranks' replicated globs are unioned (one
        reduce-and-broadcast)."""

        def _reduce(per_rank):
            union: Set[str] = set()
            for _, patterns in per_rank:
                union.update(patterns)
            return per_rank[0][0], sorted(union)

        return pg.all_reduce_object((path, sorted(set(replicated))), _reduce)

    @staticmethod
    def _calculate_replicated_entries(
        flattened: Dict[str, Any], replicated_patterns: List[str], pg: PGWrapper
    ) -> Set[str]:
        """Paths written once for all ranks: glob matches and fully
        replicated DTensors, kept only where every rank agrees."""
        candidates = {
            path
            for path in flattened
            if any(fnmatch.fnmatch(path, pattern) for pattern in replicated_patterns)
        }
        for path, obj in flattened.items():
            if staging.is_fully_replicated(obj):
                candidates.add(path)
        if pg.get_world_size() == 1:
            return candidates
        verified = set(
            pg.all_reduce_object(
                sorted(candidates),
                lambda per_rank: sorted(set.intersection(*map(set, per_rank))),
            )
        )
        dropped = candidates - verified
        if dropped:
            logger.warning(
                "Paths marked replicated on this rank but not all ranks "
                "(flag dropped): %s",
                sorted(dropped)[:10],
            )
        return verified

    @staticmethod
    def _gather_manifest(entries: Manifest, pg: PGWrapper) -> Manifest:
        """Rank 0 gathers every rank's entries, consolidates the replicated
        ones into its own, builds the rank-prefixed global manifest and
        broadcasts it (O(world) store traffic)."""
        gathered: Optional[List[Manifest]] = pg.gather_object_root(entries)
        obj_list: List[Manifest] = [{}]
        if gathered is not None:
            obj_list[0] = _rank_prefixed(consolidate_replicated_entries(gathered))
        pg.broadcast_object_list(obj_list, src=0)
        return obj_list[0]


class _TakeInFlight:
    """A running synchronous take, as the preemption flush watcher sees it."""

    def __init__(self) -> None:
        self._done = False

    def done(self) -> bool:
        return self._done

    def finish(self) -> None:
        self._done = True


class _ManifestFinalizer:
    """Builds the global manifest of an async take on its background thread,
    once that rank's staging and storage I/O have drained: stagers annotate
    per-entry digests during staging, which for device-staged takes runs
    after ``async_take`` has returned.

    The cross-rank exchange goes through storage, since the background
    thread issues no collectives: each rank other than 0 writes its entries
    as a sidecar payload before it arrives at the commit barrier; rank 0,
    which the barrier's arrive holds until every sidecar is durable, reads
    them, consolidates the replicated entries, commits, and removes the
    sidecars.
    """

    SIDECAR_FMT = ".manifest_rank_{rank}"

    def __init__(
        self,
        entries: Manifest,
        rank: int,
        world_size: int,
        staging_mode: str,
        staging_stats: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.entries = entries
        self._rank = rank
        self._world_size = world_size
        self.staging_mode = staging_mode
        self.staging_stats = staging_stats or {}

    def write_sidecar(self, storage: StoragePlugin) -> None:
        """Ranks other than 0: persist this rank's digest-annotated entries
        for rank 0 to merge.  Runs before the commit barrier's arrive."""
        if self._rank == 0 or self._world_size == 1:
            return
        payload = SnapshotMetadata(
            version=manifest_version_for(self.entries),
            world_size=self._world_size,
            manifest=self.entries,
        ).to_json()
        storage.sync_write(
            WriteIO(
                path=self.SIDECAR_FMT.format(rank=self._rank),
                buf=payload.encode("utf-8"),
            )
        )

    def build_global(self, storage: StoragePlugin) -> SnapshotMetadata:
        """Rank 0, after every rank arrived: merge the sidecars into the
        rank-prefixed global manifest (the sync take's consolidation)."""
        gathered: List[Manifest] = [self.entries]
        for r in range(1, self._world_size):
            read_io = ReadIO(path=self.SIDECAR_FMT.format(rank=r))
            storage.sync_read(read_io)
            gathered.append(
                SnapshotMetadata.from_json(bytes(read_io.buf).decode("utf-8")).manifest
            )
        global_manifest = _rank_prefixed(consolidate_replicated_entries(gathered))
        return SnapshotMetadata(
            version=manifest_version_for(global_manifest),
            world_size=self._world_size,
            manifest=global_manifest,
        )

    def cleanup_sidecars(self, storage: StoragePlugin) -> None:
        """Rank 0, after the commit: best-effort sidecar removal (a leftover
        sidecar is harmless, dot-prefixed outside every payload path)."""
        for r in range(1, self._world_size):
            try:
                storage.sync_delete(self.SIDECAR_FMT.format(rank=r))
            except OSError:
                pass


class PendingSnapshot:
    """Handle of an in-flight async take.  A background thread completes
    the storage I/O (and, for device-staged takes, the whole write
    pipeline), builds the manifest and commits ``.snapshot_metadata``; a
    failure before the commit removes the partial snapshot.

    The background thread issues no collectives: across ranks the commit
    goes through a store-based :class:`LinearBarrier` (every rank arrives
    once its payloads and sidecar are durable, rank 0 commits, then
    departs), and a failure on any rank, or a peer whose liveness lease
    expired, wakes every waiter with :class:`StorePeerError`."""

    def __init__(
        self,
        path: str,
        pending_io_work: Any,
        pg: PGWrapper,
        finalizer: _ManifestFinalizer,
        storage: StoragePlugin,
        unique_id: str,
        stall_s: float = 0.0,
        lease: Optional[Any] = None,
        storage_options: Optional[Dict[str, Any]] = None,
        manifest_transform: Optional[Callable[[SnapshotMetadata], SnapshotMetadata]] = None,
        phases_before: Optional[Dict[str, Dict[str, float]]] = None,
        rss: Optional[RSSWatermark] = None,
    ) -> None:
        self.path = path
        self._storage_options = storage_options
        self._manifest_transform = manifest_transform
        self._phases_before = phases_before or {}
        self._rss = rss or RSSWatermark()
        self.pg = pg
        self._lease = lease
        self._barrier: Optional[LinearBarrier] = None
        self._retired = False
        self._finalizer = finalizer
        self.stall_s = stall_s
        self._metadata: Optional[SnapshotMetadata] = None
        self._storage = storage
        self._unique_id = unique_id
        self.exception: Optional[BaseException] = None
        self._begin = time.monotonic()
        self._bytes_total = 0
        self._done_event = threading.Event()
        self._callbacks_lock = threading.Lock()
        self._done_callbacks: List[Callable[["PendingSnapshot"], Any]] = []
        preemption.track_save(self)
        self._thread = threading.Thread(
            target=self._complete_snapshot,
            args=(pending_io_work,),
            name="tpusnap-torch-pending-snapshot",
            daemon=True,
        )
        self._thread.start()

    def _complete_snapshot(self, pending_io_work: Any) -> None:
        barrier = None
        store = self.pg.store
        if store is not None and self.pg.get_world_size() > 1:
            barrier = LinearBarrier(
                prefix=f"pending_snapshot/{self._unique_id}",
                store=store,
                rank=self.pg.get_rank(),
                world_size=self.pg.get_world_size(),
            )
            self._barrier = barrier
        try:
            pending_io_work.sync_complete()
            self._bytes_total = pending_io_work.bytes_total
            # Chunk references before the entries go into the sidecar
            # exchange (a no-op without CAS).
            cas.apply_relocations(self._storage, self._finalizer.entries)
            # Payloads durable: exchange the digest-annotated manifests
            # through storage (no collectives on this thread); the arrive
            # orders rank 0's merge after every sidecar landed.
            self._finalizer.write_sidecar(self._storage)
            barrier_timeout_s = knobs.get_barrier_timeout_s()
            if barrier is not None:
                barrier.arrive(timeout_s=barrier_timeout_s)
            committed_md = None
            if self.pg.get_rank() == 0:
                # The handle keeps the full metadata; the transform (the
                # journal's delta filter) shapes what is committed.
                self._metadata = self._finalizer.build_global(self._storage)
                committed_md = self._metadata
                if self._manifest_transform is not None:
                    committed_md = self._manifest_transform(self._metadata)
                Snapshot._write_snapshot_metadata(committed_md, self._storage)
                self._finalizer.cleanup_sidecars(self._storage)
            if barrier is not None:
                barrier.depart(timeout_s=barrier_timeout_s)
            # Committed: this rank's telemetry sidecar, still on this thread
            # (storage only, no collectives).
            _write_sidecar(
                self._storage,
                "async_take",
                self._unique_id,
                self.pg,
                time.monotonic() - self._begin,
                self._phases_before,
                self._rss,
                nbytes=self._bytes_total,
                committed_md=committed_md,
                extra={"staging_mode": self._finalizer.staging_mode, "stall_s": round(self.stall_s, 4)},
            )
            self._storage.sync_close()
            log_event(
                Event(
                    name="async_take.end",
                    metadata=self._end_event_metadata(is_success=True),
                )
            )
        except BaseException as e:  # noqa: BLE001 — surfaced by wait()
            self.exception = e
            if barrier is not None and not isinstance(e, StorePeerError):
                try:
                    barrier.report_error(repr(e))
                except Exception:  # noqa: BLE001 — the take's error is what raises
                    logger.warning("reporting an async take's failure to peers failed", exc_info=True)
            # A peer's StorePeerError lands here too, so rank 0 removes the
            # partial snapshot whichever rank failed first.
            Snapshot._cleanup_failed_take(self._storage, self.pg, action="async_take")
            try:
                self._storage.sync_close()
            except Exception:  # noqa: BLE001 — the take's error is what raises
                logger.warning("closing the storage of a failed async take failed", exc_info=True)
            log_event(
                Event(
                    name="async_take.end",
                    metadata=self._end_event_metadata(is_success=False),
                )
            )
        finally:
            # Terminal either way: stop refreshing the liveness lease.
            release_op_lease(self._lease)
            self._lease = None
            with self._callbacks_lock:
                self._done_event.set()
                callbacks = list(self._done_callbacks)
                self._done_callbacks = []
            for fn in callbacks:
                self._run_done_callback(fn)

    def _end_event_metadata(self, is_success: bool) -> Dict[str, Any]:
        """async_take.end carries the staging telemetry (stall, mode, copied
        bytes, any downgrade), so a stall regression shows in the event
        stream alone."""
        stats = self._finalizer.staging_stats
        metadata: Dict[str, Any] = {
            "unique_id": self._unique_id,
            "rank": self.pg.get_rank(),
            "action": "async_take",
            "is_success": is_success,
            "duration_s": time.monotonic() - self._begin,
            "bytes": self._bytes_total,
            "staging_mode": self._finalizer.staging_mode,
            "stall_s": round(self.stall_s, 4),
            "copy_bytes": stats.get("copy_bytes", 0),
            "copy_s": round(stats.get("copy_s", 0.0), 4),
        }
        if "downgraded_from" in stats:
            metadata["downgraded_from"] = stats["downgraded_from"]
            metadata["downgrade_reason"] = stats["downgrade_reason"]
        cas_stats = cas.writer_stats(self._storage)
        if cas_stats is not None:
            metadata["cas"] = cas_stats
        return metadata

    def wait(self) -> Snapshot:
        """Blocks until the commit; raises the background failure, if any
        (a failure on any rank fails every rank's ``wait``)."""
        self._thread.join()
        if self.exception is not None:
            raise self.exception
        # On the caller's thread, so the process group may be used: the
        # commit barrier's keys are swept at a later pg barrier, once every
        # rank's background thread is through depart (its `done` counter
        # reached the world size).  Retired once: a second guard probe would
        # recreate the swept counter.
        if self._barrier is not None and not self._retired:
            self._retired = True
            guard_key, guard_target = self._barrier.done_guard()
            self.pg.retire_prefix(
                self._barrier.prefix, guard_key=guard_key, guard_target=guard_target
            )
        snapshot = Snapshot(path=self.path, pg=self.pg, storage_options=self._storage_options)
        snapshot._metadata = self._metadata
        return snapshot

    @property
    def staging_mode(self) -> str:
        """How the state was made stable before return: "pinned_host" or
        "device" (copies; D2H drained in the background) or "host" (staged
        to host memory before return)."""
        return self._finalizer.staging_mode

    def done(self) -> bool:
        return self._done_event.is_set()

    def progress(self) -> Dict[str, Any]:
        """Live progress of the take, from any thread.  Without the
        telemetry monitor (not ported yet) it says whether the take is done
        and whether it succeeded."""
        return {
            "action": "async_take",
            "op_id": self._unique_id,
            "rank": self.pg.get_rank(),
            "done": self.done(),
            "success": None if not self.done() else self.exception is None,
        }

    def add_done_callback(self, fn: Callable[["PendingSnapshot"], Any]) -> None:
        """Run ``fn(self)`` once the take commits or fails: on the background
        thread, or at once on the calling thread if already done.  Callback
        exceptions are logged and swallowed."""
        with self._callbacks_lock:
            if not self._done_event.is_set():
                self._done_callbacks.append(fn)
                return
        self._run_done_callback(fn)

    def _run_done_callback(self, fn: Callable[["PendingSnapshot"], Any]) -> None:
        try:
            fn(self)
        except Exception:  # noqa: BLE001 — never masks the take's outcome
            logger.warning("PendingSnapshot done-callback %r failed", fn, exc_info=True)


def _write_sidecar(
    storage: StoragePlugin,
    action: str,
    unique_id: str,
    pg: PGWrapper,
    duration_s: float,
    phases_before: Dict[str, Dict[str, float]],
    rss: RSSWatermark,
    nbytes: int = 0,
    committed_md: Optional[SnapshotMetadata] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """This rank's telemetry sidecar of a committed take or a restore,
    with the CAS writer's stats and the journal summary of a committed
    segment.  Best-effort: a failure is logged at debug and never fails
    the operation (``TPUSNAP_SIDECAR=0`` and deadline mode skip it)."""
    if not tsidecar.enabled():
        return
    try:
        rss.sample()
        doc_extra: Dict[str, Any] = {
            "world_size": pg.get_world_size(),
            **(extra or {}),
            "rss_high_water_bytes": rss.high_water,
        }
        cas_stats = cas.writer_stats(storage)
        if cas_stats is not None:
            # Logical against physical bytes: what dedup saved this rank.
            doc_extra["cas"] = cas_stats
        if committed_md is not None and committed_md.journal is not None:
            doc_extra["journal"] = journal.sidecar_summary(committed_md.journal)
        tsidecar.write(
            storage,
            tsidecar.build(
                action=action,
                unique_id=unique_id,
                rank=pg.get_rank(),
                duration_s=duration_s,
                phases=phase_stats.delta(phases_before),
                nbytes=nbytes,
                extra=doc_extra,
            ),
        )
    except Exception:  # noqa: BLE001 — a sidecar never fails its operation
        logger.debug("telemetry sidecar of %s failed", action, exc_info=True)


def _rank_prefixed(gathered: List[Manifest]) -> Manifest:
    """The global manifest of the ranks' entries: each path under its
    ``<rank>/`` prefix."""
    return {
        f"{rank}/{logical_path}": entry
        for rank, rank_entries in enumerate(gathered)
        for logical_path, entry in rank_entries.items()
    }


def _sub_manifest(manifest: Manifest, key: str) -> Manifest:
    prefix = key + "/"
    return {
        path: entry
        for path, entry in manifest.items()
        if path == key or path.startswith(prefix)
    }


def _is_tensor_entry(entry: Entry) -> bool:
    return isinstance(entry, (TensorEntry, ChunkedTensorEntry, ShardedArrayEntry))


def _resolve_device(device: Device) -> torch.device:
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tensors are placed on 'cuda' by default, but CUDA is not "
            "available; pass device='cpu'"
        )
    return resolved


def _read_entries(
    sub_manifest: Manifest,
    targets: Dict[str, Any],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    device: Optional[torch.device],
) -> Tuple[Dict[str, Any], Manifest]:
    """Read every leaf entry into its target (or onto ``device``); returns
    ({path: value}, container entries).  CUDA uploads have landed on
    return."""
    h2d_batch = H2DBatcher()
    read_reqs: List[ReadReq] = []
    futures: Dict[str, Future] = {}
    container_entries: Manifest = {}
    for path, entry in sub_manifest.items():
        if is_container_entry(entry):
            container_entries[path] = entry
            continue
        entry_read_reqs, fut = io_preparer.prepare_read(
            entry, targets.get(path), h2d_batch=h2d_batch, device=device
        )
        read_reqs += entry_read_reqs
        futures[path] = fut
    try:
        sync_execute_read_reqs(
            read_reqs=batch_read_requests(read_reqs),
            storage=storage,
            memory_budget_bytes=memory_budget_bytes,
            rank=rank,
        )
    finally:
        # Even after a failed read, no copy may still be in flight into a
        # target or out of a pinned buffer when this returns.
        h2d_batch.drain()
    return {path: fut.obj for path, fut in futures.items()}, container_entries


def _read_one(
    entry: Entry,
    obj_out: Optional[Any],
    device: Optional[torch.device],
    storage: StoragePlugin,
    memory_budget_bytes: Optional[int],
    rank: int,
) -> Any:
    if isinstance(entry, PrimitiveEntry):
        return entry.get_value()
    h2d_batch = H2DBatcher()
    read_reqs, fut = io_preparer.prepare_read(
        entry,
        obj_out,
        buffer_size_limit_bytes=memory_budget_bytes,
        h2d_batch=h2d_batch,
        device=device,
    )
    try:
        sync_execute_read_reqs(
            read_reqs=batch_read_requests(read_reqs),
            storage=storage,
            memory_budget_bytes=memory_budget_bytes
            or get_process_memory_budget_bytes(PGWrapper()),
            rank=rank,
        )
    finally:
        h2d_batch.drain()
    return fut.obj


def _accepts_strict(stateful: Stateful) -> bool:
    try:
        params = inspect.signature(stateful.load_state_dict).parameters
    except (TypeError, ValueError):
        return False
    if "strict" in params:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def _gen_unique_id(pg: PGWrapper) -> str:
    """An operation id shared by every rank (rank 0's, broadcast)."""
    obj_list = [uuid.uuid4().hex]
    pg.broadcast_object_list(obj_list, src=0)
    return obj_list[0]
