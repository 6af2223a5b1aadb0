"""SnapshotManager: step-numbered snapshots with retention.

Counterpart of ``torchsnapshot_tpu/manager.py`` on ``fs``, ``s3`` and
``memory`` roots (any backend that lists, through its plugin's
``list_dir``/``delete_dir``), with the same layout, markers, journal and
history files, so either package's manager manages a root the other
wrote: the training-loop layer over the Snapshot primitives —
step-numbered directories under one root, retention of the last N
*committed* snapshots, latest-step discovery, async saves, last-good
fallback on resume, and garbage collection.

Layout: ``<root>/step_<N>`` per snapshot.  A snapshot counts as committed iff
its ``.snapshot_metadata`` exists (the commit protocol's invariant), so
pruning and latest-step discovery never consider torn snapshots.

Journal mode (``journal=True`` / ``TPUSNAP_JOURNAL=1``, journal.py): saves
append delta segments (``<root>/seg_<N>``) carrying only the entries whose
content changed since the last committed base, with payload bytes going
through the content-addressed store; a rank-0 compactor periodically folds
base + segments into a fresh full step.  ``restore_latest``/``restore_at``
replay segments over their base transparently.

Shared store (``store=`` / ``TPUSNAP_STORE`` / the root's ``.store``
pointer, store.py): saves force content addressing on and land chunks
under ``<store>/cas/``; retention and ``gc`` reclaim them through the
store's two-phase sweep.

Not in this package yet: the metrics registry (events are logged as in the
JAX package).
"""

from __future__ import annotations

import bisect
import contextlib
import logging
import os
import re
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple, Union

from . import cas as cas_mod
from . import journal as journal_mod
from . import knobs
from . import retry
from . import store as store_mod
from .event import Event
from .event_handlers import log_event
from .io_types import ReadIO, WriteIO
from .manifest import SnapshotMetadata, manifest_version_for
from .pg_wrapper import PGWrapper
from .snapshot import SNAPSHOT_METADATA_FNAME, PendingSnapshot, Snapshot
from .stateful import AppState
from .storage_plugin import url_to_storage_plugin
from .telemetry import history as thistory
from .telemetry import sidecar as tsidecar

logger = logging.getLogger(__name__)

_STEP_RE = re.compile(r"^step_(\d+)$")
_INFLIGHT_RE = re.compile(r"^\.inflight_(step|seg)_(\d+)\.json$")


def _pid_alive(pid: Optional[int]) -> bool:
    if not isinstance(pid, int) or pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except Exception:
        return True  # EPERM etc.: exists but not ours
    return True


class SnapshotManager:
    def __init__(
        self,
        root: str,
        max_to_keep: Optional[int] = None,
        pg: Optional[PGWrapper] = None,
        journal: Optional[bool] = None,
        store: Optional[str] = None,
    ) -> None:
        """``journal``: delta-journal mode (journal.py) — each save appends
        a segment of only the changed entries, compacted into full steps in
        the background.  ``None`` (default) follows ``TPUSNAP_JOURNAL``.
        Change detection is digest-based, over the native library this
        package requires.

        ``store``: the URL of a shared multi-tenant chunk store (store.py):
        saves force content addressing on and land chunks under
        ``<store>/cas/`` instead of ``<root>/cas/``, deduplicating across
        every root that shares the store.  ``None`` (default) follows
        ``TPUSNAP_STORE``, then the root's durable ``.store`` pointer (a
        root that once joined a store keeps resolving against it)."""
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError("max_to_keep must be >= 1")
        self.root = root.rstrip("/")
        self.max_to_keep = max_to_keep
        self._pg = pg or PGWrapper.from_torch()
        self._journal = journal
        self._store = store.rstrip("/") if store else None
        self._store_resolved = store is not None
        self._store_joined = False
        # Per-save in-flight marker refresher threads (satellite: store-
        # side lease stamps).  Keyed by (step, kind); each rewrites its
        # marker's "stamp" at the lease interval so a reader anywhere can
        # age-test liveness instead of host-local pid probing.
        self._marker_lock = threading.Lock()
        self._marker_threads: Dict[
            Tuple[int, str], Tuple[threading.Event, threading.Thread]
        ] = {}
        # Rank 0's journal bookkeeping (journal.JournalState), loaded
        # lazily from storage and maintained across saves/compactions.
        # _journal_lock serializes state capture (a save snapshotting the
        # chain it will diff against), adoption (folding a committed delta
        # in), and compaction (which rewrites the chain); the save counter
        # defers compaction while ANY journal save is uncommitted — a
        # compaction that deleted segments an in-flight save's chain
        # references would make its commit unreplayable.
        self._journal_state: Optional[journal_mod.JournalState] = None
        self._journal_lock = threading.Lock()
        self._inflight_journal_saves = 0
        # Incrementally-maintained CAS digest index: seeded once (persisted
        # sidecar or manifest scan), then kept in lockstep by takes (the
        # writer adds fresh digests by reference) and sweeps (discard).
        self._digest_index: Optional[cas_mod.DigestIndex] = None
        # CAS chunk reclamation state: pruned steps' chunk references wait
        # here until NO async save of this manager is in flight — an
        # uncommitted take may have dedup-HIT a candidate chunk (not just
        # written fresh ones), and sweeping before its manifest commits
        # would leave it referencing a deleted chunk.
        self._chunk_gc_lock = threading.Lock()
        self._inflight_async_saves = 0
        self._deferred_chunk_candidates: Set[str] = set()

    # ----------------------------------------------------------------- paths

    def path_for_step(self, step: int) -> str:
        return f"{self.root}/step_{step}"

    def _is_committed(self, storage, step: int) -> bool:
        """Metadata-file existence is the commit signal.  A missing file
        means torn/absent; transport/permission errors propagate rather than
        silently classifying a committed snapshot as torn."""
        return storage.sync_exists(f"step_{step}/{SNAPSHOT_METADATA_FNAME}")

    def all_steps(self, storage=None) -> List[int]:
        """Committed steps, ascending, on any listable backend (fs, s3 and
        memory, via each plugin's list_dir).  Pass ``storage`` to reuse an
        open plugin (avoids building a thread pool + sessions per call)."""
        own = storage is None
        if own:
            storage = url_to_storage_plugin(self.root)
        try:
            names = storage.sync_list_dir("")
            steps = []
            for name in names:
                m = _STEP_RE.match(name)
                if m and self._is_committed(storage, int(m.group(1))):
                    steps.append(int(m.group(1)))
            return sorted(steps)
        finally:
            if own:
                storage.sync_close()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ----------------------------------------------------------------- save

    def _resolve_store_url(self) -> Optional[str]:
        """The shared store URL this root saves into, or None: the
        constructor's, else ``TPUSNAP_STORE``, else the root's durable
        ``.store`` pointer.  Resolved once and cached."""
        if not self._store_resolved:
            self._store_resolved = True
            url = knobs.get_store_url()
            if url is None:
                try:
                    storage = url_to_storage_plugin(self.root)
                    try:
                        url = store_mod.read_store_pointer(storage)
                    finally:
                        storage.sync_close()
                except Exception:  # noqa: BLE001 — unreadable: a per-root CAS
                    url = None
            self._store = url.rstrip("/") if url else None
        return self._store

    def _ensure_store_joined(self, store_url: str) -> None:
        """Rank 0, once per manager: durably point the root at its store
        (readers resolve chunks through the pointer with no knob set) and
        register the tenant (what puts this root's manifests into the
        sweep's referenced set).  Best-effort: the take's writer context
        registers again, so a transient failure here costs nothing."""
        if self._store_joined or self._pg.get_rank() != 0:
            return
        self._store_joined = True
        try:
            root_storage = url_to_storage_plugin(self.root)
            try:
                if store_mod.read_store_pointer(root_storage) != store_url:
                    store_mod.write_store_pointer(root_storage, store_url)
            finally:
                root_storage.sync_close()
            store_storage = url_to_storage_plugin(store_url)
            try:
                store_mod.register_tenant(store_storage, self.root)
            finally:
                store_storage.sync_close()
        except Exception:  # noqa: BLE001 — the take's writer context registers
            logger.warning("failed to join shared store %s", store_url, exc_info=True)

    def save(
        self,
        step: int,
        app_state: AppState,
        replicated: Optional[List[str]] = None,
        async_: bool = False,
        incremental: bool = False,
    ) -> Union[Snapshot, PendingSnapshot]:
        """``incremental=True`` deduplicates payloads unchanged since the
        latest committed snapshot instead of rewriting them (hard links on
        fs, server-side copies on S3).  In journal mode the flag
        is moot — content addressing already dedups every unchanged byte."""
        store_url = self._resolve_store_url()
        with contextlib.ExitStack() as pins:
            if store_url is not None:
                # Store mode forces content addressing on (chunks are what
                # the tenants share) and pins the store for the take's
                # write-path wrapping, for this thread only: managers of
                # other roots may save in other threads of the process.
                self._ensure_store_joined(store_url)
                pins.enter_context(knobs.override_in_thread(knobs.STORE_ENV_VAR, store_url))
                pins.enter_context(knobs.override_in_thread(knobs.CAS_ENV_VAR, "1"))
            if self._journal_mode_active():
                return self._save_journal(step, app_state, replicated, async_)
            return self._save_full(step, app_state, replicated, async_, incremental)

    def _journal_mode_active(self) -> bool:
        # No hashless fallback: the native library this package requires
        # hashes every payload, so journal mode never degrades.
        return knobs.journal_enabled() if self._journal is None else self._journal

    def _save_full(
        self,
        step: int,
        app_state: AppState,
        replicated: Optional[List[str]],
        async_: bool,
        incremental: bool,
    ) -> Union[Snapshot, PendingSnapshot]:
        path = self.path_for_step(step)
        base: Optional[str] = None
        if incremental:
            # Dedup is a hard link on fs and a server-side copy on S3; a
            # backend with neither (memory) falls back to full writes
            # inside the wrapper.
            latest = self.latest_step()
            if latest is not None and latest != step:
                base = self.path_for_step(latest)
        cas_index = self._digest_index_for_save()
        self._write_inflight_marker(step, "step")
        if async_:
            # Count the save in flight BEFORE pruning enqueues candidates,
            # so the enqueue can never sweep under this (or any sibling)
            # uncommitted take.
            with self._chunk_gc_lock:
                self._inflight_async_saves += 1
            try:
                pending = Snapshot.async_take(
                    path,
                    app_state,
                    pg=self._pg,
                    replicated=replicated,
                    incremental_from=base,
                    cas_index=cas_index,
                )
            except BaseException:
                with self._chunk_gc_lock:
                    self._inflight_async_saves -= 1
                self._remove_inflight_marker(step, "step")
                raise
            # The in-flight snapshot must not count toward retention: if it
            # never commits, the previously committed ones are still the
            # only restore points — deleting them now could leave zero.
            # Chunk reclamation is DEFERRED: pruned steps' chunk references
            # are computed now (before deletion) but only swept once every
            # async save of this manager has completed — an uncommitted
            # take may have deduplicated against a chunk whose only
            # committed referent was pruned right here.
            candidates = self._maybe_prune(
                exclude_step=step, include_current=False
            )
            if candidates:
                self._enqueue_chunk_candidates(candidates)

            # Step history is appended only once the snapshot COMMITS —
            # the done-callback runs on the completion thread (storage
            # ops only, no collectives) and a failed save records nothing.
            def _on_done(p) -> None:
                if p.exception is None:
                    self._record_history(step, action="async_take")
                    if cas_index is not None:
                        self._persist_digest_index()
                self._remove_inflight_marker(step, "step")
                with self._chunk_gc_lock:
                    self._inflight_async_saves -= 1
                self._maybe_sweep_deferred_chunks()

            pending.add_done_callback(_on_done)
            return pending
        try:
            snapshot = Snapshot.take(
                path,
                app_state,
                pg=self._pg,
                replicated=replicated,
                incremental_from=base,
                cas_index=cas_index,
            )
        finally:
            self._remove_inflight_marker(step, "step")
        self._record_history(step, action="take")
        if cas_index is not None:
            self._persist_digest_index()
        candidates = self._maybe_prune(exclude_step=step, include_current=True)
        if candidates:
            self._enqueue_chunk_candidates(candidates)
        return snapshot

    # -------------------------------------------------------------- journal

    def _journal_state_loaded(self, storage=None) -> journal_mod.JournalState:
        """Rank 0's journal bookkeeping, (re)built from storage on first
        use: newest committed full step + the committed segments chained on
        it, merged into the comparison view delta computation diffs
        against."""
        if self._journal_state is None:
            own = storage is None
            if own:
                storage = url_to_storage_plugin(self.root)
            try:
                self._journal_state = journal_mod.load_state(
                    storage, self.all_steps(storage=storage)
                )
            finally:
                if own:
                    storage.sync_close()
        return self._journal_state

    def _save_journal(
        self,
        step: int,
        app_state: AppState,
        replicated: Optional[List[str]],
        async_: bool,
    ) -> Union[Snapshot, PendingSnapshot]:
        """Journal-mode save: the first save (no committed base) writes a
        normal full step; every later save appends a delta segment.  Both
        run with content addressing forced on — CAS chunk sharing is what
        makes segments cheap and compaction byte-free."""
        rank0 = self._pg.get_rank() == 0
        decision = [None]
        if rank0:
            with self._journal_lock:
                state = self._journal_state_loaded()
                decision[0] = "step" if state.base_step is None else "seg"
        if self._pg.get_world_size() > 1:
            # Ranks must agree on the target path (base step dir vs segment
            # dir); rank 0 decides from committed storage state.
            self._pg.broadcast_object_list(decision, src=0)
        kind = decision[0]
        with knobs.override_cas(True):
            cas_index = self._digest_index_for_save()
            if kind == "step":
                return self._save_journal_base(
                    step, app_state, replicated, async_, cas_index
                )
            return self._save_journal_segment(
                step, app_state, replicated, async_, cas_index
            )

    def _journal_begin_save(self) -> None:
        with self._journal_lock:
            self._inflight_journal_saves += 1

    def _journal_end_save(self) -> None:
        with self._journal_lock:
            self._inflight_journal_saves -= 1

    def _save_journal_base(
        self, step, app_state, replicated, async_, cas_index
    ) -> Union[Snapshot, PendingSnapshot]:
        path = self.path_for_step(step)
        self._write_inflight_marker(step, "step")
        self._journal_begin_save()

        def _adopt_base(metadata) -> None:
            # Rank 0, post-commit: the full manifest IS the new view.
            with self._journal_lock:
                st = self._journal_state
                if st is None or metadata is None:
                    return
                st.base_step = step
                st.segments = []
                st.delta_bytes = 0
                st.view = journal_mod.view_of(metadata.manifest)
                st.world_size = metadata.world_size
            self._persist_digest_index()

        if async_:
            with self._chunk_gc_lock:
                self._inflight_async_saves += 1
            try:
                pending = Snapshot.async_take(
                    path,
                    app_state,
                    pg=self._pg,
                    replicated=replicated,
                    cas_index=cas_index,
                )
            except BaseException:
                with self._chunk_gc_lock:
                    self._inflight_async_saves -= 1
                self._journal_end_save()
                self._remove_inflight_marker(step, "step")
                raise
            candidates = self._maybe_prune(
                exclude_step=step,
                include_current=False,
                protect=self._journal_protected_steps(),
            )
            if candidates:
                self._enqueue_chunk_candidates(candidates)

            def _on_done(p) -> None:
                if p.exception is None:
                    if self._pg.get_rank() == 0:
                        _adopt_base(p._metadata)
                    self._record_history(step, action="async_take")
                self._remove_inflight_marker(step, "step")
                self._journal_end_save()
                with self._chunk_gc_lock:
                    self._inflight_async_saves -= 1
                self._maybe_sweep_deferred_chunks()

            pending.add_done_callback(_on_done)
            return pending
        committed = False
        try:
            snapshot = Snapshot.take(
                path,
                app_state,
                pg=self._pg,
                replicated=replicated,
                cas_index=cas_index,
            )
            committed = True
        finally:
            self._remove_inflight_marker(step, "step")
            if not committed:
                self._journal_end_save()
        if self._pg.get_rank() == 0:
            _adopt_base(snapshot._metadata)
        self._record_history(step, action="take")
        self._journal_end_save()
        candidates = self._maybe_prune(
            exclude_step=step,
            include_current=True,
            protect=self._journal_protected_steps(),
        )
        if candidates:
            self._enqueue_chunk_candidates(candidates)
        return snapshot

    def _save_journal_segment(
        self, step, app_state, replicated, async_, cas_index
    ) -> Union[Snapshot, PendingSnapshot]:
        path = journal_mod.segment_path(self.root, step)
        holder: Dict[str, Any] = {}
        transform = None
        self._journal_begin_save()
        if self._pg.get_rank() == 0:
            with self._journal_lock:
                st = self._journal_state_loaded()
                # Captured under the lock so compaction can never rewrite
                # the chain between the capture and the take's commit (the
                # save counter above defers it); never mutated — adoption
                # below REPLACES st.view, so the closure's prior view stays
                # coherent even for overlapping async saves (their deltas
                # are then computed against a common ancestor view, which
                # replay tolerates: later overlays carry every change
                # since it).
                prior_view = st.view
                base_step = st.base_step
                prior_segments = list(st.segments)

            def transform(metadata):
                delta_md = journal_mod.compute_delta(
                    metadata, prior_view, base_step, prior_segments
                )
                holder["delta"] = delta_md
                holder["view"] = journal_mod.view_of(metadata.manifest)
                holder["world_size"] = metadata.world_size
                return delta_md

        def _adopt_segment() -> None:
            # Rank 0, post-commit: fold the committed delta into the
            # in-memory state and account it.  Compaction runs separately,
            # once no journal save is in flight.  Overlapping async saves
            # may commit out of step order: the view stays the newest
            # step's and the segments stay sorted, so the fold lands on
            # the newest segment.
            with self._journal_lock:
                st = self._journal_state
                if st is None or "delta" not in holder:
                    return
                info = holder["delta"].journal
                if not st.segments or step > st.segments[-1]:
                    st.view = holder["view"]
                    st.world_size = holder["world_size"]
                bisect.insort(st.segments, step)
                st.delta_bytes += int(info.get("delta_bytes", 0))
            log_event(
                Event(
                    name="journal.commit",
                    metadata={
                        "step": step,
                        "root": self.root,
                        **journal_mod.sidecar_summary(info),
                    },
                )
            )
            self._persist_digest_index()

        self._write_inflight_marker(step, "seg")
        if async_:
            with self._chunk_gc_lock:
                self._inflight_async_saves += 1
            try:
                pending = Snapshot.async_take(
                    path,
                    app_state,
                    pg=self._pg,
                    replicated=replicated,
                    cas_index=cas_index,
                    manifest_transform=transform,
                )
            except BaseException:
                with self._chunk_gc_lock:
                    self._inflight_async_saves -= 1
                self._journal_end_save()
                self._remove_inflight_marker(step, "seg")
                raise
            candidates = self._maybe_prune(
                exclude_step=step,
                include_current=False,
                protect=self._journal_protected_steps(),
            )
            if candidates:
                self._enqueue_chunk_candidates(candidates)

            def _on_done(p) -> None:
                if p.exception is None:
                    if self._pg.get_rank() == 0:
                        _adopt_segment()
                    # History reads the segment's sidecars, so it must run
                    # BEFORE any compaction can remove the directory.
                    self._record_history(
                        step, action="async_take", path=path
                    )
                self._remove_inflight_marker(step, "seg")
                self._journal_end_save()
                with self._chunk_gc_lock:
                    self._inflight_async_saves -= 1
                self._maybe_sweep_deferred_chunks()
                self._maybe_compact_journal()

            pending.add_done_callback(_on_done)
            return pending
        committed = False
        try:
            snapshot = Snapshot.take(
                path,
                app_state,
                pg=self._pg,
                replicated=replicated,
                cas_index=cas_index,
                manifest_transform=transform,
            )
            committed = True
        finally:
            self._remove_inflight_marker(step, "seg")
            if not committed:
                self._journal_end_save()
        if self._pg.get_rank() == 0:
            _adopt_segment()
        # Before the compaction check: history reads this segment's
        # sidecars, which a compaction triggered by this very commit
        # would delete along with the directory.
        self._record_history(step, action="take", path=path)
        self._journal_end_save()
        self._maybe_compact_journal()
        candidates = self._maybe_prune(
            exclude_step=step,
            include_current=True,
            protect=self._journal_protected_steps(),
        )
        if candidates:
            self._enqueue_chunk_candidates(candidates)
        return snapshot

    def _journal_protected_steps(self) -> Set[int]:
        """Full steps retention must never prune while journal segments
        chain off them.  The live chain's base is always the newest full
        step, which retention keeps anyway (max_to_keep >= 1) — this set
        guards the stale-state edge cases (crashed compaction, state
        reloaded mid-history) explicitly."""
        with self._journal_lock:
            st = self._journal_state
            if st is None or st.base_step is None:
                return set()
            return {st.base_step}

    def _maybe_compact_journal(self) -> None:
        """Fold base + committed segments into a fresh full step once the
        count/byte knobs trip.  Rank 0, storage-only (safe on the async
        done-callback thread — no collectives, no CUDA tensor).  Pure metadata work: every
        payload is already a durable CAS chunk, so the folded step is the
        merged manifest committed durably at ``step_<newest segment>`` —
        and a crash at ANY point here leaves base and segments intact, so
        the next committed save simply re-runs the fold.

        Runs only while NO journal save of this manager is in flight
        (overlapping async saves captured the pre-fold chain; deleting its
        segments would commit them unreplayable) — a deferred fold
        re-triggers when the last in-flight save completes."""
        with self._journal_lock:
            st = self._journal_state
            if st is None or not st.segments:
                return
            if self._inflight_journal_saves > 0:
                return  # re-checked by the save that finishes last
            max_segments = knobs.get_journal_max_segments()
            max_bytes = knobs.get_journal_max_bytes()
            if len(st.segments) < max_segments and not (
                max_bytes and st.delta_bytes >= max_bytes
            ):
                return
            candidates = self._compact_journal_locked(st)
        if candidates:
            self._enqueue_chunk_candidates(candidates)

    def _compact_journal_locked(self, st) -> Optional[Set[str]]:
        target = st.segments[-1]
        removed = list(st.segments)
        try:
            storage = url_to_storage_plugin(self.root)
            try:
                manifest = journal_mod.manifest_of(st.view)
                metadata = SnapshotMetadata(
                    version=manifest_version_for(manifest),
                    world_size=st.world_size,
                    manifest=manifest,
                )
                payload = metadata.to_json().encode("utf-8")
                # The commit point: once this durable write lands, step_N
                # is a committed full snapshot and the segments are
                # redundant; until it lands, nothing changed.
                retry.call_with_retries(
                    lambda: storage.sync_write(
                        WriteIO(
                            path=f"step_{target}/{SNAPSHOT_METADATA_FNAME}",
                            buf=payload,
                            durable=True,
                        )
                    ),
                    stage="commit",
                )
                # Reclamation candidates BEFORE the segment dirs go: chunks
                # only the folded-away intermediate versions referenced.
                candidates: Set[str] = set()
                for seg in removed:
                    try:
                        candidates |= (
                            journal_mod.referenced_chunk_relpaths_of_segment(
                                storage, seg
                            )
                        )
                    except Exception:
                        logger.warning(
                            "compaction: could not scan seg_%d for chunk "
                            "refs; its chunks stay until gc",
                            seg,
                            exc_info=True,
                        )
                for seg in removed:
                    try:
                        storage.sync_delete_dir(
                            journal_mod.segment_dirname(seg)
                        )
                    except Exception:
                        logger.warning(
                            "compaction: could not remove folded seg_%d "
                            "(subsumed by step_%d; gc will sweep it)",
                            seg,
                            target,
                            exc_info=True,
                        )
                st.base_step = target
                st.segments = []
                st.delta_bytes = 0
                log_event(
                    Event(
                        name="journal.compaction",
                        metadata={
                            "root": self.root,
                            "step": target,
                            "folded_segments": len(removed),
                        },
                    )
                )
                logger.info(
                    "journal: compacted %d segment(s) into full step_%d",
                    len(removed),
                    target,
                )
                self._persist_digest_index(storage)
            finally:
                storage.sync_close()
        except Exception:
            logger.warning(
                "journal compaction failed; base and segments are intact "
                "and the next committed save re-runs it",
                exc_info=True,
            )
            return None
        return candidates

    # --------------------------------------------------------- digest index

    def _digest_index_for_save(self) -> Optional[cas_mod.DigestIndex]:
        """The manager's incrementally-maintained digest index, created on
        first CAS-mode save (persisted sidecar when fresh, manifest scan
        otherwise) and threaded through every take — the take's CAS writer
        adds fresh digests to it by reference, so later saves pay ZERO
        seeding reads.  None when content addressing is off."""
        if not knobs.cas_enabled():
            return None
        if self._digest_index is None:
            storage = url_to_storage_plugin(self.root)
            try:
                self._digest_index = cas_mod.load_or_seed_index(
                    self.root, storage, knobs.get_cas_algo()
                )
            except Exception:
                logger.warning(
                    "digest index load failed; takes fall back to "
                    "per-take seeding",
                    exc_info=True,
                )
                return None
            finally:
                storage.sync_close()
        return self._digest_index

    def _persist_digest_index(self, storage=None) -> None:
        """Write the root's index sidecar (rank 0, best-effort) so the NEXT
        process skips the manifest scan.  Called on commit, prune-sweep,
        gc, and compaction — every point the committed-marker set or the
        digest set changes."""
        if self._digest_index is None or self._pg.get_rank() != 0:
            return
        try:
            own = storage is None
            if own:
                storage = url_to_storage_plugin(self.root)
            try:
                cas_mod.persist_index_sidecar(
                    storage, self._digest_index, knobs.get_cas_algo()
                )
            finally:
                if own:
                    storage.sync_close()
        except Exception:
            logger.debug(
                "digest index sidecar write failed (cache only)",
                exc_info=True,
            )

    def _sync_index_after_sweep(self, storage, swept_relpaths) -> None:
        """Keep the digest index — in-memory AND persisted — in lockstep
        with swept chunks: a deleted chunk's digest must not dedup-HIT a
        later write.  When this manager never built an index (a gc-only
        process), the persisted sidecar would keep listing the swept
        digests while the committed-marker set it validates against is
        unchanged — so it must be DROPPED, not left to validate."""
        if not swept_relpaths:
            return
        if self._digest_index is None:
            cas_mod.drop_index_sidecar(storage)
            return
        for relpath in swept_relpaths:
            key = cas_mod.key_for_relpath(relpath)
            if key is not None:
                self._digest_index.discard(key)
        self._persist_digest_index(storage)

    # ------------------------------------------------------ in-flight guard

    def _inflight_marker_name(self, step: int, kind: str) -> str:
        return f".inflight_{kind}_{step}.json"

    def _write_inflight_marker(self, step: int, kind: str) -> None:
        """Advisory in-flight marker for the gc/prune guard.  Rank 0,
        best-effort on BOTH ends: a save must never fail (or fault-retry)
        over its marker, so failures are swallowed — a missing marker just
        means no guard for that save.

        The marker carries a ``stamp`` a refresher thread rewrites at the
        lease interval while the save runs — store-side liveness a reader
        on ANY host can age-test.  The legacy pid/host fields stay for
        same-host fast-path classification and stamp-less back-compat."""
        if self._pg.get_rank() != 0:
            return
        import json

        name = self._inflight_marker_name(step, kind)
        doc = {
            "step": step,
            "kind": kind,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "started": time.time(),
            "stamp": time.time(),
        }

        def _write_once() -> None:
            storage = url_to_storage_plugin(self.root)
            try:
                doc["stamp"] = time.time()
                storage.sync_write(
                    WriteIO(path=name, buf=json.dumps(doc).encode("utf-8"))
                )
            finally:
                storage.sync_close()

        try:
            _write_once()
        except Exception:
            logger.debug("in-flight marker write failed", exc_info=True)
            return
        stop = threading.Event()

        def _refresh_loop() -> None:
            interval = max(0.05, knobs.get_lease_interval_s())
            while not stop.wait(interval):
                try:
                    _write_once()
                except Exception:
                    logger.debug(
                        "in-flight marker refresh failed", exc_info=True
                    )

        thread = threading.Thread(
            target=_refresh_loop,
            daemon=True,
            name=f"snap_inflight_{kind}_{step}",
        )
        with self._marker_lock:
            self._marker_threads[(step, kind)] = (stop, thread)
        thread.start()

    def _remove_inflight_marker(self, step: int, kind: str) -> None:
        if self._pg.get_rank() != 0:
            return
        with self._marker_lock:
            entry = self._marker_threads.pop((step, kind), None)
        if entry is not None:
            stop, thread = entry
            stop.set()
            thread.join(timeout=5.0)
        try:
            storage = url_to_storage_plugin(self.root)
            try:
                storage.sync_delete(self._inflight_marker_name(step, kind))
            except FileNotFoundError:
                pass
            finally:
                storage.sync_close()
        except Exception:
            logger.debug("in-flight marker removal failed", exc_info=True)

    def inflight_markers(self, storage=None) -> List[Dict[str, Any]]:
        """Advisory in-flight save markers present under the root, each as
        ``{"name", "step", "kind", ...marker doc}``.  A marker whose save
        crashed may linger; the gc guard classifies those stale when the
        target committed or the recorded pid is dead on this host."""
        import json

        own = storage is None
        if own:
            storage = url_to_storage_plugin(self.root)
        try:
            out = []
            try:
                names = storage.sync_list_dir("")
            except (NotImplementedError, FileNotFoundError):
                return []
            for name in sorted(names):
                m = _INFLIGHT_RE.match(name)
                if not m:
                    continue
                doc: Dict[str, Any] = {
                    "name": name,
                    "kind": m.group(1),
                    "step": int(m.group(2)),
                }
                try:
                    read_io = ReadIO(path=name)
                    storage.sync_read(read_io)
                    doc.update(json.loads(bytes(read_io.buf).decode("utf-8")))
                except Exception:
                    pass
                out.append(doc)
            return out
        finally:
            if own:
                storage.sync_close()

    def _marker_stale(self, storage, doc: Dict[str, Any]) -> bool:
        """Whether an in-flight marker provably belongs to no live save.
        Primary signal (cross-host correct): the refreshed ``stamp`` —
        expired means the writer stopped refreshing, wherever it ran, and
        pid-number recycling can't fake liveness.  Fast paths: the target
        committed, or the recorded pid is dead on THIS host (a dead pid
        cannot be mid-save, no need to wait out the grace).  Markers
        without a stamp (pre-stamp writers) keep only the legacy
        heuristics — a remote one stays live forever, which is exactly
        the conservatism ``force`` exists for."""
        dirname = (
            f"step_{doc['step']}"
            if doc["kind"] == "step"
            else journal_mod.segment_dirname(doc["step"])
        )
        try:
            if storage.sync_exists(f"{dirname}/{SNAPSHOT_METADATA_FNAME}"):
                return True
        except Exception:
            pass
        if doc.get("host") == socket.gethostname() and not _pid_alive(
            doc.get("pid")
        ):
            return True
        stamp = doc.get("stamp")
        if isinstance(stamp, (int, float)):
            return time.time() - float(stamp) > store_mod._liveness_grace()
        return False

    def _enforce_inflight_guard(self, storage, force: bool) -> None:
        """The gc-side half of the advisory lock: refuse destructive GC
        while a marker plausibly belongs to a live save.  Stale markers —
        target committed, refresher stamp expired, or pid provably dead
        on this host — are cleaned and ignored; anything else raises
        unless ``force``."""
        blocking: List[str] = []
        for doc in self.inflight_markers(storage=storage):
            if self._marker_stale(storage, doc):
                try:
                    storage.sync_delete(doc["name"])
                except Exception:
                    pass
                continue
            blocking.append(doc["name"])
        if not blocking:
            return
        if not force:
            raise RuntimeError(
                f"gc refused: in-flight save marker(s) {blocking} under "
                f"{self.root} — a take may be uncommitted.  Re-run with "
                "force=True only if you are certain no save is "
                "running."
            )
        logger.warning(
            "gc(force=True): overriding in-flight save marker(s) %s", blocking
        )
        for name in blocking:
            try:
                storage.sync_delete(name)
            except Exception:
                pass

    def _record_history(
        self, step: int, action: str, path: Optional[str] = None
    ) -> None:
        """Append the committed save's sidecar summary to the root's
        ``telemetry/history.jsonl`` (telemetry/history.py), running
        trailing-median regression detection.  Rank 0 only (the history
        file is shared), best-effort (a read-only root logs and moves
        on), and a no-op when sidecars are disabled — they are the data
        source.  ``path`` overrides the sidecar directory (journal
        segments live at ``seg_<N>``, not ``step_<N>``)."""
        if self._pg.get_rank() != 0 or not tsidecar.enabled():
            return
        try:
            snap_storage = url_to_storage_plugin(
                path or self.path_for_step(step)
            )
            try:
                docs = tsidecar.read_all(snap_storage)
            finally:
                snap_storage.sync_close()
            docs = [
                d
                for d in docs
                if d.get("action") == action and d.get("rank", 1) == 0
            ]
            if not docs:
                return
            # read_all sorts newest-first; docs[0] is this save's sidecar.
            entry = thistory.summarize_sidecar(docs[0], step=step)
            root_storage = url_to_storage_plugin(self.root)
            try:
                thistory.append(root_storage, entry)
            finally:
                root_storage.sync_close()
        except Exception:
            logger.warning(
                "failed to record step history for step_%d", step,
                exc_info=True,
            )

    # -------------------------------------------------------------- restore

    def restore_points(self) -> List[Tuple[int, str]]:
        """Every committed restore point under the root, ascending:
        ``(step, "full")`` for full snapshots, ``(step, "seg")`` for
        journal delta segments (restorable via replay).  At equal step
        numbers the full snapshot sorts newer — it IS the segment, folded."""
        storage = url_to_storage_plugin(self.root)
        try:
            full = self.all_steps(storage=storage)
            segments = journal_mod.committed_segments(storage)
        finally:
            storage.sync_close()
        points = [(s, "full") for s in full] + [(s, "seg") for s in segments]
        # Ascending; at a tie the full snapshot sorts LAST (newer), so the
        # newest-first restore walk prefers it over the stale segment it
        # subsumed.
        points.sort(key=lambda p: (p[0], p[1] == "full"))
        return points

    def _restore_segment(self, step: int, app_state: AppState) -> None:
        """Journal replay: resolve the segment's chain (base + prior
        segments + itself) into one merged manifest — every entry at its
        newest committed version — and restore through the normal path.
        Raises ``journal.JournalReplayError`` when a chain piece is
        missing/corrupt; ``restore_latest`` treats that like any other bad
        restore point and falls back."""
        storage = url_to_storage_plugin(self.root)
        try:
            merged, _ = journal_mod.merged_metadata(storage, step)
        finally:
            storage.sync_close()
        snapshot = Snapshot(
            journal_mod.segment_path(self.root, step), pg=self._pg
        )
        snapshot._metadata = merged
        snapshot.restore(app_state)

    def restore_point_times(
        self,
    ) -> List[Tuple[int, str, Optional[float]]]:
        """:meth:`restore_points` plus each point's committed-at timestamp
        (unix epoch).  Primary source is the root's step-history log —
        ONE read covers every point, and a compaction-folded full step
        keeps the timestamp its folded segment recorded under the same
        step number (the fold is pure metadata with no take of its own).
        Points absent from history fall back to their own take/async_take
        telemetry sidecar; None when neither exists (taken with
        ``TPUSNAP_SIDECAR=0``)."""
        # step → newest committed-at ts, one history read for the root.
        history_ts: Dict[int, float] = {}
        try:
            storage = url_to_storage_plugin(self.root)
            try:
                for entry in thistory.read(storage):
                    step = entry.get("step")
                    raw = entry.get("timestamp")
                    if isinstance(step, int) and isinstance(
                        raw, (int, float)
                    ):
                        history_ts[step] = float(raw)  # later entries win
            finally:
                storage.sync_close()
        except Exception:
            pass
        out: List[Tuple[int, str, Optional[float]]] = []
        for step, kind in self.restore_points():
            ts: Optional[float] = history_ts.get(step)
            if ts is None:
                path = (
                    self.path_for_step(step)
                    if kind == "full"
                    else journal_mod.segment_path(self.root, step)
                )
                try:
                    snap_storage = url_to_storage_plugin(path)
                    try:
                        docs = tsidecar.read_all(snap_storage)  # newest-first
                    finally:
                        snap_storage.sync_close()
                    for doc in docs:
                        if doc.get("action") in ("take", "async_take") and (
                            doc.get("rank", 1) == 0
                        ):
                            raw = doc.get("timestamp")
                            if isinstance(raw, (int, float)):
                                ts = float(raw)
                            break
                except Exception:
                    pass
            out.append((step, kind, ts))
        return out

    def step_as_of(self, as_of: float) -> int:
        """The newest restore point committed at or before ``as_of`` (unix
        epoch) — the point-in-time selector ``restore_as_of`` resolves
        through.  Points
        without a timestamp (no sidecar) are skipped; raises ValueError
        when nothing qualifies."""
        dated = [
            (step, kind, ts)
            for step, kind, ts in self.restore_point_times()
            if ts is not None
        ]
        if not dated:
            raise ValueError(
                f"no restore point under {self.root} carries a commit "
                "timestamp (telemetry sidecars absent — taken with "
                "TPUSNAP_SIDECAR=0?); point-in-time selection needs them"
            )
        eligible = [p for p in dated if p[2] <= as_of]
        if not eligible:
            raise ValueError(
                f"no restore point under {self.root} existed at {as_of} "
                f"(oldest dated point committed at {dated[0][2]})"
            )
        return eligible[-1][0]

    def restore_as_of(self, as_of: float, app_state: AppState) -> int:
        """Restore the snapshot "as of" a wall-clock instant: the newest
        restore point committed at or before ``as_of``.  ROADMAP item 4's
        point-in-time selector; same no-fallback contract as
        :meth:`restore_at` — the caller asked for a specific instant."""
        return self.restore_at(self.step_as_of(as_of), app_state)

    def restore_latest(self, app_state: AppState) -> Optional[int]:
        """Restore the newest committed restore point that actually loads
        — full snapshot or journal segment (replayed over its base) —
        returning its step or None (the standard resume-if-possible idiom).

        Last-good fallback: a committed-looking restore point can still be
        unloadable — a torn/bit-rotted manifest, a payload whose checksum
        audit fails mid-restore, an unreadable object, a journal segment
        whose replay chain lost a piece.  Each such failure is logged
        loudly with a ``restore_latest.fallback`` event (plus
        ``journal.fallback`` when the skipped point was a segment), and
        the previous point is tried, so a resume lands on
        the newest GOOD restore point instead of dying on a bad one.
        TRANSIENT storage errors (``retry.is_transient``) re-raise instead
        of falling back — a 5xx burst says nothing about the snapshot's
        integrity, and silently resuming from stale weights would be worse
        than failing the resume.  Only when every point fails terminally
        does the first (newest) error propagate.  Multi-rank caveat:
        restore is collective — ranks must fail identically (shared
        storage) for the fallback to stay coherent; per-rank divergent
        corruption surfaces as a collective error instead."""
        points = self.restore_points()
        first_error: Optional[BaseException] = None
        for fallbacks, (step, kind) in enumerate(reversed(points)):
            label = ("step_" if kind == "full" else "seg_") + str(step)
            try:
                if kind == "full":
                    Snapshot(self.path_for_step(step), pg=self._pg).restore(
                        app_state
                    )
                else:
                    self._restore_segment(step, app_state)
            except Exception as e:  # noqa: BLE001
                if retry.is_transient(e):
                    # A transient storage blip (5xx burst, NFS hiccup) says
                    # nothing about THIS snapshot's integrity: falling back
                    # would silently resume from stale weights.  Surface it
                    # — the caller retries the resume; fallback is reserved
                    # for integrity-class failures (torn manifest,
                    # ChecksumError, unreadable payload, broken replay
                    # chain).
                    raise
                if first_error is None:
                    first_error = e
                if kind == "seg":
                    log_event(
                        Event(
                            name="journal.fallback",
                            metadata={
                                "step": step,
                                "rank": self._pg.get_rank(),
                                "error": repr(e),
                            },
                        )
                    )
                log_event(
                    Event(
                        name="restore_latest.fallback",
                        metadata={
                            "step": step,
                            "kind": kind,
                            "rank": self._pg.get_rank(),
                            "error": repr(e),
                        },
                    )
                )
                logger.warning(
                    "restore of committed %s failed (%r); falling back to "
                    "the previous committed restore point",
                    label,
                    e,
                )
                continue
            if fallbacks:
                logger.warning(
                    "restore_latest landed on %s after skipping %d newer "
                    "committed restore point(s)",
                    label,
                    fallbacks,
                )
            return step
        if first_error is not None:
            raise RuntimeError(
                f"restore_latest: all {len(points)} committed restore "
                f"points under {self.root} failed to restore"
            ) from first_error
        return None

    def restore_at(self, step: int, app_state: AppState) -> int:
        """Restore a SPECIFIC step — a committed full snapshot, or a
        journal segment replayed over its base.  No fallback: the caller
        asked for this step, so any failure (including a broken replay
        chain) propagates.  Returns the step for symmetry with
        ``restore_latest``."""
        kind = None
        for s, k in self.restore_points():
            if s == step:
                # A full snapshot at the step wins over a stale segment of
                # the same number (it IS that segment, folded).
                kind = "full" if "full" in (kind, k) else k
        if kind is None:
            raise ValueError(
                f"step {step} has no committed snapshot or journal segment "
                f"under {self.root}"
            )
        if kind == "full":
            Snapshot(self.path_for_step(step), pg=self._pg).restore(app_state)
        else:
            self._restore_segment(step, app_state)
        return step

    def snapshot(self, step: int) -> Snapshot:
        return Snapshot(self.path_for_step(step), pg=self._pg)

    # ------------------------------------------------------------------- gc

    def orphan_steps(self, storage=None) -> List[int]:
        """Step directories present but UNcommitted (no
        ``.snapshot_metadata``) — a crashed take whose cleanup never ran,
        or an async save still in flight.  Ascending."""
        own = storage is None
        if own:
            storage = url_to_storage_plugin(self.root)
        try:
            orphans = []
            for name in storage.sync_list_dir(""):
                m = _STEP_RE.match(name)
                if m and not self._is_committed(storage, int(m.group(1))):
                    orphans.append(int(m.group(1)))
            return sorted(orphans)
        finally:
            if own:
                storage.sync_close()

    def orphan_segments(self, storage=None) -> List[int]:
        """Journal segment directories present but UNcommitted — a crashed
        segment take, or an async segment save still in flight."""
        own = storage is None
        if own:
            storage = url_to_storage_plugin(self.root)
        try:
            return journal_mod.orphan_segments(storage)
        finally:
            if own:
                storage.sync_close()

    def stale_segments(self, storage=None) -> List[int]:
        """COMMITTED journal segments at or below the newest committed full
        step — folded away by a compaction whose segment sweep crashed.
        Redundant by construction (the full step IS their merged state);
        ``gc`` removes them."""
        own = storage is None
        if own:
            storage = url_to_storage_plugin(self.root)
        try:
            steps = self.all_steps(storage=storage)
            if not steps:
                return []
            newest = steps[-1]
            return [
                s
                for s in journal_mod.committed_segments(storage)
                if s <= newest
            ]
        finally:
            if own:
                storage.sync_close()

    def gc(self, apply: bool = True, force: bool = False) -> List[int]:
        """Remove uncommitted (orphaned) step AND journal segment
        directories, sweep stale (compaction-subsumed) segments, and sweep
        orphan CAS chunks (chunks no committed manifest references —
        debris of crashed CAS-mode takes or interrupted prunes); returns
        the steps removed (or, with ``apply=False``, the steps that WOULD
        be).  Use :meth:`gc_detail` for the chunk/segment lists.

        In-flight guard: an async save that hasn't committed yet is
        indistinguishable from a crashed one, so applying GC while one of
        this root's advisory in-flight markers looks live RAISES; pass
        ``force=True`` only when certain no save is
        running.  Markers whose target committed, or whose recorded pid is
        dead on this host, are classified stale and cleaned silently."""
        return self.gc_detail(apply=apply, force=force)[0]

    def gc_detail(
        self, apply: bool = True, force: bool = False
    ) -> Tuple[List[int], List[str], List[int]]:
        """:meth:`gc` plus the orphan chunk relpaths and the journal
        segments swept (or, dry-run, that WOULD be) — one scan of the
        root, not one per report line."""
        if not apply:
            storage = url_to_storage_plugin(self.root)
            try:
                orphans = self.orphan_steps(storage=storage)
                orphan_segs = self.orphan_segments(
                    storage=storage
                ) + self.stale_segments(storage=storage)
                try:
                    chunks = self.orphan_chunks(storage=storage)
                except Exception:
                    logger.warning(
                        "chunk classification failed; reporting steps only",
                        exc_info=True,
                    )
                    chunks = []
            finally:
                storage.sync_close()
            chunks = chunks + self._store_sweep(apply=False, force=force)
            return orphans, chunks, sorted(orphan_segs)
        storage = url_to_storage_plugin(self.root)
        try:
            orphans = self.orphan_steps(storage=storage)
            self._enforce_inflight_guard(storage, force=force)
            for step in orphans:
                logger.warning(
                    "GC: removing uncommitted snapshot step_%d", step
                )
                storage.sync_delete_dir(f"step_{step}")
                log_event(
                    Event(
                        name="gc.orphan_removed",
                        metadata={"step": step, "root": self.root},
                    )
                )
            removed_segs: List[int] = []
            for seg in journal_mod.orphan_segments(storage):
                logger.warning(
                    "GC: removing uncommitted journal segment seg_%d", seg
                )
                storage.sync_delete_dir(journal_mod.segment_dirname(seg))
                removed_segs.append(seg)
                log_event(
                    Event(
                        name="gc.segment_removed",
                        metadata={
                            "segment": seg,
                            "root": self.root,
                            "reason": "uncommitted",
                        },
                    )
                )
            for seg in self.stale_segments(storage=storage):
                logger.info(
                    "GC: removing journal segment seg_%d (subsumed by a "
                    "newer full step)",
                    seg,
                )
                storage.sync_delete_dir(journal_mod.segment_dirname(seg))
                removed_segs.append(seg)
                log_event(
                    Event(
                        name="gc.segment_removed",
                        metadata={
                            "segment": seg,
                            "root": self.root,
                            "reason": "stale",
                        },
                    )
                )
            # Orphan dirs gone: every chunk is now either referenced by a
            # committed manifest or garbage.  Best-effort — a committed
            # step whose manifest won't parse makes classification refuse,
            # and skipping the sweep is the conservative outcome.
            swept: List[str] = []
            try:
                swept = self._sweep_orphan_chunks(storage)
            except Exception:
                logger.warning(
                    "orphan-chunk sweep skipped (chunk classification "
                    "failed)",
                    exc_info=True,
                )
            # Chunk-sweep index bookkeeping ran inside _sweep_orphan_chunks;
            # segment removal changes the committed-marker set, which the
            # persisted sidecar validates against — refresh it when we hold
            # an index (without one, staleness self-detects on load).
            if removed_segs and self._digest_index is not None:
                self._persist_digest_index(storage)
            # The shared store's half: its two-phase sweep (condemn the
            # unreferenced chunks into quarantine, delete past-grace
            # epochs).  The per-root sweep above sees only <root>/cas/, the
            # per-root chunks of a root in mid migration.
            store_swept = self._store_sweep(apply=True, force=force)
            if store_swept:
                self._sync_index_after_sweep(storage, store_swept)
                swept = swept + store_swept
        finally:
            storage.sync_close()
        return orphans, swept, sorted(removed_segs)

    def _store_sweep(self, apply: bool, force: bool) -> List[str]:
        """The shared store's two-phase sweep when this root is store-backed:
        the chunk relpaths condemned or deleted (or, dry run, condemnable).
        A live foreign sweep makes it a no-op: one sweeper at a time, and the
        other tenant's sweep covers the store."""
        store_url = self._resolve_store_url()
        if store_url is None:
            return []
        try:
            report = store_mod.sweep(store_url, apply=apply, force=force)
        except store_mod.StoreSweepBusyError:
            logger.info("store sweep skipped: another tenant's sweep of %s looks live", store_url)
            return []
        except Exception:  # noqa: BLE001 — gc stays best-effort on the store
            logger.warning("shared-store sweep of %s failed; chunks remain gc-able", store_url, exc_info=True)
            return []
        return sorted(set(report["condemned"]) | set(report["deleted"]))

    # -------------------------------------------------------------- chunk gc

    def _referenced_chunks(self, storage, markers: List[str]) -> Set[str]:
        """Union of CAS chunk relpaths the given committed manifests
        (root-relative ``.snapshot_metadata`` paths — steps AND journal
        segments) reference.  A manifest that turns unreadable mid-scan
        makes reclamation REFUSE (raise) rather than classify its chunks
        orphan."""
        referenced: Set[str] = set()
        for marker in markers:
            read_io = ReadIO(path=marker)
            storage.sync_read(read_io)
            metadata = SnapshotMetadata.from_json(
                bytes(read_io.buf).decode("utf-8")
            )
            referenced |= cas_mod.referenced_chunk_relpaths(metadata.manifest)
        return referenced

    def chunk_classification(self, storage=None):
        """``(referenced, orphan)`` CAS chunk relpath lists: every chunk
        present under ``<root>/cas/`` is exactly one of the two (the
        invariant the chaos suite asserts).  Committed journal segments
        count as referencing — their delta manifests pin chunks exactly
        like step manifests do.  Both empty for non-CAS roots."""
        own = storage is None
        if own:
            storage = url_to_storage_plugin(self.root)
        try:
            present = cas_mod.list_chunk_relpaths(storage)
            if not present:
                return [], []
            referenced = self._referenced_chunks(
                storage, cas_mod.committed_marker_relpaths(storage)
            )
            return (
                [p for p in present if p in referenced],
                [p for p in present if p not in referenced],
            )
        finally:
            if own:
                storage.sync_close()

    def orphan_chunks(self, storage=None) -> List[str]:
        """CAS chunks referenced by no committed step — a crashed CAS-mode
        take's debris, or leftovers of an interrupted prune.  Same caveat
        as :meth:`orphan_steps`: an async save in flight makes its fresh
        chunks look orphaned."""
        return self.chunk_classification(storage=storage)[1]

    def _sweep_orphan_chunks(self, storage) -> List[str]:
        orphans = self.orphan_chunks(storage=storage)
        for relpath in orphans:
            storage.sync_delete(relpath)
            log_event(
                Event(
                    name="gc.chunk_removed",
                    metadata={"chunk": relpath, "root": self.root},
                )
            )
        if orphans:
            self._sync_index_after_sweep(storage, orphans)
            logger.info("GC: removed %d orphan CAS chunk(s)", len(orphans))
        return orphans

    def _sweep_chunk_candidates(self, candidates: Set[str]) -> None:
        """Delete the chunks in ``candidates`` that no committed manifest
        references anymore — the deferred half of a prune (refcounted
        reclamation).  Restricting the sweep to candidates referenced by
        the PRUNED steps keeps a concurrent take's fresh chunks out of
        reach by construction.  Best-effort: a failure leaves orphan
        chunks for ``gc``, never a broken snapshot.  A live-looking
        in-flight marker from ANOTHER process defers the sweep entirely
        (its uncommitted take may have dedup-hit a candidate); the
        requeued candidates sweep at the next trigger."""
        store_url = self._resolve_store_url()
        if store_url is not None:
            # Store-backed root: the candidates live under <store>/cas/, and
            # reclamation is the store's two-phase sweep restricted to them.
            # Condemnation quarantines rather than deletes, so a sibling
            # tenant's in-flight dedup hit stays resurrectable; a busy store
            # (a foreign sweep live) re-queues the candidates.
            try:
                report = store_mod.sweep(store_url, candidates=candidates)
                swept = sorted(set(report["condemned"]) | set(report["deleted"]))
                if swept:
                    storage = url_to_storage_plugin(self.root)
                    try:
                        self._sync_index_after_sweep(storage, swept)
                    finally:
                        storage.sync_close()
            except store_mod.StoreSweepBusyError:
                logger.info("store chunk sweep deferred: another tenant's sweep of %s looks live", store_url)
                with self._chunk_gc_lock:
                    self._deferred_chunk_candidates |= candidates
            except Exception:  # noqa: BLE001 — orphans stay for gc
                logger.warning(
                    "store chunk reclamation failed; orphan chunks remain GC-able (SnapshotManager.gc)",
                    exc_info=True,
                )
            return
        try:
            storage = url_to_storage_plugin(self.root)
            try:
                if self._foreign_inflight(storage):
                    logger.info(
                        "chunk sweep deferred: another process has an "
                        "in-flight save marker under %s",
                        self.root,
                    )
                    with self._chunk_gc_lock:
                        self._deferred_chunk_candidates |= candidates
                    return
                survivors = self._referenced_chunks(
                    storage, cas_mod.committed_marker_relpaths(storage)
                )
                swept: List[str] = []
                for relpath in sorted(candidates - survivors):
                    try:
                        storage.sync_delete(relpath)
                    except FileNotFoundError:
                        continue
                    swept.append(relpath)
                    log_event(
                        Event(
                            name="gc.chunk_removed",
                            metadata={"chunk": relpath, "root": self.root},
                        )
                    )
                self._sync_index_after_sweep(storage, swept)
            finally:
                storage.sync_close()
        except Exception:
            logger.warning(
                "CAS chunk reclamation failed; orphan chunks remain "
                "GC-able (SnapshotManager.gc)",
                exc_info=True,
            )

    def _foreign_inflight(self, storage) -> bool:
        """Whether a live-looking in-flight marker from ANOTHER process
        exists: target uncommitted and not provably stale (refresher
        stamp fresh, or a stamp-less marker not provably dead on this
        host)."""
        me = (socket.gethostname(), os.getpid())
        for doc in self.inflight_markers(storage=storage):
            if (doc.get("host"), doc.get("pid")) == me:
                continue  # our own save; the deferred-sweep counter covers it
            if self._marker_stale(storage, doc):
                continue
            return True
        return False

    # ---------------------------------------------------------------- prune

    def _enqueue_chunk_candidates(self, candidates: Set[str]) -> None:
        with self._chunk_gc_lock:
            self._deferred_chunk_candidates |= candidates
        self._maybe_sweep_deferred_chunks()

    def _maybe_sweep_deferred_chunks(self) -> None:
        """Sweep accumulated prune candidates iff no async save of this
        manager is in flight — an uncommitted take's manifest isn't visible
        to the survivor scan, and it may reference (via dedup hits, not
        just fresh writes) exactly the chunks queued here."""
        with self._chunk_gc_lock:
            if (
                self._inflight_async_saves > 0
                or not self._deferred_chunk_candidates
            ):
                return
            candidates = set(self._deferred_chunk_candidates)
            self._deferred_chunk_candidates.clear()
        self._sweep_chunk_candidates(candidates)

    def _maybe_prune(
        self,
        exclude_step: int,
        include_current: bool,
        protect: Optional[Set[int]] = None,
    ) -> Optional[Set[str]]:
        """Retention pruning with refcounted CAS chunk reclamation:
        pruning a step may reclaim only chunks no surviving committed
        manifest references.  Candidates — the PRUNED steps' chunk
        references, read before their directories go — are RETURNED, not
        swept: the caller routes them through the deferred-sweep queue,
        which waits out this manager's in-flight async saves (their
        commits may reference candidates).  Saves driven by other
        managers/processes are covered by the advisory in-flight markers
        (the sweep defers while a foreign marker looks live).

        ``protect``: steps never pruned regardless of retention — journal
        mode pins the base step its live segments replay over."""
        if self.max_to_keep is None:
            return None
        deferred: Optional[Set[str]] = None
        # Single deleter: rank 0 prunes between barriers so no rank is still
        # reading a pruned snapshot mid-restore; prune failures are logged,
        # never propagated past the closing barrier (peers are blocked in it).
        self._pg.barrier()
        try:
            if self._pg.get_rank() == 0:
                storage = url_to_storage_plugin(self.root)
                try:
                    committed = [
                        s
                        for s in self.all_steps(storage=storage)
                        if s != exclude_step and s not in (protect or ())
                    ]
                    budget = self.max_to_keep - (1 if include_current else 0)
                    excess = len(committed) - budget
                    to_prune = committed[: max(excess, 0)]
                    candidates: Set[str] = set()
                    if to_prune:
                        try:
                            candidates = self._referenced_chunks(
                                storage,
                                [
                                    f"step_{s}/{SNAPSHOT_METADATA_FNAME}"
                                    for s in to_prune
                                ],
                            )
                        except Exception:
                            # Unreadable manifest: prune the dirs, leave the
                            # chunks (they become gc-able orphans at worst).
                            logger.warning(
                                "chunk refcount scan failed; pruned steps' "
                                "chunks left for gc",
                                exc_info=True,
                            )
                    for step in to_prune:
                        logger.info("Pruning snapshot step_%d", step)
                        storage.sync_delete_dir(f"step_{step}")
                    if candidates:
                        deferred = candidates
                finally:
                    storage.sync_close()
        except NotImplementedError:
            logger.warning("Retention skipped: backend is not listable")
        except Exception:
            logger.exception("Retention pruning failed; continuing")
        finally:
            self._pg.barrier()
        return deferred
