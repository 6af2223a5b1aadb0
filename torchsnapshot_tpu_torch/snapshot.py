"""The Snapshot API: take / restore / read_object.

Counterpart of ``torchsnapshot_tpu/snapshot.py`` for the synchronous,
single-process slice, in the JAX order:

- ``take``: flatten each stateful's state dict (RNG state last) into a
  manifest, plan one write per leaf (chunking tensors above 512 MB), batch
  small writes into slabs, execute the budgeted pipeline (D2H into pinned
  buffers, fused write+hash), then commit ``.snapshot_metadata`` — the one
  durable write whose existence means "committed".  A take that fails
  before its commit removes its partial directory.
- ``restore``: per stateful, read every entry in place into the tensors its
  current ``state_dict()`` returns (same ``data_ptr()`` before and after),
  uploading CUDA targets through an :class:`H2DBatcher` that is drained
  before the stateful's ``load_state_dict`` runs.
- ``read_object``: random access to one value; a tensor with no target is
  placed on ``device``, which defaults to ``"cuda"``.

Asynchronous takes, distribution, sharded (DTensor) state, compression,
content addressing, journals, caches and telemetry are later slices and
are absent here.
"""

from __future__ import annotations

import inspect
import logging
import random
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import io_preparer, knobs, retry as retry_policy
from .batcher import batch_read_requests, batch_write_requests
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
    SnapshotMetadata,
    TensorEntry,
    UnsupportedSnapshotError,
    manifest_version_for,
)
from .manifest_utils import is_container_entry
from .pg_wrapper import PGWrapper
from .rng_state import RNGState
from .scheduler import (
    get_process_memory_budget_bytes,
    sync_execute_read_reqs,
    sync_execute_write_reqs,
)
from .stateful import AppState, Stateful
from .storage_plugin import url_to_storage_plugin

logger = logging.getLogger(__name__)

SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"

Device = Union[str, torch.device, None]


class Snapshot:
    """A committed snapshot at ``path`` (a directory, or ``memory://``)."""

    def __init__(self, path: str, pg: Optional[PGWrapper] = None) -> None:
        self.path = path
        self._pg = pg or PGWrapper()
        self._metadata: Optional[SnapshotMetadata] = None

    # ------------------------------------------------------------------ take

    @classmethod
    def take(
        cls, path: str, app_state: AppState, pg: Optional[PGWrapper] = None
    ) -> "Snapshot":
        pg = pg or PGWrapper()
        event_metadata: Dict[str, Any] = {
            "unique_id": uuid.uuid4().hex,
            "rank": pg.get_rank(),
            "action": "take",
        }
        log_event(Event(name="take.start", metadata=dict(event_metadata)))
        begin = time.monotonic()
        try:
            cls._validate_app_state(app_state)
            storage = url_to_storage_plugin(path)
            try:
                try:
                    entries, nbytes = cls._take_impl(app_state, storage, pg)
                    global_manifest = cls._gather_manifest(entries, pg)
                    metadata = SnapshotMetadata(
                        version=manifest_version_for(global_manifest),
                        world_size=pg.get_world_size(),
                        manifest=global_manifest,
                    )
                    # Every payload is durable → rank 0 commits.
                    pg.barrier()
                    if pg.get_rank() == 0:
                        cls._write_snapshot_metadata(metadata, storage)
                    pg.barrier()
                except BaseException:
                    cls._cleanup_failed_take(storage, pg)
                    raise
            finally:
                storage.sync_close()
        except Exception:
            event_metadata["duration_s"] = time.monotonic() - begin
            event_metadata["is_success"] = False
            log_event(Event(name="take.end", metadata=event_metadata))
            raise
        snapshot = cls(path=path, pg=pg)
        snapshot._metadata = metadata
        event_metadata["duration_s"] = time.monotonic() - begin
        event_metadata["bytes"] = nbytes
        event_metadata["is_success"] = True
        log_event(Event(name="take.end", metadata=event_metadata))
        return snapshot

    @classmethod
    def _take_impl(
        cls, app_state: AppState, storage: StoragePlugin, pg: PGWrapper
    ) -> Tuple[Manifest, int]:
        rank = pg.get_rank()
        app_state = dict(app_state)
        rng_state_item = cls._pop_rng_state(app_state)

        # Taking a snapshot must not perturb the global RNGs.
        py_rng_state, np_rng_state = random.getstate(), np.random.get_state()

        manifest: Manifest = {}
        flattened: Dict[str, Any] = {}
        for key in sorted(app_state):
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

        entries: Manifest = dict(manifest)
        write_reqs: List[WriteReq] = []
        for logical_path, obj in flattened.items():
            entry, obj_write_reqs = io_preparer.prepare_write(
                obj=obj, logical_path=logical_path, rank=rank
            )
            entries[logical_path] = entry
            write_reqs += obj_write_reqs
        # (Partitioning write requests across ranks is the identity at
        # world size 1.)
        if not knobs.is_batching_disabled():
            entries, write_reqs = batch_write_requests(
                entries, write_reqs, scatter_ok=storage.supports_scatter
            )
        nbytes = sync_execute_write_reqs(
            write_reqs=write_reqs,
            storage=storage,
            memory_budget_bytes=get_process_memory_budget_bytes(pg),
            rank=rank,
        )
        # Stagers annotated their entries with digests during the pipeline,
        # so the manifest is complete only now.
        return entries, nbytes

    # --------------------------------------------------------------- restore

    def restore(self, app_state: AppState, strict: bool = True) -> None:
        """Restores the app state in place.  Dense and chunked CUDA uploads
        have landed when this returns.  ``strict=False`` is forwarded to
        statefuls whose ``load_state_dict`` accepts it."""
        self._validate_app_state(app_state)
        pg = self._pg
        event_metadata: Dict[str, Any] = {
            "unique_id": uuid.uuid4().hex,
            "rank": pg.get_rank(),
            "action": "restore",
        }
        log_event(Event(name="restore.start", metadata=dict(event_metadata)))
        begin = time.monotonic()
        try:
            storage = url_to_storage_plugin(self.path)
            try:
                metadata = self._get_metadata(storage)
                app_state = dict(app_state)
                rng_state_item = self._pop_rng_state(app_state)
                memory_budget_bytes = get_process_memory_budget_bytes(pg)
                for key in sorted(app_state):
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
            finally:
                storage.sync_close()
        except Exception:
            event_metadata["duration_s"] = time.monotonic() - begin
            event_metadata["is_success"] = False
            log_event(Event(name="restore.end", metadata=event_metadata))
            raise
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
        local_manifest = _manifest_for_rank(metadata, self._pg.get_rank())
        # The current state dict provides the in-place restore targets.
        _, target_flattened = flatten(stateful.state_dict(), prefix=stateful_key)
        sub_manifest = _sub_manifest(local_manifest, stateful_key)
        if not sub_manifest:
            logger.warning("No entries for stateful %r in snapshot", stateful_key)
            return
        resolved, container_entries = _read_entries(
            sub_manifest,
            targets=target_flattened,
            storage=storage,
            memory_budget_bytes=memory_budget_bytes,
            rank=self._pg.get_rank(),
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

        ``obj_out``: a tensor or numpy array to restore into in place.
        Without one, a tensor is placed on ``device`` (default ``"cuda"``).
        ``memory_budget_bytes`` bounds the read buffers (large tensors read
        in tiles under it)."""
        event_metadata: Dict[str, Any] = {
            "unique_id": uuid.uuid4().hex,
            "rank": self._pg.get_rank(),
            "action": "read_object",
        }
        log_event(Event(name="read_object.start", metadata=dict(event_metadata)))
        begin = time.monotonic()
        try:
            rank_str, _, logical_path = path.partition("/")
            storage = url_to_storage_plugin(self.path)
            try:
                metadata = self._get_metadata(storage)
                manifest = _manifest_for_rank(metadata, int(rank_str))
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

    def get_state_dict_for_key(self, key: str, device: Device = None) -> Dict[str, Any]:
        """Materialize the state dict saved under an app-state key, without
        a target stateful; tensors land on ``device`` (default ``"cuda"``)."""
        storage = url_to_storage_plugin(self.path)
        try:
            metadata = self._get_metadata(storage)
            local_manifest = _manifest_for_rank(metadata, self._pg.get_rank())
            sub_manifest = _sub_manifest(local_manifest, key)
            if not sub_manifest:
                raise RuntimeError(f"Key {key!r} not found in snapshot manifest")
            resolved, container_entries = _read_entries(
                sub_manifest,
                targets={},
                storage=storage,
                memory_budget_bytes=get_process_memory_budget_bytes(self._pg),
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

    @property
    def metadata(self) -> SnapshotMetadata:
        storage = url_to_storage_plugin(self.path)
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
    def _cleanup_failed_take(storage: StoragePlugin, pg: PGWrapper) -> None:
        """Remove the partial directory of a take that failed before its
        commit (rank 0, and only while the commit marker is absent).  A
        failing cleanup is logged: the take's own error is what raises."""
        if pg.get_rank() != 0:
            return
        try:
            if storage.sync_exists(SNAPSHOT_METADATA_FNAME):
                return
            storage.sync_delete_dir("")
            logger.warning("take failed before commit; removed its partial snapshot")
        except Exception:  # noqa: BLE001 — never mask the take's error
            logger.warning(
                "take failed before commit and its cleanup failed too",
                exc_info=True,
            )

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
    def _gather_manifest(entries: Manifest, pg: PGWrapper) -> Manifest:
        """The rank-prefixed global manifest (rank 0 gathers; the identity
        gather at world size 1)."""
        gathered = pg.gather_object_root(entries)
        assert gathered is not None
        return {
            f"{rank}/{logical_path}": entry
            for rank, rank_entries in enumerate(gathered)
            for logical_path, entry in rank_entries.items()
        }


def _manifest_for_rank(metadata: SnapshotMetadata, rank: int) -> Manifest:
    """This rank's view of the global manifest."""
    if metadata.world_size != 1:
        raise UnsupportedSnapshotError(
            f"the snapshot was taken by {metadata.world_size} ranks; "
            "multi-rank snapshots are not supported by torchsnapshot_tpu_torch "
            "yet"
        )
    prefix = f"{rank}/"
    return {
        path[len(prefix) :]: entry
        for path, entry in metadata.manifest.items()
        if path.startswith(prefix)
    }


def _sub_manifest(manifest: Manifest, key: str) -> Manifest:
    prefix = key + "/"
    return {
        path: entry
        for path, entry in manifest.items()
        if path == key or path.startswith(prefix)
    }


def _is_tensor_entry(entry: Entry) -> bool:
    return isinstance(entry, (TensorEntry, ChunkedTensorEntry))


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
