"""Shared multi-tenant chunk store: cross-root CAS and ledger-fenced GC.

Counterpart of ``torchsnapshot_tpu/store.py``, with the same layout and the
same JSON documents (paths and field names), so a tenant of either package
shares one store with a tenant of the other.  cas.py stores chunks once per
*root*; with a store (``TPUSNAP_STORE=<dir>`` or
``SnapshotManager(store=...)``) every tenant root's manifests keep
referencing plain ``cas://<algo>/<hex>`` digests, but the chunks live under
the store, so two tenants saving identical bytes share one chunk.

Layout (paths relative to the store root URL)::

    cas/<algo>/<p2>/<digest>          chunks (same layout as per-root CAS)
    tenants/<tid>.json                durable tenant registration
    ledger/<tid>/refs_*.json          append-only per-root reference journals
    leases/writer_<tid>_<pid>.json    refreshed per-writer liveness stamps
    sweep/epoch.json                  monotone sweep epoch (durable)
    sweep/lease.json                  the sweeper's refreshed liveness stamp
    quarantine/<epoch>/.condemned     condemn-time stamp for the grace clock
    quarantine/<epoch>/cas/...        condemned chunks awaiting the grace

A sweep in one root cannot see the foreign writers of the store: a take in
root B may dedup against a chunk the sweeper in root A just classified as
orphan.  Three mechanisms close every window:

1. **Reference journals** (append-only, durable): a store-mode take appends
   the chunk set its manifest will reference *before* the commit marker is
   written (``cas.apply_relocations``), so the sweeper reads a durable
   record through the commit-vs-sweep window.
2. **Two-phase sweep** (condemn → grace quarantine → delete): orphans are
   durably *moved* into ``quarantine/<epoch>/``, never deleted in place.
   To a writer a quarantined chunk is a miss (the store-mode index hit
   probes for existence), so it re-writes it; a reader's
   :class:`StoreResolver` falls back into the quarantine and resurrects
   it.  After the grace (``TPUSNAP_STORE_QUARANTINE_S``) the delete phase
   re-computes the referenced set: re-referenced chunks are restored, the
   rest deleted.
3. **Epoch-fenced leases**: every writer stamps a refreshed lease with the
   sweep epoch it observed at entry; quarantine epoch E is deleted only
   when no fresh writer lease has ``observed_epoch <= E``.  Liveness is a
   stamp age, valid across hosts, so a kill -9 anywhere leaves state any
   surviving tenant adopts after the grace.

Each condemned, restored, deleted and resurrected chunk counts on
``tpusnap_gc_actions_total`` and the sweep's ``store.sweep`` event is
logged, as in the JAX package; :func:`publish_usage_metrics` exports a
:func:`tenant_usage` report.  The writer and sweep leases leave their
flight-recorder records (``store_writer.*``, ``store_sweep.*``), which the
postmortem reads.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from .io_types import ReadIO, StoragePlugin, WriteIO
from .telemetry import blackbox

logger = logging.getLogger(__name__)

TENANTS_DIR = "tenants"
LEDGER_DIR = "ledger"
LEASES_DIR = "leases"
SWEEP_DIR = "sweep"
QUARANTINE_DIR = "quarantine"
EPOCH_FNAME = f"{SWEEP_DIR}/epoch.json"
SWEEP_LEASE_FNAME = f"{SWEEP_DIR}/lease.json"
CONDEMNED_FNAME = ".condemned"
# Root-level durable pointer a tenant root writes when it joins a store, so
# readers resolve chunks store-first with no knob set.
STORE_POINTER_FNAME = ".store"


class StoreSweepBusyError(RuntimeError):
    """A foreign sweep's lease looks live (stamp within the grace)."""


# ------------------------------------------------------------------ identity


def canonical_root_url(root_url: str) -> str:
    """One spelling per root: ``/tmp/r``, ``/tmp/r/`` and ``fs:///tmp/r``
    are the same tenant (the manager registers the bare path, the take's
    writer context the protocol form of ``parent_root_url``)."""
    from .storage_plugin import parse_url

    protocol, path = parse_url(root_url)
    return f"{protocol}://{path.rstrip('/')}"


def tenant_id(root_url: str) -> str:
    """Stable short id of a tenant root (registration, ledger and lease
    namespaces): content-derived, so every process naming the root agrees
    without coordination."""
    return hashlib.sha256(canonical_root_url(root_url).encode("utf-8")).hexdigest()[:16]


def _host() -> str:
    try:
        return socket.gethostname()
    except Exception:  # noqa: BLE001 — a lease names some host either way
        return "unknown"


def _now() -> float:
    return time.time()


def _liveness_grace() -> float:
    """Stamp age past which a lease holder is presumed dead: the store-side
    lease grace, or 10 s when that is 0 (disabled) — the shared store cannot
    run without liveness detection, and a pid probe means nothing across
    hosts."""
    from . import knobs

    grace = knobs.get_lease_grace_s()
    return grace if grace > 0 else 10.0


# ------------------------------------------------------------- JSON helpers


def _read_json(storage: StoragePlugin, relpath: str) -> Optional[Dict[str, Any]]:
    try:
        read_io = ReadIO(path=relpath)
        storage.sync_read(read_io)
        doc = json.loads(bytes(read_io.buf).decode("utf-8"))
        return doc if isinstance(doc, dict) else None
    except Exception:  # noqa: BLE001 — absent, torn or foreign: no document
        return None


def _write_json(storage: StoragePlugin, relpath: str, doc: Dict[str, Any]) -> None:
    storage.sync_write(WriteIO(path=relpath, buf=json.dumps(doc, sort_keys=True).encode("utf-8"), durable=True))


def _list_dir(storage: StoragePlugin, relpath: str) -> List[str]:
    try:
        return sorted(storage.sync_list_dir(relpath))
    except Exception:  # noqa: BLE001 — absent or unlistable: nothing there
        return []


# ------------------------------------------------------------ store pointer


def read_store_pointer(root_storage: StoragePlugin) -> Optional[str]:
    """The store URL a tenant root durably joined, or None."""
    doc = _read_json(root_storage, STORE_POINTER_FNAME)
    if doc and isinstance(doc.get("store"), str) and doc["store"]:
        return doc["store"]
    return None


def _resolve_store_url(path: str) -> Optional[str]:
    """Shared-store URL a path participates in, if any: the
    ``TPUSNAP_STORE`` knob wins, else the ``.store`` pointer at ``path``
    (a manager root) or, for a snapshot or segment path, at its parent.
    The postmortem and the command line read it here.  Unlike
    ``SnapshotManager._resolve_store_url``, which reads only its root and
    caches the answer, each call reads again."""
    from . import knobs
    from .storage_plugin import url_to_storage_plugin

    store_url = knobs.get_store_url()
    if store_url is not None:
        return store_url
    candidates = [path]
    parent, _, _ = path.rstrip("/").rpartition("/")
    if parent:
        candidates.append(parent)
    for candidate in candidates:
        try:
            storage = url_to_storage_plugin(candidate)
        except Exception:  # noqa: BLE001 — not a root this process can open
            continue
        try:
            store_url = read_store_pointer(storage)
        except Exception:  # noqa: BLE001 — unreadable pointer: not joined
            store_url = None
        finally:
            storage.sync_close()
        if store_url is not None:
            return store_url
    return None


def write_store_pointer(root_storage: StoragePlugin, store_url: str) -> None:
    """Durably mark a tenant root as store-backed.  A migration writes it
    after every chunk landed in the store and before the local originals
    go, so a reader always resolves a complete side."""
    _write_json(root_storage, STORE_POINTER_FNAME, {"store": store_url})


# ------------------------------------------------------------------ tenants


def register_tenant(storage: StoragePlugin, root_url: str) -> str:
    """Idempotent durable registration; returns the tenant id.  Registration
    is what puts a root's manifests into the sweep's referenced set: an
    unregistered root's chunks WILL be condemned."""
    root_url = canonical_root_url(root_url)
    tid = tenant_id(root_url)
    relpath = f"{TENANTS_DIR}/{tid}.json"
    doc = _read_json(storage, relpath)
    if doc is None or doc.get("root") != root_url:
        _write_json(storage, relpath, {"tenant": tid, "root": root_url, "registered": _now()})
    return tid


def registered_tenants(storage: StoragePlugin) -> Dict[str, str]:
    """Tenant id → root URL for every registered tenant."""
    out: Dict[str, str] = {}
    for name in _list_dir(storage, TENANTS_DIR):
        if not name.endswith(".json"):
            continue
        doc = _read_json(storage, f"{TENANTS_DIR}/{name}")
        if doc and isinstance(doc.get("root"), str):
            out[doc.get("tenant") or name[: -len(".json")]] = doc["root"]
    return out


# -------------------------------------------------------------------- epoch


def read_epoch(storage: StoragePlugin) -> int:
    doc = _read_json(storage, EPOCH_FNAME)
    if doc is None:
        return 0
    try:
        return int(doc.get("epoch", 0))
    except (TypeError, ValueError):
        return 0


def bump_epoch(storage: StoragePlugin) -> int:
    """Durably advance the sweep epoch; returns the new value.  Called at
    condemn-phase entry, so every writer lease written after the bump
    carries ``observed_epoch >= E``."""
    epoch = read_epoch(storage) + 1
    _write_json(storage, EPOCH_FNAME, {"epoch": epoch, "stamp": _now()})
    return epoch


# ------------------------------------------------------------ writer leases


def writer_lease_relpath(tid: str, pid: int) -> str:
    return f"{LEASES_DIR}/writer_{tid}_{pid}.json"


def _stamp_of(doc: Dict[str, Any]) -> float:
    try:
        return float(doc.get("stamp", 0.0))
    except (TypeError, ValueError):
        return 0.0


def fresh_writer_leases(storage: StoragePlugin) -> List[Dict[str, Any]]:
    """Writer lease documents whose stamp is within the liveness grace."""
    grace = _liveness_grace()
    now = _now()
    out: List[Dict[str, Any]] = []
    for name in _list_dir(storage, LEASES_DIR):
        if not name.startswith("writer_"):
            continue
        doc = _read_json(storage, f"{LEASES_DIR}/{name}")
        if doc is not None and now - _stamp_of(doc) <= grace:
            doc["_relpath"] = f"{LEASES_DIR}/{name}"
            out.append(doc)
    return out


class StoreWriterContext:
    """Per-take store plumbing: tenant registration, a refreshed writer lease
    (cross-host liveness) and the pre-commit reference-journal append.
    ``cas.maybe_wrap_cas_writes`` creates it in store mode and the CAS writer
    closes it, so every store-mode take, manager-driven or a bare
    ``Snapshot.take``, is covered."""

    def __init__(self, storage: StoragePlugin, store_url: str, root_url: str) -> None:
        self._storage = storage  # shared with the CAS writer, which closes it
        self.store_url = store_url
        self.root_url = root_url
        self.tenant = tenant_id(root_url)
        self.observed_epoch = 0
        self._pid = os.getpid()
        self._lease_relpath = writer_lease_relpath(self.tenant, self._pid)
        self._seq = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        from . import knobs

        register_tenant(self._storage, self.root_url)
        # The epoch is observed BEFORE the lease is stamped: a sweep that
        # bumps to E+1 after our stamp sees observed_epoch <= E fresh and
        # defers the deletion of epochs <= E until this take ends.
        self.observed_epoch = read_epoch(self._storage)
        self._write_lease()
        blackbox.record("lease", "store_writer.start", {"tenant": self.tenant, "epoch": self.observed_epoch})
        self._thread = threading.Thread(
            target=self._refresh_loop,
            args=(max(0.05, knobs.get_lease_interval_s()),),
            daemon=True,
            name="snap_store_writer_lease",
        )
        self._thread.start()

    def _write_lease(self) -> None:
        _write_json(
            self._storage,
            self._lease_relpath,
            {
                "tenant": self.tenant,
                "root": self.root_url,
                "host": _host(),
                "pid": self._pid,
                "epoch": self.observed_epoch,
                "stamp": _now(),
            },
        )

    def _refresh_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self._write_lease()
            except Exception:  # noqa: BLE001 — the next refresh retries
                logger.debug("writer lease refresh failed", exc_info=True)

    def append_refs(self, relpaths: Set[str]) -> None:
        """Durably journal the chunk set this take's manifest references.
        MUST run before the commit marker: the journal protects a dedup
        decision through the commit-vs-sweep window."""
        if not relpaths:
            return
        with self._lock:
            self._seq += 1
            seq = self._seq
        name = f"refs_{self._pid}_{time.time_ns()}_{seq}.json"
        _write_json(
            self._storage,
            f"{LEDGER_DIR}/{self.tenant}/{name}",
            {
                "tenant": self.tenant,
                "pid": self._pid,
                "host": _host(),
                "epoch": self.observed_epoch,
                "stamp": _now(),
                "chunks": sorted(relpaths),
            },
        )

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            self._storage.sync_delete(self._lease_relpath)
        except Exception:  # noqa: BLE001 — a stale lease ages out
            pass
        blackbox.record("lease", "store_writer.close", {"tenant": self.tenant})


# ------------------------------------------------------------------- ledger


def _ledger_entries(storage: StoragePlugin) -> List[Tuple[str, Dict[str, Any]]]:
    out: List[Tuple[str, Dict[str, Any]]] = []
    for tid in _list_dir(storage, LEDGER_DIR):
        for name in _list_dir(storage, f"{LEDGER_DIR}/{tid}"):
            relpath = f"{LEDGER_DIR}/{tid}/{name}"
            doc = _read_json(storage, relpath)
            if doc is not None:
                out.append((relpath, doc))
    return out


def _entry_protects(doc: Dict[str, Any], fresh_leases: List[Dict[str, Any]]) -> bool:
    """Whether a ledger entry still protects its chunks: its writer's lease
    is fresh (take in flight), or the entry is younger than the quarantine
    grace (the lease-removal-vs-commit race).  Past both, the committed
    manifests protect the chunks, or, for an aborted take, nothing does."""
    from . import knobs

    for lease in fresh_leases:
        if (
            lease.get("tenant") == doc.get("tenant")
            and lease.get("pid") == doc.get("pid")
            and lease.get("host") == doc.get("host")
        ):
            return True
    grace = max(knobs.get_store_quarantine_s(), _liveness_grace())
    return _now() - _stamp_of(doc) <= grace


def ledger_protected_chunks(storage: StoragePlugin) -> Set[str]:
    """Chunk relpaths protected by live ledger entries."""
    fresh = fresh_writer_leases(storage)
    out: Set[str] = set()
    for _, doc in _ledger_entries(storage):
        if _entry_protects(doc, fresh):
            chunks = doc.get("chunks")
            if isinstance(chunks, list):
                out.update(c for c in chunks if isinstance(c, str))
    return out


# --------------------------------------------------------------- referenced


def _committed_refs(root: StoragePlugin, root_url: str, strict: bool) -> Set[str]:
    """Chunk relpaths every committed manifest under one tenant root
    references.  ``strict``: an unreadable manifest raises (a sweep that
    guessed would delete live bytes); else it contributes nothing."""
    from . import cas
    from .manifest import SnapshotMetadata

    refs: Set[str] = set()
    for marker in cas.committed_marker_relpaths(root):
        read_io = ReadIO(path=marker)
        try:
            root.sync_read(read_io)
            metadata = SnapshotMetadata.from_json(bytes(read_io.buf).decode("utf-8"))
        except Exception as e:  # noqa: BLE001 — refused or skipped, per strict
            if strict:
                raise RuntimeError(
                    f"store sweep: cannot read committed manifest {marker} of tenant {root_url}: {e}"
                ) from e
            continue
        refs |= cas.referenced_chunk_relpaths(metadata.manifest)
    return refs


def referenced_chunks_store_wide(
    storage: StoragePlugin,
    storage_options: Optional[Dict[str, Any]] = None,
    include_ledger: bool = True,
) -> Set[str]:
    """Chunk relpaths referenced by ANY registered tenant's committed
    manifests, plus (by default) live ledger entries.  An unreadable
    committed manifest RAISES; a tenant root that is gone contributes
    nothing (its registration is a tombstone until an operator removes
    it)."""
    from .storage_plugin import url_to_storage_plugin

    referenced: Set[str] = set()
    for tid, root_url in sorted(registered_tenants(storage).items()):
        try:
            root = url_to_storage_plugin(root_url, storage_options)
        except Exception:  # noqa: BLE001 — unreachable root: nothing to add
            logger.warning("store tenant %s root %s unreachable", tid, root_url)
            continue
        try:
            referenced |= _committed_refs(root, root_url, strict=True)
        finally:
            root.sync_close()
    if include_ledger:
        referenced |= ledger_protected_chunks(storage)
    return referenced


# --------------------------------------------------------------- quarantine


def quarantine_relpath(epoch: int, chunk_rel: str) -> str:
    return f"{QUARANTINE_DIR}/{epoch}/{chunk_rel}"


def _quarantine_epochs(storage: StoragePlugin) -> List[int]:
    out: List[int] = []
    for name in _list_dir(storage, QUARANTINE_DIR):
        try:
            out.append(int(name))
        except ValueError:
            continue
    return sorted(out)


def _quarantined_chunks(storage: StoragePlugin, epoch: int) -> List[str]:
    """Chunk relpaths (``cas/...``) condemned into one quarantine epoch."""
    from .cas import CAS_DIR

    base = f"{QUARANTINE_DIR}/{epoch}/{CAS_DIR}"
    out: List[str] = []
    for algo in _list_dir(storage, base):
        for prefix in _list_dir(storage, f"{base}/{algo}"):
            for name in _list_dir(storage, f"{base}/{algo}/{prefix}"):
                out.append(f"{CAS_DIR}/{algo}/{prefix}/{name}")
    return sorted(out)


def quarantined_chunk_relpaths(storage: StoragePlugin) -> List[str]:
    """Every condemned chunk as its ``cas/...`` relpath, deduplicated across
    epochs."""
    seen: Set[str] = set()
    for epoch in _quarantine_epochs(storage):
        seen.update(_quarantined_chunks(storage, epoch))
    return sorted(seen)


def _copy_chunk(storage: StoragePlugin, src: str, dst: str) -> bool:
    """Durable copy inside the store; False when the source is gone (a
    concurrent mover won the race, which is fine either way)."""
    try:
        read_io = ReadIO(path=src)
        storage.sync_read(read_io)
    except FileNotFoundError:
        return False
    storage.sync_write(WriteIO(path=dst, buf=read_io.buf, durable=True))
    return True


# -------------------------------------------------------------- sweep lease


class _SweepLease:
    """The sweeper's refreshed liveness stamp.  A crashed sweep leaves a
    stale lease (stamp older than the grace) that any surviving tenant
    adopts."""

    def __init__(self, storage: StoragePlugin) -> None:
        self._storage = storage
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.phase = "acquire"
        self.epoch = 0
        self.adopted = False

    def _write(self) -> None:
        _write_json(
            self._storage,
            SWEEP_LEASE_FNAME,
            {"host": _host(), "pid": os.getpid(), "phase": self.phase, "epoch": self.epoch, "stamp": _now()},
        )

    def acquire(self, force: bool = False) -> None:
        from . import knobs

        doc = _read_json(self._storage, SWEEP_LEASE_FNAME)
        if doc is not None:
            ours = doc.get("host") == _host() and doc.get("pid") == os.getpid()
            if not ours and not force:
                age = _now() - _stamp_of(doc)
                if age <= _liveness_grace():
                    raise StoreSweepBusyError(
                        f"a foreign sweep looks live (host {doc.get('host')}, pid {doc.get('pid')}, "
                        f"phase {doc.get('phase')}, stamp {age:.1f}s old); retry after the lease grace "
                        "or pass force to adopt"
                    )
            if not ours:
                self.adopted = True
                logger.info(
                    "adopting %s sweep lease (host %s pid %s phase %s)",
                    "foreign" if force else "stale",
                    doc.get("host"),
                    doc.get("pid"),
                    doc.get("phase"),
                )
        self._write()
        blackbox.record("lease", "store_sweep.acquire", {"epoch": self.epoch, "adopted": self.adopted})
        self._thread = threading.Thread(
            target=self._refresh_loop,
            args=(max(0.05, knobs.get_lease_interval_s()),),
            daemon=True,
            name="snap_store_sweep_lease",
        )
        self._thread.start()

    def update(self, phase: str, epoch: Optional[int] = None) -> None:
        self.phase = phase
        if epoch is not None:
            self.epoch = epoch
        try:
            self._write()
        except Exception:  # noqa: BLE001 — the refresher rewrites it
            logger.debug("sweep lease update failed", exc_info=True)
        blackbox.record("lease", f"store_sweep.{phase}", {"epoch": self.epoch})

    def _refresh_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self._write()
            except Exception:  # noqa: BLE001 — the next refresh retries
                logger.debug("sweep lease refresh failed", exc_info=True)

    def release(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            self._storage.sync_delete(SWEEP_LEASE_FNAME)
        except Exception:  # noqa: BLE001 — a stale lease is adopted later
            pass
        blackbox.record("lease", "store_sweep.release", {"phase": self.phase, "epoch": self.epoch})


def foreign_sweep_live(storage: StoragePlugin) -> bool:
    """Whether a sweep lease of another holder looks live; a migration
    (:func:`repack_into_store`) refuses while one does."""
    doc = _read_json(storage, SWEEP_LEASE_FNAME)
    if doc is None:
        return False
    if doc.get("host") == _host() and doc.get("pid") == os.getpid():
        return False
    return _now() - _stamp_of(doc) <= _liveness_grace()


# -------------------------------------------------------------------- sweep


def sweep(
    store_url: str,
    apply: bool = True,
    force: bool = False,
    candidates: Optional[Set[str]] = None,
    storage_options: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The fleet-level two-phase GC sweep.

    Condemn phase: bump the epoch, compute the store-wide referenced set
    (every tenant's committed manifests and live ledger entries), and move
    every unreferenced chunk (only those in ``candidates`` when given: the
    prune-time path) into ``quarantine/<epoch>/``.  Delete phase: for every
    quarantine epoch older than the grace and past the writer fence (no
    fresh writer lease with ``observed_epoch <= epoch``), re-compute the
    referenced set: re-referenced chunks go back into ``cas/``, the rest
    are deleted.  Expired ledger journals are reaped alongside.

    ``apply=False`` is a read-only report.  Raises
    :class:`StoreSweepBusyError` when a foreign sweep looks live
    (``force=True`` adopts it, for a lease a kill -9 orphaned)."""
    from .storage_plugin import url_to_storage_plugin

    storage = url_to_storage_plugin(store_url, storage_options)
    try:
        return _sweep_locked(storage, apply, force, candidates)
    finally:
        storage.sync_close()


def _condemnable(storage: StoragePlugin, candidates: Optional[Set[str]]) -> List[str]:
    from . import cas

    referenced = referenced_chunks_store_wide(storage)
    return [
        p
        for p in cas.list_chunk_relpaths(storage)
        if p not in referenced and (candidates is None or p in candidates)
    ]


def _sweep_locked(
    storage: StoragePlugin, apply: bool, force: bool, candidates: Optional[Set[str]]
) -> Dict[str, Any]:
    report: Dict[str, Any] = {
        "epoch": read_epoch(storage),
        "condemned": [],
        "restored": [],
        "deleted": [],
        "deferred_epochs": [],
        "ledgers_reaped": 0,
        "adopted_lease": False,
    }
    if not apply:
        report["condemned"] = _condemnable(storage, candidates)
        report["quarantined"] = quarantined_chunk_relpaths(storage)
        return report

    lease = _SweepLease(storage)
    lease.acquire(force=force)
    report["adopted_lease"] = lease.adopted
    try:
        epoch = bump_epoch(storage)
        report["epoch"] = epoch
        lease.update("condemn", epoch=epoch)
        targets = _condemnable(storage, candidates)
        if targets:
            # The stamp starts the grace clock and is durable BEFORE any
            # move: a crash mid-condemn leaves chunks in an epoch whose age
            # is always known.
            _write_json(storage, f"{QUARANTINE_DIR}/{epoch}/{CONDEMNED_FNAME}", {"epoch": epoch, "stamp": _now()})
        for chunk_rel in targets:
            if _copy_chunk(storage, chunk_rel, quarantine_relpath(epoch, chunk_rel)):
                storage.sync_delete(chunk_rel)
                report["condemned"].append(chunk_rel)
                _record_gc("chunk_condemned")
        lease.update("delete")
        _delete_phase(storage, report, force=force)
        report["ledgers_reaped"] = _reap_expired_ledgers(storage)
        _emit_sweep_event(report)
    finally:
        lease.release()
    return report


def _delete_phase(storage: StoragePlugin, report: Dict[str, Any], force: bool = False) -> None:
    from . import knobs

    grace = knobs.get_store_quarantine_s()
    now = _now()
    epochs = _quarantine_epochs(storage)
    if not epochs:
        return
    # The writer fence: the smallest epoch any fresh writer observed at
    # entry.  A writer with observed_epoch <= E may hold pre-condemn dedup
    # decisions for epoch E that no journal records yet.
    fence = min((int(lease.get("epoch", 0)) for lease in fresh_writer_leases(storage)), default=None)
    referenced = referenced_chunks_store_wide(storage)
    for epoch in epochs:
        stamp_doc = _read_json(storage, f"{QUARANTINE_DIR}/{epoch}/{CONDEMNED_FNAME}")
        try:
            stamp = float((stamp_doc or {}).get("stamp", now))
        except (TypeError, ValueError):
            stamp = now
        if not force and (
            # A missing condemn stamp (torn control write): age unknown,
            # so only an explicit force processes the epoch.
            stamp_doc is None
            or now - stamp < grace
            or (fence is not None and fence <= epoch)
        ):
            report["deferred_epochs"].append(epoch)
            continue
        for chunk_rel in _quarantined_chunks(storage, epoch):
            qpath = quarantine_relpath(epoch, chunk_rel)
            if chunk_rel in referenced:
                # Resurrect: a concurrent take deduped against the chunk
                # mid-condemnation and its journal or commit references it
                # now.  Restore, then delete, so a crash between the two
                # leaves both copies, never neither.
                if not storage.sync_exists(chunk_rel):
                    if not _copy_chunk(storage, qpath, chunk_rel):
                        continue
                    report["restored"].append(chunk_rel)
                    _record_gc("chunk_restored")
                storage.sync_delete(qpath)
            else:
                storage.sync_delete(qpath)
                report["deleted"].append(chunk_rel)
                _record_gc("chunk_removed")
        try:
            storage.sync_delete(f"{QUARANTINE_DIR}/{epoch}/{CONDEMNED_FNAME}")
        except Exception:  # noqa: BLE001 — a drained epoch left is harmless
            pass
        try:
            storage.sync_delete_dir(f"{QUARANTINE_DIR}/{epoch}")
        except Exception:  # noqa: BLE001 — a drained epoch left is harmless
            pass


def _reap_expired_ledgers(storage: StoragePlugin) -> int:
    """Delete reference journals that protect nothing anymore: the writer's
    lease is stale AND the entry is past the grace, so its take either
    committed (the manifests protect the chunks) or died (the chunks are
    condemnable debris).  This is how a crashed writer's journal is
    collected by any surviving tenant."""
    fresh = fresh_writer_leases(storage)
    reaped = 0
    for relpath, doc in _ledger_entries(storage):
        if _entry_protects(doc, fresh):
            continue
        try:
            storage.sync_delete(relpath)
            reaped += 1
        except Exception:  # noqa: BLE001 — reaped by a later sweep
            pass
    return reaped


def _record_gc(kind: str) -> None:
    try:
        from .telemetry import metrics as tmetrics

        tmetrics.record_gc(kind)
    except Exception:  # noqa: BLE001 — a metric never fails a sweep
        pass


def _emit_sweep_event(report: Dict[str, Any]) -> None:
    from .event import Event
    from .event_handlers import log_event

    log_event(
        Event(
            name="store.sweep",
            metadata={
                "epoch": report["epoch"],
                "condemned": len(report["condemned"]),
                "restored": len(report["restored"]),
                "deleted": len(report["deleted"]),
                "deferred_epochs": report["deferred_epochs"],
                "ledgers_reaped": report["ledgers_reaped"],
                "adopted_lease": report["adopted_lease"],
            },
        )
    )


# ----------------------------------------------------------- classification


def chunk_classification(store_url: str, storage_options: Optional[Dict[str, Any]] = None) -> Dict[str, List[str]]:
    """Store-wide accounting: every present chunk is exactly one of
    ``referenced`` (a committed manifest or a live journal names it),
    ``orphan`` (under ``cas/`` with no referencer: debris awaiting
    condemnation) or ``condemned`` (quarantined, awaiting the grace).
    ``referenced + orphan`` is the ``cas/`` listing and ``condemned`` the
    quarantine's, so nothing is unclassifiable."""
    from . import cas
    from .storage_plugin import url_to_storage_plugin

    storage = url_to_storage_plugin(store_url, storage_options)
    try:
        referenced = referenced_chunks_store_wide(storage)
        present = cas.list_chunk_relpaths(storage)
        condemned = quarantined_chunk_relpaths(storage)
    finally:
        storage.sync_close()
    return {
        "referenced": sorted(p for p in present if p in referenced),
        "orphan": sorted(p for p in present if p not in referenced),
        "condemned": condemned,
    }


# -------------------------------------------------------------------- usage


def _chunk_sizes(store_url: str, storage: StoragePlugin, relpaths: List[str]) -> Dict[str, int]:
    """Relpath → byte size: a stat on fs, one read per chunk elsewhere
    (usage is an explicit report, not a hot path)."""
    from .storage_plugin import parse_url

    protocol, root = parse_url(store_url)
    sizes: Dict[str, int] = {}
    for relpath in relpaths:
        if protocol == "fs":
            try:
                sizes[relpath] = os.path.getsize(os.path.join(root, relpath))
                continue
            except OSError:
                pass
        try:
            read_io = ReadIO(path=relpath)
            storage.sync_read(read_io)
            sizes[relpath] = memoryview(read_io.buf).nbytes
        except Exception:  # noqa: BLE001 — gone since the listing
            sizes[relpath] = 0
    return sizes


def tenant_usage(store_url: str, storage_options: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Per-tenant logical-vs-physical accounting.  ``logical_bytes``: every
    chunk the tenant's committed manifests reference (what it would pay
    alone); ``exclusive_bytes``: chunks only that tenant references (what
    deleting it would reclaim).  The gap between the summed logical bytes
    and the store's physical total is the cross-tenant dedup."""
    from . import cas
    from .storage_plugin import url_to_storage_plugin

    storage = url_to_storage_plugin(store_url, storage_options)
    try:
        per_tenant_refs: Dict[str, Set[str]] = {}
        tenants = registered_tenants(storage)
        for tid, root_url in sorted(tenants.items()):
            try:
                root = url_to_storage_plugin(root_url, storage_options)
            except Exception:  # noqa: BLE001 — unreachable root: no references
                per_tenant_refs[tid] = set()
                continue
            try:
                per_tenant_refs[tid] = _committed_refs(root, root_url, strict=False)
            finally:
                root.sync_close()
        present = cas.list_chunk_relpaths(storage)
        sizes = _chunk_sizes(store_url, storage, present)
    finally:
        storage.sync_close()
    physical_total = sum(sizes.values())
    referencers: Dict[str, int] = {}
    for refs in per_tenant_refs.values():
        for chunk in refs:
            referencers[chunk] = referencers.get(chunk, 0) + 1
    out_tenants: Dict[str, Any] = {}
    for tid, refs in per_tenant_refs.items():
        out_tenants[tid] = {
            "root": tenants[tid],
            "logical_bytes": sum(sizes.get(c, 0) for c in refs),
            "exclusive_bytes": sum(sizes.get(c, 0) for c in refs if referencers.get(c, 0) == 1 and c in sizes),
            "chunks": len(refs),
        }
    logical_total = sum(t["logical_bytes"] for t in out_tenants.values())
    return {
        "tenants": out_tenants,
        "physical_bytes": physical_total,
        "logical_bytes": logical_total,
        "chunks": len(present),
        "dedup_ratio": round(logical_total / physical_total, 3) if physical_total else None,
    }


def publish_usage_metrics(usage: Dict[str, Any]) -> None:
    """Export a :func:`tenant_usage` report through the metrics registry:
    per tenant and ``_total``, logical and physical bytes."""
    from .telemetry import metrics as tmetrics

    for tid, doc in usage.get("tenants", {}).items():
        tmetrics.record_store_usage(tid, doc["logical_bytes"], doc["exclusive_bytes"])
    tmetrics.record_store_totals(usage.get("logical_bytes", 0), usage.get("physical_bytes", 0))


# ---------------------------------------------------------------- resolver


class StoreResolver(StoragePlugin):
    """Storage view of the shared store that closes the read-vs-sweep
    window: a chunk read that misses under ``cas/`` falls back into the
    quarantine and, on a hit, durably resurrects the chunk before serving
    it, so a committed manifest never dangles across a condemnation.
    ``fallback`` (the tenant root's own plugin) serves chunks a root in mid
    migration still holds locally.  Other paths (ledger, leases, sweep
    control) pass straight through to the store's plugin."""

    def __init__(self, inner: StoragePlugin, fallback: Optional[StoragePlugin] = None) -> None:
        self._inner = inner
        self._fallback = fallback
        self.supports_scatter = getattr(inner, "supports_scatter", False)

    def _get_executor(self):
        getter = getattr(self._inner, "_get_executor", None)
        return getter() if getter is not None else None

    @staticmethod
    def _is_chunk_path(path: str) -> bool:
        from .cas import CAS_DIR

        return path.startswith(CAS_DIR + "/")

    async def _resurrect(self, path: str) -> bool:
        """Copy a quarantined chunk back under ``cas/`` (durably) if any
        epoch holds it; True when the chunk is present afterwards."""
        try:
            epochs = await self._inner.list_dir(QUARANTINE_DIR)
        except Exception:  # noqa: BLE001 — no quarantine: nothing to resurrect
            return False
        for name in sorted(epochs, reverse=True):
            qpath = f"{QUARANTINE_DIR}/{name}/{path}"
            try:
                if not await self._inner.exists(qpath):
                    continue
                read_io = ReadIO(path=qpath)
                await self._inner.read(read_io)
                await self._inner.write(WriteIO(path=path, buf=read_io.buf, durable=True))
                _record_gc("chunk_resurrected")
                logger.info("resurrected condemned chunk %s from quarantine epoch %s", path, name)
                return True
            except Exception:  # noqa: BLE001 — try the next epoch
                continue
        return False

    async def read(self, read_io: ReadIO) -> None:
        try:
            await self._inner.read(read_io)
            return
        except FileNotFoundError:
            if not self._is_chunk_path(read_io.path):
                raise
        if await self._resurrect(read_io.path):
            await self._inner.read(read_io)
            return
        if self._fallback is not None:
            await self._fallback.read(read_io)
            return
        raise FileNotFoundError(read_io.path)

    async def write(self, write_io: WriteIO) -> None:
        await self._inner.write(write_io)

    async def exists(self, path: str) -> bool:
        if await self._inner.exists(path):
            return True
        if not self._is_chunk_path(path):
            return False
        # A quarantined chunk reports ABSENT on purpose: the writer's probe
        # must take it as a miss and re-write it durably (the read path
        # above is the resurrecting half).
        if self._fallback is not None:
            return await self._fallback.exists(path)
        return False

    async def list_dir(self, path: str) -> List[str]:
        return await self._inner.list_dir(path)

    async def delete(self, path: str) -> None:
        await self._inner.delete(path)

    async def delete_dir(self, path: str) -> None:
        await self._inner.delete_dir(path)

    async def copy_from_sibling(self, src_root: str, path: str) -> bool:
        return await self._inner.copy_from_sibling(src_root, path)

    async def close(self) -> None:
        try:
            await self._inner.close()
        finally:
            if self._fallback is not None:
                await self._fallback.close()


# ----------------------------------------------------------------- migrate


def repack_into_store(
    root_url: str, store_url: str, storage_options: Optional[Dict[str, Any]] = None
) -> Dict[str, int]:
    """Migrate a per-root CAS or journal root into a shared store.

    ``cas://`` digests are location-independent, so migration moves chunks
    and rewrites no manifest: (1) register the tenant, (2) durably copy
    every chunk a committed manifest references into the store, step by
    step, (3) durably write the root's ``.store`` pointer (the commit
    point: reads resolve store-first from here), (4) delete the local
    originals and the index sidecar.  A crash before (3) leaves a root
    readable locally (a re-run resumes; copied chunks dedup); after (3), a
    root readable from the store with stray local copies a re-run or a
    per-root gc reclaims.  Refuses while a foreign sweep looks live: its
    condemnation could quarantine chunks between our copy and our
    pointer."""
    from . import cas
    from .manifest import SnapshotMetadata
    from .storage_plugin import url_to_storage_plugin

    stats = {"steps": 0, "chunks_copied": 0, "bytes_copied": 0, "chunks_deduped": 0, "local_chunks_removed": 0}
    store = url_to_storage_plugin(store_url, storage_options)
    root = url_to_storage_plugin(root_url, storage_options)
    try:
        if foreign_sweep_live(store):
            raise StoreSweepBusyError(
                f"refusing to migrate {root_url} into {store_url}: a foreign sweep lease looks live; "
                "retry after it completes"
            )
        register_tenant(store, root_url)
        copied: Set[str] = set()
        for marker in cas.committed_marker_relpaths(root):
            read_io = ReadIO(path=marker)
            root.sync_read(read_io)
            metadata = SnapshotMetadata.from_json(bytes(read_io.buf).decode("utf-8"))
            for chunk_rel in sorted(cas.referenced_chunk_relpaths(metadata.manifest)):
                if chunk_rel in copied:
                    continue
                copied.add(chunk_rel)
                if store.sync_exists(chunk_rel):
                    stats["chunks_deduped"] += 1
                    continue
                src = ReadIO(path=chunk_rel)
                try:
                    root.sync_read(src)
                except FileNotFoundError:
                    # Migrated by an earlier interrupted run (the store
                    # holds it: checked above) or absent; nothing to copy.
                    continue
                store.sync_write(WriteIO(path=chunk_rel, buf=src.buf, durable=True))
                stats["chunks_copied"] += 1
                stats["bytes_copied"] += memoryview(src.buf).nbytes
            stats["steps"] += 1
        # Commit point: from here readers resolve the store first.
        write_store_pointer(root, store_url)
        for chunk_rel in cas.list_chunk_relpaths(root):
            try:
                root.sync_delete(chunk_rel)
                stats["local_chunks_removed"] += 1
            except Exception:  # noqa: BLE001 — left for a re-run or per-root gc
                pass
        # Drop the local cas/ tree only when every chunk really went (a
        # survivor is a failed delete or a concurrent writer).
        if not cas.list_chunk_relpaths(root):
            try:
                root.sync_delete_dir(cas.CAS_DIR)
            except Exception:  # noqa: BLE001 — an empty tree left is harmless
                pass
        cas.drop_index_sidecar(root)
    finally:
        try:
            root.sync_close()
        finally:
            store.sync_close()
    return stats
