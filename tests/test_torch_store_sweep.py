"""The shared store's two-phase sweep in the port (torchsnapshot_tpu_torch.store):
mirrors of tests/test_store.py's sweep cases — condemn then delete, the
delete phase's resurrection, the sweep lease, the writer fence, ledger
protection and the manager's gc routing.  Inputs are made from seeded
numpy generators."""

import time

import pytest
import torch

from torchsnapshot_tpu_torch import StateDict, knobs
from torchsnapshot_tpu_torch import cas as cas_mod
from torchsnapshot_tpu_torch import store as store_mod
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.manager import SnapshotManager
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

ORPHAN = "cas/xxh64/de/deadbeef"
FOREIGN_TID = "feedc0de00000000"


def _state(v):
    return {"m": StateDict({"w": torch.full((512,), float(v)), "step": v})}


def _mgr(root, store):
    return SnapshotManager(str(root), max_to_keep=10, store=str(store))


def _with_plugin(url, fn):
    storage = url_to_storage_plugin(str(url))
    try:
        return fn(storage)
    finally:
        storage.sync_close()


def _chunks(store):
    return _with_plugin(store, cas_mod.list_chunk_relpaths)


def _quarantined(store):
    return _with_plugin(store, store_mod.quarantined_chunk_relpaths)


def _write_orphan(store, relpath=ORPHAN):
    _with_plugin(store, lambda s: s.sync_write(WriteIO(path=relpath, buf=b"junk", durable=True)))


def _restored_value(mgr):
    dst = {"m": StateDict({"w": torch.zeros(512), "step": 0})}
    mgr.restore_latest(dst)
    return float(dst["m"]["w"][0])


def test_sweep_two_phase_condemn_then_delete(tmp_path):
    store = tmp_path / "store"
    ma = _mgr(tmp_path / "ra", store)
    ma.save(1, _state(1))
    _write_orphan(store)
    # Phase 1 under a long grace: condemned (moved into the quarantine),
    # not deleted, and gone from the cas/ listing.
    with knobs.override_store_quarantine_s(3600.0):
        report = store_mod.sweep(str(store))
    assert ORPHAN in report["condemned"] and report["deleted"] == []
    assert ORPHAN not in _chunks(store)
    assert ORPHAN in _quarantined(store)
    # Phase 2 past the grace: deleted from the quarantine.
    with knobs.override_store_quarantine_s(0.0):
        report = store_mod.sweep(str(store))
    assert ORPHAN in report["deleted"]
    assert ORPHAN not in _quarantined(store)
    cls = store_mod.chunk_classification(str(store))
    assert cls["orphan"] == [] and cls["condemned"] == []
    assert _restored_value(ma) == 1.0


def test_delete_phase_restores_rereferenced_chunk(tmp_path):
    """A chunk condemned mid-take whose commit references it now must be
    RESTORED by the delete phase, not deleted."""
    store = tmp_path / "store"
    ma = _mgr(tmp_path / "ra", store)
    ma.save(1, _state(1))
    chunk = _chunks(store)[0]

    def condemn_past_grace(storage):
        # A condemnation that raced a committing take: the chunk sits in
        # the quarantine (its grace passed) while a manifest references it.
        read_io = ReadIO(path=chunk)
        storage.sync_read(read_io)
        store_mod._write_json(
            storage,
            f"{store_mod.QUARANTINE_DIR}/7/{store_mod.CONDEMNED_FNAME}",
            {"epoch": 7, "stamp": time.time() - 9999},
        )
        storage.sync_write(WriteIO(path=store_mod.quarantine_relpath(7, chunk), buf=read_io.buf, durable=True))
        storage.sync_delete(chunk)

    _with_plugin(store, condemn_past_grace)
    with knobs.override_store_quarantine_s(0.0):
        report = store_mod.sweep(str(store))
    assert chunk in report["restored"] and chunk not in report["deleted"]
    assert chunk in _chunks(store)
    assert _restored_value(ma) == 1.0


def _write_sweep_lease(store, stamp, phase):
    doc = {"host": "elsewhere", "pid": 1, "phase": phase, "epoch": 1, "stamp": stamp}
    _with_plugin(store, lambda s: store_mod._write_json(s, store_mod.SWEEP_LEASE_FNAME, doc))


def test_sweep_busy_on_fresh_foreign_lease_and_adoption(tmp_path):
    store = tmp_path / "store"
    _mgr(tmp_path / "ra", store).save(1, _state(1))
    _write_sweep_lease(store, time.time(), "condemn")
    with pytest.raises(store_mod.StoreSweepBusyError):
        store_mod.sweep(str(store))
    # force adopts even a fresh foreign lease (the operator knows it died).
    assert store_mod.sweep(str(store), force=True)["adopted_lease"]
    # A STALE foreign lease is adopted without force.
    _write_sweep_lease(store, time.time() - 9999, "delete")
    assert store_mod.sweep(str(store))["adopted_lease"]


def test_writer_fence_defers_delete_phase(tmp_path):
    """No quarantine epoch E is deleted while a fresh writer lease has
    observed_epoch <= E: that writer may hold pre-condemn dedup decisions
    no journal records yet."""
    store = tmp_path / "store"
    _mgr(tmp_path / "ra", store).save(1, _state(1))
    _write_orphan(store)
    lease = {"tenant": FOREIGN_TID, "root": "/nowhere", "host": "elsewhere", "pid": 1, "epoch": 0,
             "stamp": time.time()}
    lease_path = store_mod.writer_lease_relpath(FOREIGN_TID, 1)
    _with_plugin(store, lambda s: store_mod._write_json(s, lease_path, lease))
    with knobs.override_store_quarantine_s(0.0):
        report = store_mod.sweep(str(store))
    assert ORPHAN in report["condemned"]
    assert report["deferred_epochs"] and ORPHAN not in report["deleted"]
    # The writer finishes (its lease goes): the next delete phase runs.
    _with_plugin(store, lambda s: s.sync_delete(lease_path))
    with knobs.override_store_quarantine_s(0.0):
        report = store_mod.sweep(str(store))
    assert ORPHAN in report["deleted"]


def test_ledger_protects_until_reaped(tmp_path):
    """A reference journal protects its chunks while its writer's lease is
    fresh or the entry is young; past both it is reaped, and the chunks
    (uncommitted debris) become sweepable."""
    store = tmp_path / "store"
    _mgr(tmp_path / "ra", store).save(1, _state(1))
    debris = "cas/xxh64/ab/abad1dea"
    _write_orphan(store, debris)
    entry_path = f"{store_mod.LEDGER_DIR}/{FOREIGN_TID}/refs_1_1_1.json"

    def entry(stamp):
        # A crashed writer's journal: the entry is there, its lease is not.
        return {"tenant": FOREIGN_TID, "pid": 1, "host": "elsewhere", "epoch": 0, "stamp": stamp,
                "chunks": [debris]}

    def check(storage):
        store_mod._write_json(storage, entry_path, entry(time.time()))
        assert debris in store_mod.ledger_protected_chunks(storage)  # young: protected
        store_mod._write_json(storage, entry_path, entry(time.time() - 99999))
        assert debris not in store_mod.ledger_protected_chunks(storage)

    _with_plugin(store, check)
    with knobs.override_store_quarantine_s(0.0):
        report = store_mod.sweep(str(store))
    assert debris in report["condemned"]
    assert report["ledgers_reaped"] >= 1


def test_manager_gc_routes_store_sweep(tmp_path):
    store = tmp_path / "store"
    ma = _mgr(tmp_path / "ra", store)
    ma.save(1, _state(1))
    _write_orphan(store)
    # The dry run names the store's orphan as a chunk candidate.
    _, chunks, _ = ma.gc_detail(apply=False)
    assert ORPHAN in chunks
    with knobs.override_store_quarantine_s(0.0):
        _, swept, _ = ma.gc_detail(apply=True)
        assert ORPHAN in swept
        ma.gc_detail(apply=True)  # condemned above; this apply deletes it
    assert ORPHAN not in _chunks(store)
    assert ORPHAN not in _quarantined(store)
