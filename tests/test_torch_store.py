"""Shared multi-tenant chunk store of the port (torchsnapshot_tpu_torch.store):
mirrors of tests/test_store.py's identity, two-tenant, resolver, in-flight
marker, usage and migration cases (its sweep cases are in
test_torch_store_sweep.py).

The Prometheus half of the usage case waits for the port's metrics module.
Inputs are made from seeded numpy generators."""

import json
import socket
import time

import numpy as np
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


def _state(v, n=512):
    return {"m": StateDict({"w": torch.full((n,), float(v)), "step": v})}


def _zeros(n=512):
    return {"m": StateDict({"w": torch.zeros(n), "step": 0})}


def _mgr(root, store=None, max_to_keep=10):
    return SnapshotManager(str(root), max_to_keep=max_to_keep, store=str(store) if store else None)


def _with_plugin(url, fn):
    storage = url_to_storage_plugin(str(url))
    try:
        return fn(storage)
    finally:
        storage.sync_close()


def _chunks(store):
    return _with_plugin(store, cas_mod.list_chunk_relpaths)


def _restored_value(mgr):
    dst = _zeros()
    mgr.restore_latest(dst)
    return float(dst["m"]["w"][0])


# ----------------------------------------------------------------- identity


def test_tenant_identity_canonical(tmp_path):
    bare = str(tmp_path / "root")
    assert store_mod.canonical_root_url(bare) == f"fs://{bare}"
    assert store_mod.canonical_root_url(bare + "/") == f"fs://{bare}"
    assert store_mod.tenant_id(bare) == store_mod.tenant_id(f"fs://{bare}/")


def test_register_tenant_idempotent_across_spellings(tmp_path):
    bare = str(tmp_path / "root")

    def check(storage):
        tid1 = store_mod.register_tenant(storage, bare)
        tid2 = store_mod.register_tenant(storage, f"fs://{bare}/")
        assert tid1 == tid2
        assert list(store_mod.registered_tenants(storage)) == [tid1]

    _with_plugin(tmp_path / "store", check)


def test_store_pointer_roundtrip(tmp_path):
    def check(storage):
        assert store_mod.read_store_pointer(storage) is None
        store_mod.write_store_pointer(storage, "/some/store")
        assert store_mod.read_store_pointer(storage) == "/some/store"

    _with_plugin(tmp_path / "root", check)


# ------------------------------------------------------------- two tenants


def test_two_tenants_share_one_store(tmp_path):
    store = tmp_path / "store"
    ra, rb = tmp_path / "ra", tmp_path / "rb"
    ma, mb = _mgr(ra, store), _mgr(rb, store)
    ma.save(1, _state(1))
    mb.save(1, _state(1))  # identical content: the chunks are shared
    assert _chunks(store)
    assert not (ra / "cas").exists() and not (rb / "cas").exists()
    assert (ra / store_mod.STORE_POINTER_FNAME).exists()
    cls = store_mod.chunk_classification(str(store))
    assert cls["orphan"] == [] and cls["condemned"] == []
    assert sorted(cls["referenced"]) == sorted(_chunks(store))
    for mgr in (ma, mb):
        assert _restored_value(mgr) == 1.0


def test_classification_accounts_for_every_present_chunk(tmp_path):
    store = tmp_path / "store"
    _mgr(tmp_path / "ra", store).save(1, _state(1))
    _with_plugin(store, lambda s: s.sync_write(WriteIO(path="cas/xxh64/de/deadbeef", buf=b"junk", durable=True)))
    cls = store_mod.chunk_classification(str(store))
    assert sorted(cls["referenced"] + cls["orphan"]) == sorted(_chunks(store))
    assert "cas/xxh64/de/deadbeef" in cls["orphan"]


# ---------------------------------------------------------------- resolver


def _quarantine_chunk(store, chunk, epoch=3):
    """Condemn one chunk into a quarantine epoch by hand."""

    def move(storage):
        read_io = ReadIO(path=chunk)
        storage.sync_read(read_io)
        store_mod._write_json(
            storage,
            f"{store_mod.QUARANTINE_DIR}/{epoch}/{store_mod.CONDEMNED_FNAME}",
            {"epoch": epoch, "stamp": time.time()},
        )
        storage.sync_write(WriteIO(path=store_mod.quarantine_relpath(epoch, chunk), buf=read_io.buf, durable=True))
        storage.sync_delete(chunk)

    _with_plugin(store, move)


def test_resolver_resurrects_quarantined_chunk_on_read(tmp_path):
    store = tmp_path / "store"
    _mgr(tmp_path / "ra", store).save(1, _state(1))
    chunk = _chunks(store)[0]
    _quarantine_chunk(store, chunk)
    assert chunk not in _chunks(store)
    # A fresh manager's reader falls back into the quarantine, and the hit
    # resurrects the chunk durably.
    assert _restored_value(_mgr(tmp_path / "ra", store)) == 1.0
    assert chunk in _chunks(store)


def test_resolver_reports_quarantined_chunk_absent_to_writers(tmp_path):
    """A writer must see a quarantined chunk as ABSENT, so its dedup
    re-writes it into cas/ (the condemnation may go on to delete it)."""
    store = tmp_path / "store"
    _mgr(tmp_path / "ra", store).save(1, _state(1))
    chunk = _chunks(store)[0]
    _quarantine_chunk(store, chunk)
    resolver = store_mod.StoreResolver(url_to_storage_plugin(str(store)))
    try:
        assert not resolver.sync_exists(chunk)
    finally:
        resolver.sync_close()


def test_persisted_index_stale_after_foreign_sweep(tmp_path):
    """A persisted ``.digest_index.json`` entry whose chunk a foreign sweep
    removed must fail validation: the next take re-writes the chunk instead
    of referencing a missing one."""
    store = tmp_path / "store"
    root = tmp_path / "ra"
    _mgr(root, store).save(1, _state(1))
    before = _chunks(store)

    def delete_all(storage):
        for chunk in before:
            storage.sync_delete(chunk)

    _with_plugin(store, delete_all)  # no quarantine copy: the worst case
    assert _chunks(store) == []
    mb = _mgr(root, store)  # reloads the persisted index from the root
    mb.save(2, _state(1))
    assert _chunks(store)
    assert _restored_value(mb) == 1.0


# ------------------------------------------------------- in-flight markers


def test_marker_staleness_is_stamp_based(tmp_path):
    mgr = _mgr(tmp_path / "ra")
    base = {"name": ".inflight_step_1.json", "step": 1, "kind": "step"}

    def check(storage):
        # A foreign host's marker with a FRESH stamp is live: a pid means
        # nothing across hosts, only the stamp age condemns it.
        doc = dict(base, host="elsewhere", pid=1, stamp=time.time())
        assert not mgr._marker_stale(storage, doc)
        doc["stamp"] = time.time() - 99999
        assert mgr._marker_stale(storage, doc)
        # A stamp-less foreign marker stays live (force exists for it).
        assert not mgr._marker_stale(storage, dict(base, host="elsewhere", pid=1))
        # A local marker with a dead pid is stale whatever its stamp.
        assert mgr._marker_stale(storage, dict(base, host=socket.gethostname(), pid=2**22 + 1, stamp=time.time()))

    _with_plugin(tmp_path / "ra", check)


def test_inflight_marker_refreshes_stamp(tmp_path):
    """The save-time marker is a refreshed lease: its stamp advances while
    the save runs, so a hung but live writer stays protected."""
    mgr = _mgr(tmp_path / "ra")
    marker = tmp_path / "ra" / ".inflight_step_1.json"
    with knobs.override_lease_interval_s(0.05):
        mgr._write_inflight_marker(1, "step")
        doc1 = json.loads(marker.read_text())
        deadline = time.time() + 5.0
        doc2 = doc1
        while doc2["stamp"] <= doc1["stamp"] and time.time() < deadline:
            time.sleep(0.1)
            doc2 = json.loads(marker.read_text())
        mgr._remove_inflight_marker(1, "step")
    assert doc2["stamp"] > doc1["stamp"]
    assert not marker.exists()


# -------------------------------------------------------------------- quota


def test_tenant_usage_logical_vs_physical(tmp_path):
    store = tmp_path / "store"
    backbone = torch.from_numpy(np.frombuffer(np.random.RandomState(5).bytes(1 << 20), np.uint8).copy())
    with knobs.override_slab_size_threshold_bytes(1 << 18):
        for ti, root in enumerate((tmp_path / "ra", tmp_path / "rb")):
            head = torch.from_numpy(np.frombuffer(np.random.RandomState(100 + ti).bytes(1 << 18), np.uint8).copy())
            _mgr(root, store).save(1, {"ft": StateDict({"backbone": backbone, "head": head})})
    usage = store_mod.tenant_usage(str(store))
    assert len(usage["tenants"]) == 2
    # The shared backbone is stored once: physical < the summed logicals,
    # and each tenant's exclusive bytes (its head) are below its logical.
    assert usage["physical_bytes"] < usage["logical_bytes"]
    assert usage["dedup_ratio"] and usage["dedup_ratio"] > 1.2
    for doc in usage["tenants"].values():
        assert 0 < doc["exclusive_bytes"] < doc["logical_bytes"]


# ---------------------------------------------------------------- migration


def test_repack_into_store_migrates_and_restores(tmp_path):
    root = tmp_path / "legacy"
    with knobs.override_cas(True):
        mgr = SnapshotManager(str(root), max_to_keep=10)
        mgr.save(1, _state(1))
        mgr.save(2, _state(2))
    assert (root / "cas").exists()
    store = tmp_path / "store"
    stats = store_mod.repack_into_store(str(root), str(store))
    assert stats["steps"] == 2 and stats["chunks_copied"] >= 1
    assert stats["local_chunks_removed"] >= 1
    # The commit point: pointer written, local chunks gone, chunks in the
    # store, restores resolve store-first.
    assert _with_plugin(root, store_mod.read_store_pointer) == str(store)
    assert _chunks(store)
    assert _restored_value(SnapshotManager(str(root), max_to_keep=10)) == 2.0
    assert store_mod.chunk_classification(str(store))["orphan"] == []


def test_repack_into_store_refuses_foreign_sweep(tmp_path):
    root = tmp_path / "legacy"
    with knobs.override_cas(True):
        SnapshotManager(str(root), max_to_keep=10).save(1, _state(1))
    store = tmp_path / "store"
    lease = {"host": "elsewhere", "pid": 1, "phase": "condemn", "epoch": 1, "stamp": time.time()}
    _with_plugin(store, lambda s: store_mod._write_json(s, store_mod.SWEEP_LEASE_FNAME, lease))
    with pytest.raises(store_mod.StoreSweepBusyError):
        store_mod.repack_into_store(str(root), str(store))
    # The migration never reached its commit point: the root is local.
    assert _with_plugin(root, store_mod.read_store_pointer) is None
    assert _restored_value(SnapshotManager(str(root), max_to_keep=10)) == 1.0
