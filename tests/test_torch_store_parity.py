"""One shared chunk store, two packages: a tenant of torchsnapshot_tpu and a
tenant of torchsnapshot_tpu_torch share one store, in both orders.

Each case runs both directions wherever the order matters: tenant identity,
cross-tenant dedup of the same bytes and the store's accounting, restores
of the other package's store-backed root with no knob set, the writer
fence and the sweep lease held by one package against the other's sweep,
``repack_into_store`` of the other package's CAS root, and the keys of the
store's JSON documents.  Inputs are numpy arrays from a seed; restores are
bit-exact."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jax_pkg
import torchsnapshot_tpu_torch as port_pkg
from torchsnapshot_tpu import store as jax_store
from torchsnapshot_tpu.manager import SnapshotManager as JaxManager
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch import store as port_store
from torchsnapshot_tpu_torch.io_types import WriteIO
from torchsnapshot_tpu_torch.serialization import state_from_numpy
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

STORES = {"jax": jax_store, "port": port_store}
ORDERS = [("jax", "port"), ("port", "jax")]
ORPHAN = "cas/xxh64/de/deadbeef"


def _arrays(step=1):
    rng = np.random.default_rng(13)
    return {
        "w": rng.standard_normal((256, 64)).astype(np.float32),
        "b": rng.standard_normal(512).astype(np.float32),
        "opt": np.full(1024, float(step), np.float32),
        "step": step,
    }


def _app_state(pkg, arrays):
    if pkg == "port":
        return {"m": port_pkg.StateDict(state_from_numpy(dict(arrays)))}
    return {"m": jax_pkg.StateDict(dict(arrays))}


def _manager(pkg, root, store=None):
    cls = port_pkg.SnapshotManager if pkg == "port" else JaxManager
    return cls(str(root), max_to_keep=10, store=str(store) if store else None)


def _save(pkg, root, store, step=1):
    # Slabs off: every array is its own chunk in both packages.
    with knobs.override_slab_size_threshold_bytes(64):
        _manager(pkg, root, store).save(step, _app_state(pkg, _arrays(step)))


def _restore_snapshot(pkg, path, step=1):
    """Restore ``path`` through ``pkg`` with no knob set; bit-exact."""
    want = _arrays(step)
    zeros = {k: np.zeros_like(v) if isinstance(v, np.ndarray) else -1 for k, v in want.items()}
    dst = _app_state(pkg, zeros)
    if pkg == "port":
        ptrs = {k: v.data_ptr() for k, v in dst["m"].items() if isinstance(v, torch.Tensor)}
        port_pkg.Snapshot(str(path)).restore(dst)
        assert all(dst["m"][k].data_ptr() == p for k, p in ptrs.items())
    else:
        jax_pkg.Snapshot(str(path)).restore(dst)
    for k, v in want.items():
        got = dst["m"][k]
        if isinstance(v, np.ndarray):
            got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
            assert got.tobytes() == v.tobytes(), k
        else:
            assert got == v, k


def _chunk_files(store):
    """{chunk relpath: (inode, mtime_ns)}: a durable rewrite replaces the
    inode, so an unchanged map means no chunk was written."""
    out = {}
    for dirpath, _, files in os.walk(os.path.join(str(store), "cas")):
        for name in files:
            st = os.stat(os.path.join(dirpath, name))
            out[os.path.relpath(os.path.join(dirpath, name), str(store))] = (st.st_ino, st.st_mtime_ns)
    return out


def _write_orphan(store):
    storage = url_to_storage_plugin(str(store))
    try:
        storage.sync_write(WriteIO(path=ORPHAN, buf=b"junk", durable=True))
    finally:
        storage.sync_close()


def test_tenant_identity_agrees(tmp_path):
    bare = str(tmp_path / "x")
    for spelling in (bare, f"fs://{bare}", bare + "/"):
        assert port_store.canonical_root_url(spelling) == jax_store.canonical_root_url(spelling) == f"fs://{bare}"
        assert port_store.tenant_id(spelling) == jax_store.tenant_id(spelling) == jax_store.tenant_id(bare)


@pytest.mark.parametrize("first,second", ORDERS)
def test_second_tenant_writes_no_chunk_and_accounting_agrees(tmp_path, first, second):
    store = tmp_path / "store"
    _save(first, tmp_path / "ra", store)
    before = _chunk_files(store)
    assert len(before) == 3
    _save(second, tmp_path / "rb", store)
    assert _chunk_files(store) == before
    results = {}
    for pkg, mod in STORES.items():
        results[pkg] = (mod.chunk_classification(str(store)), mod.tenant_usage(str(store)))
    assert results["port"] == results["jax"]
    cls, usage = results["port"]
    assert sorted(cls["referenced"]) == sorted(before) and cls["orphan"] == cls["condemned"] == []
    assert usage["dedup_ratio"] == 2.0 and len(usage["tenants"]) == 2
    assert all(t["exclusive_bytes"] == 0 for t in usage["tenants"].values())


@pytest.mark.parametrize("writer,reader", ORDERS)
def test_restore_of_the_other_packages_store_backed_root(tmp_path, writer, reader):
    """No knob set: the reader finds the chunks through the root's .store
    pointer (its own root holds none)."""
    store, root = tmp_path / "store", tmp_path / "root"
    _save(writer, root, store, step=4)
    assert not (root / "cas").exists()
    _restore_snapshot(reader, root / "step_4", step=4)
    dst = _app_state(reader, {k: np.zeros_like(v) if isinstance(v, np.ndarray) else -1
                              for k, v in _arrays(4).items()})
    assert _manager(reader, root).restore_latest(dst) == 4


@pytest.mark.parametrize("holder,sweeper", ORDERS)
def test_writer_lease_of_one_package_fences_the_others_delete_phase(tmp_path, holder, sweeper):
    store, root = tmp_path / "store", tmp_path / "ra"
    _save(sweeper, root, store)
    _write_orphan(store)
    storage = (url_to_storage_plugin if holder == "port" else jax_pkg.storage_plugin.url_to_storage_plugin)(str(store))
    ctx = STORES[holder].StoreWriterContext(storage, str(store), str(tmp_path / "writer"))
    ctx.start()
    try:
        with knobs.override_store_quarantine_s(0.0):
            report = STORES[sweeper].sweep(str(store))
        assert report["condemned"] == [ORPHAN] and report["deleted"] == []
        assert report["deferred_epochs"] == [report["epoch"]]
    finally:
        ctx.close()
        storage.sync_close()
    with knobs.override_store_quarantine_s(0.0):
        report = STORES[sweeper].sweep(str(store))
    assert report["deleted"] == [ORPHAN] and report["deferred_epochs"] == []


_CHILD_SWEEP = """
import os, sys
import importlib
store_mod = importlib.import_module(sys.argv[1] + ".store")
store_mod.sweep(sys.argv[2])
os._exit(7)  # never reached: the crash fault fires mid-sweep
"""


@pytest.mark.parametrize("holder,sweeper", ORDERS)
def test_live_sweep_lease_of_one_package_makes_the_others_sweep_busy(tmp_path, holder, sweeper):
    """A sweep of ``holder``'s package killed right after taking its lease
    (crash fault on the epoch bump, in a child process) leaves a live lease:
    the other package's sweep raises until the lease goes stale, then
    adopts it."""
    store = tmp_path / "store"
    _save(sweeper, tmp_path / "ra", store)
    package = "torchsnapshot_tpu_torch" if holder == "port" else "torchsnapshot_tpu"
    env = dict(os.environ, JAX_PLATFORMS="cpu", TPUSNAP_FAULTS="ledger:3:crash@sweep/epoch.json",
               TPUSNAP_LEASE_INTERVAL_S="9999")
    proc = subprocess.run([sys.executable, "-c", _CHILD_SWEEP, package, str(store)], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr[-2000:]
    with pytest.raises(STORES[sweeper].StoreSweepBusyError):
        STORES[sweeper].sweep(str(store))
    with knobs.override_lease_interval_s(0.05), knobs.override_lease_grace_s(0.3), knobs.override_store_quarantine_s(
        0.0
    ):
        time.sleep(0.6)
        assert STORES[sweeper].sweep(str(store))["adopted_lease"]
    assert not (store / port_store.SWEEP_LEASE_FNAME).exists()


@pytest.mark.parametrize("writer,migrator", ORDERS)
def test_repack_into_store_of_the_other_packages_root(tmp_path, writer, migrator):
    root, store = tmp_path / "legacy", tmp_path / "store"
    with knobs.override_cas(True), knobs.override_slab_size_threshold_bytes(64):
        for step in (1, 2):
            _manager(writer, root).save(step, _app_state(writer, _arrays(step)))
    stats = STORES[migrator].repack_into_store(str(root), str(store))
    assert stats["steps"] == 2 and stats["chunks_copied"] == 4 and stats["local_chunks_removed"] == 4
    assert not (root / "cas").exists()
    for pkg in ("jax", "port"):
        for step in (1, 2):
            _restore_snapshot(pkg, root / f"step_{step}", step=step)
    assert port_store.chunk_classification(str(store))["orphan"] == []


def _store_documents(pkg, tmp_path):
    """{document kind: sorted keys} of every JSON document ``pkg`` writes
    in a store and its tenant root."""
    store, root = tmp_path / pkg / "store", tmp_path / pkg / "root"
    mod = STORES[pkg]
    _save(pkg, root, store)
    _write_orphan(store)
    with knobs.override_store_quarantine_s(3600.0):
        mod.sweep(str(store))  # condemns the orphan: epoch and .condemned
    docs = {}

    def keys(path):
        with open(path) as f:
            return sorted(json.load(f))

    docs["pointer"] = keys(root / ".store")
    (tenant,) = os.listdir(store / "tenants")
    docs["tenant"] = keys(store / "tenants" / tenant)
    ledger = store / "ledger" / tenant[: -len(".json")]
    docs["ledger"] = sorted({tuple(keys(ledger / n)) for n in os.listdir(ledger)})
    docs["epoch"] = keys(store / "sweep" / "epoch.json")
    (epoch,) = os.listdir(store / "quarantine")
    docs["condemned"] = keys(store / "quarantine" / epoch / ".condemned")
    storage = (url_to_storage_plugin if pkg == "port" else jax_pkg.storage_plugin.url_to_storage_plugin)(str(store))
    try:
        ctx = mod.StoreWriterContext(storage, str(store), str(root))
        ctx.start()
        try:
            (lease,) = os.listdir(store / "leases")
            docs["writer_lease"] = keys(store / "leases" / lease)
        finally:
            ctx.close()
        sweep_lease = mod._SweepLease(storage)
        sweep_lease.acquire()
        try:
            docs["sweep_lease"] = keys(store / "sweep" / "lease.json")
        finally:
            sweep_lease.release()
    finally:
        storage.sync_close()
    return docs


def test_store_documents_have_the_same_keys_in_both_packages(tmp_path):
    jax_docs, port_docs = _store_documents("jax", tmp_path), _store_documents("port", tmp_path)
    assert port_docs == jax_docs
    assert jax_docs["ledger"] == [("chunks", "epoch", "host", "pid", "stamp", "tenant")]
