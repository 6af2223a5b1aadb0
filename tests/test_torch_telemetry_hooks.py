"""The port's metrics at the storage-format, manager, store and serving
sites: the metrics halves of the JAX package's test_cas.py (dedup),
test_journal.py (compaction counters; a crashed fold's recovery counts no
fallback), test_store.py (tenant usage in the Prometheus text) and
test_serve.py (cache hits and misses), plus the journal fallback and the
store sweep's gc kinds.  Counter values are compared exactly."""

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, SnapshotManager, StateDict, journal, knobs
from torchsnapshot_tpu_torch import store as store_mod
from torchsnapshot_tpu_torch.io_types import WriteIO
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
from torchsnapshot_tpu_torch.telemetry import metrics

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

FROZEN = np.random.RandomState(0).rand(65536).astype(np.float32)


@pytest.fixture(autouse=True)
def metrics_on():
    metrics.uninstall_event_bridge()
    metrics.reset()
    with knobs.override_metrics(True):
        yield
    metrics.uninstall_event_bridge()
    metrics.reset()


@pytest.fixture
def journal_env():
    """Small slabs so distinct leaves stay distinct chunks, sidecars off."""
    with knobs.override_sidecar(False), knobs.override_slab_size_threshold_bytes(64), knobs.override_retry_base_s(
        0.001
    ):
        yield


def _journal_state(v, frozen=None):
    d = {"hot": torch.full((128,), float(v)), "step": v, "extra": torch.full((16,), 7.0)}
    if frozen is not None:
        d["frozen"] = frozen.clone()
    return {"m": StateDict(d)}


def _journal_zeros(frozen=None):
    st = _journal_state(0, frozen)
    for v in st["m"].values():
        if isinstance(v, torch.Tensor):
            v.zero_()
    return st


def test_dedup_metrics(tmp_path):
    """A CAS manager's second save dedups the frozen leaf: hits and saved
    bytes counted, and the cas.dedup event carries the same numbers."""
    from torchsnapshot_tpu_torch import event_handlers

    events = []
    event_handlers.register_event_handler(events.append)
    try:
        mgr = SnapshotManager(str(tmp_path / "ckpts"))
        with knobs.override_cas(True), knobs.override_batching_disabled(True):
            for v in (1, 2):
                mgr.save(v, {"m": StateDict({"frozen": torch.from_numpy(FROZEN.copy()), "opt": torch.full((4096,), float(v))})})
    finally:
        event_handlers.unregister_event_handler(events.append)
    hits = metrics.counter("tpusnap_cas_dedup_hits_total").get()
    saved = metrics.counter("tpusnap_cas_dedup_bytes_saved_total").get()
    assert hits >= 1 and saved >= FROZEN.nbytes
    dedup = [e.metadata for e in events if e.name == "cas.dedup"]
    assert sum(d["dedup_hits"] for d in dedup) == hits
    assert sum(d["dedup_bytes_saved"] for d in dedup) == saved


def test_compaction_folds_segments_counted(tmp_path, journal_env):
    frozen = torch.arange(4096, dtype=torch.float32)
    root = str(tmp_path / "ckpts")
    with knobs.override_journal_max_segments(3):
        mgr = SnapshotManager(root, journal=True)
        for step in range(1, 8):
            mgr.save(step, _journal_state(step, frozen))
    # 1 is the base; segments 2-4 fold into step_4, then 5-7 into step_7.
    assert mgr.all_steps() == [1, 4, 7]
    text = metrics.render_prometheus()
    assert "tpusnap_journal_compactions_total 2" in text
    assert "tpusnap_journal_segments_total 6" in text
    assert "tpusnap_journal_folded_segments_total 6" in text
    dst = _journal_zeros(torch.zeros(4096))
    assert mgr.restore_at(4, dst) == 4
    assert torch.equal(dst["m"]["hot"], torch.full((128,), 4.0))


def test_crashed_compaction_recovery_counts_no_fallback(tmp_path, journal_env):
    """The full step wins the tie at step 3 even with its subsumed
    segment's chain broken: no fallback is counted."""
    root = str(tmp_path / "ckpts")
    with knobs.override_journal_max_segments(100):
        mgr = SnapshotManager(root, journal=True)
        for step in (1, 2, 3):
            mgr.save(step, _journal_state(step))
        storage = url_to_storage_plugin(root)
        try:
            merged, _ = journal.merged_metadata(storage, 3)
            storage.sync_write(
                WriteIO(path="step_3/.snapshot_metadata", buf=merged.to_json().encode("utf-8"), durable=True)
            )
        finally:
            storage.sync_close()
    (tmp_path / "ckpts" / "seg_2" / ".snapshot_metadata").write_text("{bad")
    metrics.reset()
    dst = _journal_zeros()
    assert SnapshotManager(root, journal=True).restore_latest(dst) == 3
    text = metrics.render_prometheus()
    assert "tpusnap_journal_fallbacks_total" not in text
    assert "tpusnap_restore_fallbacks_total" not in text
    assert torch.equal(dst["m"]["hot"], torch.full((128,), 3.0))


def test_replay_fallback_counted_once_on_both_counters(tmp_path, journal_env):
    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root, journal=True)
    for step in (1, 2, 3):
        mgr.save(step, _journal_state(step))
    (tmp_path / "ckpts" / "seg_3" / ".snapshot_metadata").write_text("{bad")
    assert mgr.restore_latest(_journal_zeros()) == 2
    restore_fb = metrics.counter("tpusnap_restore_fallbacks_total")
    journal_fb = metrics.counter("tpusnap_journal_fallbacks_total")
    assert sum(c.value for c in restore_fb._children.values()) == 1
    assert sum(c.value for c in journal_fb._children.values()) == 1
    assert list(restore_fb._children) == list(journal_fb._children)


def test_tenant_usage_in_prometheus_and_sweep_gc_kinds(tmp_path):
    """Two tenants sharing a backbone: per-tenant and ``_total`` gauges in
    the Prometheus text; an orphan chunk condemned, then deleted: one gc
    action of each kind."""
    store = tmp_path / "store"
    backbone = torch.from_numpy(np.frombuffer(np.random.RandomState(5).bytes(1 << 20), np.uint8).copy())
    with knobs.override_slab_size_threshold_bytes(1 << 18):
        for ti, root in enumerate((tmp_path / "ra", tmp_path / "rb")):
            head = torch.from_numpy(np.frombuffer(np.random.RandomState(100 + ti).bytes(1 << 18), np.uint8).copy())
            SnapshotManager(str(root), store=str(store)).save(1, {"ft": StateDict({"backbone": backbone, "head": head})})
    usage = store_mod.tenant_usage(str(store))
    store_mod.publish_usage_metrics(usage)
    text = metrics.render_prometheus()
    assert "# TYPE tpusnap_store_logical_bytes gauge" in text
    assert "# TYPE tpusnap_store_physical_bytes gauge" in text
    assert f'tpusnap_store_logical_bytes{{tenant="_total"}} {usage["logical_bytes"]}' in text
    assert f'tpusnap_store_physical_bytes{{tenant="_total"}} {usage["physical_bytes"]}' in text
    for tid, doc in usage["tenants"].items():
        assert f'tpusnap_store_physical_bytes{{tenant="{tid}"}} {doc["exclusive_bytes"]}' in text

    # An orphan chunk: condemned by a sweep under a long grace, deleted
    # by the next one past it.
    orphan = "cas/xxh64/de/deadbeefdeadbeef"
    storage = url_to_storage_plugin(str(store))
    try:
        storage.sync_write(WriteIO(path=orphan, buf=b"junk", durable=True))
    finally:
        storage.sync_close()
    with knobs.override_store_quarantine_s(3600.0):
        condemned = store_mod.sweep(str(store))["condemned"]
    with knobs.override_store_quarantine_s(0.0):
        deleted = store_mod.sweep(str(store))["deleted"]
    assert condemned == deleted == [orphan]
    gc = metrics.counter("tpusnap_gc_actions_total")
    assert gc.get(kind="chunk_condemned") == 1 and gc.get(kind="chunk_removed") == 1


def test_cache_metrics(tmp_path):
    arrays = {f"w{i}": np.frombuffer(np.random.RandomState(i).bytes(1 << 20), np.uint8).copy() for i in range(4)}
    path = str(tmp_path / "root" / "step_1")
    snap = Snapshot.take(path, {"m": StateDict({k: torch.from_numpy(v.copy()) for k, v in arrays.items()})})
    with knobs.override_cache_dir(str(tmp_path / "cache")):
        for _ in range(2):
            snap.restore({"m": StateDict({k: torch.zeros(v.shape, dtype=torch.uint8) for k, v in arrays.items()})})
    assert metrics.counter("tpusnap_cache_misses_total").get() > 0
    assert metrics.counter("tpusnap_cache_hits_total").get() == metrics.counter("tpusnap_cache_misses_total").get()
    assert metrics.counter("tpusnap_cache_hit_bytes_total").get() == 4 << 20
    assert metrics.counter("tpusnap_cache_miss_bytes_total").get() == 4 << 20
