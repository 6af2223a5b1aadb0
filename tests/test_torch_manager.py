"""SnapshotManager of torchsnapshot_tpu_torch: step discovery, retention,
resume, refcounted chunk reclamation and gc.

Mirrors of tests/test_manager.py (the S3 and GCS cases wait for the object
stores), tests/test_incremental.py:159, tests/test_cas.py:130, :164 and
:340, and tests/test_cdc.py:328.  Values are made from seeds with numpy;
where the JAX package's manager runs the same sequence on the same inputs,
its outcome is the expectation."""

import contextlib
import glob
import json
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, event_handlers, faults, knobs
from torchsnapshot_tpu_torch.manager import SnapshotManager
from torchsnapshot_tpu_torch.manifest import CAS_MANIFEST_VERSION
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin
from torchsnapshot_tpu_torch.telemetry import sidecar

from torch_env import default_knob_env  # noqa: F401  autouse fixture


def _state(v):
    return {"m": StateDict({"w": torch.full((8,), float(v)), "step": v})}


def test_save_restore_latest(tmp_path):
    mgr = SnapshotManager(str(tmp_path / "ckpts"))
    assert mgr.latest_step() is None
    assert mgr.restore_latest(_state(0)) is None

    mgr.save(10, _state(10))
    mgr.save(20, _state(20))
    assert mgr.all_steps() == [10, 20]
    assert mgr.latest_step() == 20

    dst = _state(0)
    ptr = dst["m"]["w"].data_ptr()
    assert mgr.restore_latest(dst) == 20
    assert torch.equal(dst["m"]["w"], torch.full((8,), 20.0))
    assert dst["m"]["w"].data_ptr() == ptr
    assert dst["m"]["step"] == 20


@pytest.mark.parametrize("package", ["jax", "port"])
def test_retention(tmp_path, package):
    """Both managers keep the same two newest steps of the same sequence."""
    if package == "jax":
        from torchsnapshot_tpu import StateDict as JaxStateDict
        from torchsnapshot_tpu.manager import SnapshotManager as JaxManager

        mgr = JaxManager(str(tmp_path / "ckpts"), max_to_keep=2)
        for step in (1, 2, 3, 4):
            mgr.save(step, {"m": JaxStateDict({"w": np.full((8,), float(step), np.float32), "step": step})})
    else:
        mgr = SnapshotManager(str(tmp_path / "ckpts"), max_to_keep=2)
        for step in (1, 2, 3, 4):
            mgr.save(step, _state(step))
    assert mgr.all_steps() == [3, 4]
    assert not (tmp_path / "ckpts" / "step_1").exists()
    # survivors still restore, through the port
    dst = _state(0)
    Snapshot(str(tmp_path / "ckpts" / "step_3")).restore(dst)
    assert dst["m"]["step"] == 3
    assert torch.equal(dst["m"]["w"], torch.full((8,), 3.0))


def test_torn_snapshot_ignored(tmp_path):
    mgr = SnapshotManager(str(tmp_path / "ckpts"))
    mgr.save(5, _state(5))
    torn = tmp_path / "ckpts" / "step_9"
    torn.mkdir(parents=True)
    (torn / "0%2Fm%2Fw").write_bytes(b"junk")
    assert mgr.all_steps() == [5]
    assert mgr.latest_step() == 5
    assert mgr.orphan_steps() == [9]


def test_async_save_manager(tmp_path):
    mgr = SnapshotManager(str(tmp_path / "ckpts"), max_to_keep=1)
    pending = mgr.save(7, _state(7), async_=True)
    snapshot = pending.wait()
    assert mgr.latest_step() == 7
    dst = _state(0)
    snapshot.restore(dst)
    assert dst["m"]["step"] == 7
    assert mgr.inflight_markers() == []


def test_async_retention_keeps_prior_until_commit(tmp_path):
    """An in-flight async snapshot must not cause deletion of the only
    committed restore point."""
    mgr = SnapshotManager(str(tmp_path / "ckpts"), max_to_keep=1)
    mgr.save(6, _state(6))
    pending = mgr.save(7, _state(7), async_=True)
    assert 6 in mgr.all_steps()
    pending.wait()
    mgr.save(8, _state(8))
    assert mgr.all_steps() == [8]


def test_max_to_keep_validation(tmp_path):
    with pytest.raises(ValueError):
        SnapshotManager(str(tmp_path), max_to_keep=0)


def test_manager_on_memory_backend():
    MemoryStoragePlugin.reset()
    try:
        mgr = SnapshotManager("memory://mgr_mem", max_to_keep=2)
        for step in (1, 2, 3):
            mgr.save(step, _state(step))
        assert mgr.all_steps() == [2, 3]  # retention pruned step 1
        dst = _state(0)
        assert mgr.restore_latest(dst) == 3
        assert dst["m"]["step"] == 3
    finally:
        MemoryStoragePlugin.reset()


def test_manager_incremental_chain(tmp_path):
    """Mirror of tests/test_incremental.py:159: incremental saves hard-link
    the frozen payload, and pruning the step that first held it leaves the
    survivors whole."""
    frozen = torch.from_numpy(np.random.RandomState(2).rand(256).astype(np.float32))
    mgr = SnapshotManager(str(tmp_path / "ckpts"), max_to_keep=2)
    with knobs.override_batching_disabled(True):
        for step in (1, 2, 3):
            state = {"m": StateDict({"frozen": frozen.clone(), "hot": torch.full((64,), float(step))})}
            mgr.save(step, state, incremental=(step > 1))
    assert mgr.all_steps() == [2, 3]
    loc = "0/m/frozen"
    assert os.stat(tmp_path / "ckpts" / "step_2" / loc).st_ino == os.stat(tmp_path / "ckpts" / "step_3" / loc).st_ino
    for step in (2, 3):
        dst = {"m": StateDict({"frozen": torch.zeros(256), "hot": torch.zeros(64)})}
        mgr.snapshot(step).restore(dst)
        assert torch.equal(dst["m"]["frozen"], frozen)
        assert torch.equal(dst["m"]["hot"], torch.full((64,), float(step)))


# ------------------------------------------------ content-addressed roots

FROZEN = torch.from_numpy(np.random.RandomState(0).rand(65536).astype(np.float32))


def _cas_state(v):
    return {"m": StateDict({"frozen": FROZEN.clone(), "opt": torch.full((4096,), float(v))})}


def _chunk_files(root):
    return sorted(glob.glob(os.path.join(str(root), "cas", "*", "*", "*")))


def _assert_cas_roundtrip(mgr, step):
    dst = {"m": StateDict({"frozen": torch.zeros(65536), "opt": torch.zeros(4096)})}
    mgr.snapshot(step).restore(dst)
    assert torch.equal(dst["m"]["frozen"], FROZEN)
    assert torch.equal(dst["m"]["opt"], torch.full((4096,), float(step)))


def test_prune_reclaims_only_unshared_chunks(tmp_path):
    """Pruning a base step deletes only chunks no surviving committed
    manifest references, and never breaks a later step that deduped
    against it (tests/test_cas.py:130)."""
    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root, max_to_keep=2)
    with knobs.override_cas(True), knobs.override_batching_disabled(True):
        mgr.save(1, _cas_state(1))
        mgr.save(2, _cas_state(2))
        chunks_before = set(_chunk_files(root))
        mgr.save(3, _cas_state(3))  # prunes step_1
    assert mgr.all_steps() == [2, 3]
    chunks_after = set(_chunk_files(root))
    removed = chunks_before - chunks_after
    assert len(removed) == 1
    assert len([c for c in chunks_after if os.path.getsize(c) == FROZEN.nbytes]) == 1
    for step in (2, 3):
        _assert_cas_roundtrip(mgr, step)
    mgr.gc(apply=True)
    assert set(_chunk_files(root)) == chunks_after
    referenced, orphan = mgr.chunk_classification()
    assert orphan == [] and len(referenced) == len(chunks_after)


def test_gc_sweeps_crashed_take_orphan_chunks(tmp_path):
    """A take whose commit is torn leaves its new chunks orphaned; gc
    reports exactly them dry and sweeps exactly them applied
    (tests/test_cas.py:164)."""
    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root)
    with knobs.override_cas(True), knobs.override_batching_disabled(True):
        mgr.save(1, _cas_state(1))
        with knobs.override_retry_base_s(0.001), knobs.override_faults("write:1+:terminal@.snapshot_metadata"):
            with pytest.raises(faults.FaultInjectionError):
                mgr.save(2, _cas_state(2))
    referenced, orphan = mgr.chunk_classification()
    assert orphan, "the crashed take's unreferenced chunk should be orphan"
    _, dry_chunks, _ = mgr.gc_detail(apply=False)
    assert dry_chunks == orphan
    _, swept, _ = mgr.gc_detail(apply=True)
    assert swept == orphan
    referenced2, orphan2 = mgr.chunk_classification()
    assert orphan2 == [] and set(referenced2) == set(referenced)
    _assert_cas_roundtrip(mgr, 1)


def test_async_take_dedups_and_restores(tmp_path):
    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root)
    with knobs.override_cas(True), knobs.override_batching_disabled(True):
        mgr.save(1, _cas_state(1))
        mgr.save(2, _cas_state(2), async_=True).wait()
    assert len([c for c in _chunk_files(root) if os.path.getsize(c) == FROZEN.nbytes]) == 1
    assert mgr.snapshot(2).metadata.version == CAS_MANIFEST_VERSION
    _assert_cas_roundtrip(mgr, 2)


def test_sidecar_records_logical_vs_physical(tmp_path):
    """tests/test_cas.py:340: the take's sidecar carries the CAS writer's
    logical and physical bytes, and its summary line the dedup ratio."""
    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root)
    with knobs.override_cas(True), knobs.override_batching_disabled(True):
        mgr.save(1, _cas_state(1))
        mgr.save(2, _cas_state(2))
    storage = url_to_storage_plugin(f"{root}/step_2")
    try:
        docs = [d for d in sidecar.read_all(storage) if d.get("action") == "take"]
    finally:
        storage.sync_close()
    assert docs and "cas" in docs[0]
    stats = docs[0]["cas"]
    assert stats["dedup_hits"] >= 1
    assert stats["logical_bytes"] == stats["physical_bytes_written"] + stats["dedup_bytes_saved"]
    assert "dedup=" in sidecar.summarize(docs[0])


def _cdc_env():
    stack = contextlib.ExitStack()
    stack.enter_context(knobs.override_cas(True))
    stack.enter_context(knobs.override_cdc(True))
    stack.enter_context(knobs.override_cdc_params(1024, 4096, 16384))
    stack.enter_context(knobs.override_slab_size_threshold_bytes(1 << 20))
    return stack


def _leaves(seed=0, n=8, leaf_bytes=48 * 1024):
    rs = np.random.RandomState(seed)
    return {f"l{i}": torch.from_numpy(np.frombuffer(rs.bytes(leaf_bytes), np.uint8).copy()) for i in range(n)}


def test_index_sidecar_v2_roundtrip(tmp_path, monkeypatch):
    """tests/test_cdc.py:328: the persisted digest index carries the payload
    map, so a second manager process references every unchanged leaf
    without staging it and without re-reading the manifests."""
    from torchsnapshot_tpu_torch import cas

    leaves = _leaves(seed=4)
    root = str(tmp_path / "root")
    seen = []
    with _cdc_env():
        SnapshotManager(root).save(1, {"m": StateDict(dict(leaves))})
        doc = json.loads((tmp_path / "root" / cas.INDEX_SIDECAR_FNAME).read_text())
        assert doc["version"] == 2 and doc["payloads"]

        def _no_seed(storage):
            raise AssertionError("a fresh manager re-read the manifests although the sidecar is current")

        monkeypatch.setattr(cas, "seed_digest_index", _no_seed)
        event_handlers.register_event_handler(seen.append)
        try:
            SnapshotManager(root).save(2, {"m": StateDict(dict(leaves))})
        finally:
            event_handlers.unregister_event_handler(seen.append)
    stats = [e.metadata for e in seen if e.name == "take.end"][-1]["cas"]
    assert stats["prestage_hits"] == stats["prestage_probed"] == len(leaves)
    assert stats["physical_bytes_written"] == 0


def test_shared_store_is_refused_naming_it(tmp_path, monkeypatch):
    """The shared chunk store is not ported: store=, TPUSNAP_STORE and a
    root's .store pointer each raise, naming it, and write nothing."""
    root = tmp_path / "ckpts"
    with pytest.raises(NotImplementedError, match="shared chunk store"):
        SnapshotManager(str(root), store=str(tmp_path / "store"))
    monkeypatch.setenv("TPUSNAP_STORE", str(tmp_path / "store"))
    with pytest.raises(NotImplementedError, match="shared chunk store"):
        SnapshotManager(str(root)).save(1, _state(1))
    monkeypatch.delenv("TPUSNAP_STORE")
    root.mkdir()
    (root / ".store").write_text(json.dumps({"store": str(tmp_path / "store")}))
    mgr = SnapshotManager(str(root))
    for call in (lambda: mgr.save(1, _state(1)), lambda: mgr.gc(apply=False)):
        with pytest.raises(NotImplementedError, match="shared chunk store"):
            call()
    assert sorted(os.listdir(root)) == [".store"]
