"""Delta-journal checkpointing in torchsnapshot_tpu_torch (journal.py and
the manager's journal mode): a mirror of tests/test_journal.py.

Segments carry only changed entries, replay resolves every entry to its
newest segment, compaction folds segments into full steps without
rewriting payloads, recovery falls back past corrupt segments and chains,
the digest index is kept incrementally (persisted sidecar, no re-seed),
and the gc in-flight guard refuses while a save looks live.  Where the
JAX package counts metrics, these read the ``journal.*`` events and the
sidecar's journal block; the journal's pure functions are held against
the JAX package's on the same root."""

import json
import os
import socket
import time

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import StateDict, cas, event_handlers, journal, knobs
from torchsnapshot_tpu_torch._native.build import NativeBuildError
from torchsnapshot_tpu_torch.io_types import WriteIO
from torchsnapshot_tpu_torch.manager import SnapshotManager
from torchsnapshot_tpu_torch.snapshot import Snapshot
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
from torchsnapshot_tpu_torch.telemetry import sidecar

from torch_env import default_knob_env  # noqa: F401  autouse fixture


def _state(v, frozen=None, drop=False):
    d = {"hot": torch.full((128,), float(v)), "step": v}
    if frozen is not None:
        d["frozen"] = frozen.clone()
    if not drop:
        d["extra"] = torch.full((16,), 7.0)
    return {"m": StateDict(d)}


def _zeros(frozen=None, drop=False):
    st = _state(0, frozen, drop)
    for v in st["m"].values():
        if isinstance(v, torch.Tensor):
            v.zero_()
    return st


@pytest.fixture
def journal_env():
    """Small slabs so distinct leaves stay distinct chunks, sidecars off
    for speed."""
    with knobs.override_sidecar(False), knobs.override_slab_size_threshold_bytes(64), knobs.override_retry_base_s(
        0.001
    ):
        yield


@pytest.fixture
def events():
    seen = []
    event_handlers.register_event_handler(seen.append)
    yield seen
    event_handlers.unregister_event_handler(seen.append)


def _names(events):
    return [e.name for e in events]


FROZEN = torch.arange(8192, dtype=torch.float32)


def test_journal_roundtrip_and_delta_shape(tmp_path, journal_env):
    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root)
    with knobs.override_journal(True):  # TPUSNAP_JOURNAL=1 in place of journal=True
        for step in (1, 2, 3):
            mgr.save(step, _state(step, FROZEN))
    # The first save is the full base; later saves are delta segments.
    assert mgr.all_steps() == [1]
    assert mgr.restore_points() == [(1, "full"), (2, "seg"), (3, "seg")]

    storage = url_to_storage_plugin(root)
    try:
        md = journal.read_segment_metadata(storage, 3)
    finally:
        storage.sync_close()
    assert md.version == "0.5.0"
    info = md.journal
    assert info["base_step"] == 1 and info["prior_segments"] == [2]
    # Only the churning leaves changed.
    assert info["entries_delta"] < info["entries_total"]
    assert not any("frozen" in path for path in md.manifest)
    assert info["delta_bytes"] < FROZEN.nbytes

    dst = _zeros(FROZEN)
    ptr = dst["m"]["frozen"].data_ptr()
    assert mgr.restore_latest(dst) == 3
    assert torch.equal(dst["m"]["hot"], torch.full((128,), 3.0))
    assert torch.equal(dst["m"]["frozen"], FROZEN) and dst["m"]["frozen"].data_ptr() == ptr
    assert dst["m"]["step"] == 3

    # restore_at replays an intermediate segment exactly.
    assert mgr.restore_at(2, dst) == 2
    assert torch.equal(dst["m"]["hot"], torch.full((128,), 2.0))
    assert torch.equal(dst["m"]["frozen"], FROZEN)
    with pytest.raises(ValueError, match="no committed snapshot"):
        mgr.restore_at(99, dst)


def test_journal_async_and_deleted_paths(tmp_path, journal_env):
    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root, journal=True)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2), async_=True).wait()
    # Step 3 drops the "extra" leaf: the delta records the deletion and
    # replay does not resurrect it.
    mgr.save(3, _state(3, drop=True))
    storage = url_to_storage_plugin(root)
    try:
        md = journal.read_segment_metadata(storage, 3)
        merged, _ = journal.merged_metadata(storage, 3)
    finally:
        storage.sync_close()
    assert any("extra" in p for p in md.journal["deleted"])
    assert not any("extra" in p for p in merged.manifest)
    # A fresh manager (no in-memory state) replays identically.
    dst = _zeros(drop=True)
    assert SnapshotManager(root, journal=True).restore_latest(dst) == 3
    assert torch.equal(dst["m"]["hot"], torch.full((128,), 3.0))


def test_overlapping_async_saves_defer_compaction(tmp_path, journal_env):
    """Several async saves launched without waiting (each captures the
    pre-fold chain), with the compaction trigger low enough to trip
    mid-burst: every commit stays replayable and the deferred fold lands
    once the burst drains."""
    root = str(tmp_path / "ckpts")
    with knobs.override_journal_max_segments(2):
        mgr = SnapshotManager(root, journal=True)
        mgr.save(1, _state(1))
        pendings = [mgr.save(step, _state(step), async_=True) for step in (2, 3, 4)]
        for p in pendings:
            p.wait()
        dst = _zeros()
        assert mgr.restore_latest(dst) == 4
        assert torch.equal(dst["m"]["hot"], torch.full((128,), 4.0))
        assert mgr.orphan_segments() == []
        assert mgr.orphan_chunks() == []


def test_direct_restore_of_delta_segment_refuses(tmp_path, journal_env):
    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root, journal=True)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    with pytest.raises(RuntimeError, match="journal delta segment"):
        Snapshot(f"{root}/seg_2").restore(_zeros())


def test_compaction_folds_segments(tmp_path, journal_env, events):
    frozen = torch.arange(4096, dtype=torch.float32)
    root = str(tmp_path / "ckpts")
    with knobs.override_journal_max_segments(3):
        mgr = SnapshotManager(root, journal=True)
        for step in range(1, 8):
            mgr.save(step, _state(step, frozen))
    # 1 is the base; segments 2-4 trip the count knob and fold into step_4,
    # then 5-7 fold into step_7.
    assert mgr.all_steps() == [1, 4, 7]
    storage = url_to_storage_plugin(root)
    try:
        assert journal.committed_segments(storage) == []
    finally:
        storage.sync_close()
    dst = _zeros(frozen)
    assert mgr.restore_at(4, dst) == 4
    assert torch.equal(dst["m"]["hot"], torch.full((128,), 4.0))
    assert torch.equal(dst["m"]["frozen"], frozen)
    referenced, orphan = mgr.chunk_classification()
    storage = url_to_storage_plugin(root)
    try:
        present = cas.list_chunk_relpaths(storage)
    finally:
        storage.sync_close()
    assert sorted(referenced + orphan) == present
    folds = [e.metadata for e in events if e.name == "journal.compaction"]
    assert [(f["step"], f["folded_segments"]) for f in folds] == [(4, 3), (7, 3)]
    assert _names(events).count("journal.commit") == 6


def test_crashed_compaction_rerun_and_stale_segment_gc(tmp_path, journal_env, events):
    """A compaction that committed its folded step but crashed before the
    segment sweep leaves stale segments; recovery lands on the folded step
    and gc sweeps the leftovers."""
    root = str(tmp_path / "ckpts")
    with knobs.override_journal_max_segments(100):
        mgr = SnapshotManager(root, journal=True)
        for step in (1, 2, 3):
            mgr.save(step, _state(step))
        storage = url_to_storage_plugin(root)
        try:
            merged, _ = journal.merged_metadata(storage, 3)
            storage.sync_write(
                WriteIO(path="step_3/.snapshot_metadata", buf=merged.to_json().encode("utf-8"), durable=True)
            )
        finally:
            storage.sync_close()
    fresh = SnapshotManager(root, journal=True)
    assert fresh.stale_segments() == [2, 3]
    # The full step wins the tie at step 3, even with its subsumed
    # segment's chain broken: no fallback.
    (tmp_path / "ckpts" / "seg_2" / ".snapshot_metadata").write_text("{bad")
    dst = _zeros()
    assert fresh.restore_latest(dst) == 3
    assert "journal.fallback" not in _names(events)
    assert torch.equal(dst["m"]["hot"], torch.full((128,), 3.0))
    _, _, removed_segs = fresh.gc_detail(apply=True)
    assert removed_segs == [2, 3]
    assert fresh.stale_segments() == []
    assert fresh.restore_latest(dst) == 3


def test_replay_fallback_past_corrupt_segments(tmp_path, journal_env, events):
    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root, journal=True)
    for step in (1, 2, 3, 4):
        mgr.save(step, _state(step))
    (tmp_path / "ckpts" / "seg_4" / ".snapshot_metadata").write_text("{bad")
    dst = _zeros()
    assert mgr.restore_latest(dst) == 3
    assert torch.equal(dst["m"]["hot"], torch.full((128,), 3.0))
    fallbacks = [e.metadata for e in events if e.name == "journal.fallback"]
    assert [f["step"] for f in fallbacks] == [4]
    # A broken chain piece (seg_2) invalidates every later segment.
    (tmp_path / "ckpts" / "seg_2" / ".snapshot_metadata").write_text("{bad")
    assert mgr.restore_latest(dst) == 1
    assert torch.equal(dst["m"]["hot"], torch.full((128,), 1.0))
    with pytest.raises(journal.JournalReplayError):
        mgr.restore_at(3, dst)


def test_digest_index_incremental_and_persisted(tmp_path, journal_env, monkeypatch):
    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root, journal=True)
    for step in (1, 2):
        mgr.save(step, _state(step))
    sidecar_file = tmp_path / "ckpts" / cas.INDEX_SIDECAR_FNAME
    doc = json.loads(sidecar_file.read_text())
    assert doc["algo"] == "xxh64"
    assert "step_1/.snapshot_metadata" in doc["committed"]
    assert "seg_2/.snapshot_metadata" in doc["committed"]

    def _boom(*a, **k):
        raise AssertionError("full re-seed ran despite a fresh sidecar")

    with monkeypatch.context() as m:
        m.setattr(cas, "seed_digest_index", _boom)
        fresh = SnapshotManager(root, journal=True)
        with knobs.override_cas(True):
            idx = fresh._digest_index_for_save()
        assert len(idx) > 0
    # A stale sidecar falls back to the full seed.
    doc["committed"] = []
    sidecar_file.write_text(json.dumps(doc))
    storage = url_to_storage_plugin(root)
    try:
        reseeded = cas.load_or_seed_index(root, storage, "xxh64")
    finally:
        storage.sync_close()
    assert len(reseeded) == len(idx)


def test_indexless_gc_drops_stale_index_sidecar(tmp_path, journal_env):
    """A gc-only process (no in-memory index) that sweeps orphan chunks
    drops the persisted index sidecar: a later save would otherwise trust
    it and dedup against the deleted chunk."""
    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root, journal=True)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    sidecar_file = tmp_path / "ckpts" / cas.INDEX_SIDECAR_FNAME
    assert sidecar_file.exists()
    orphan_dir = tmp_path / "ckpts" / "cas" / "xxh64" / "de"
    orphan_dir.mkdir(parents=True, exist_ok=True)
    (orphan_dir / "deadbeefdeadbeef").write_bytes(b"orphan bytes")
    doc = json.loads(sidecar_file.read_text())
    doc["keys"].append("xxh64/deadbeefdeadbeef")
    sidecar_file.write_text(json.dumps(doc))
    swept = SnapshotManager(root, journal=True).gc_detail(apply=True)[1]
    assert "cas/xxh64/de/deadbeefdeadbeef" in swept
    assert not sidecar_file.exists()


def test_gc_inflight_guard(tmp_path, journal_env):
    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root, journal=True)
    mgr.save(1, _state(1))
    assert mgr.inflight_markers() == []
    # A live-looking marker (this pid) over an uncommitted dir: refuse.
    os.makedirs(f"{root}/seg_9")
    marker = {"step": 9, "kind": "seg", "pid": os.getpid(), "host": socket.gethostname(), "started": 0}
    with open(f"{root}/.inflight_seg_9.json", "w") as f:
        json.dump(marker, f)
    with pytest.raises(RuntimeError, match="in-flight save marker"):
        mgr.gc(apply=True)
    assert os.path.exists(f"{root}/seg_9")
    _, _, segs = mgr.gc_detail(apply=False)
    assert 9 in segs
    mgr.gc(apply=True, force=True)
    assert not os.path.exists(f"{root}/seg_9")
    assert not os.path.exists(f"{root}/.inflight_seg_9.json")
    # A dead-pid marker on this host is stale: gc proceeds without force.
    os.makedirs(f"{root}/step_11")
    marker.update(step=11, kind="step", pid=2**22 + 999983)
    with open(f"{root}/.inflight_step_11.json", "w") as f:
        json.dump(marker, f)
    assert mgr.gc(apply=True) == [11]
    assert not os.path.exists(f"{root}/.inflight_step_11.json")
    # A marker from another host whose refreshed stamp expired is stale.
    os.makedirs(f"{root}/step_12")
    marker.update(step=12, host="elsewhere", pid=1, stamp=time.time() - 3600)
    with open(f"{root}/.inflight_step_12.json", "w") as f:
        json.dump(marker, f)
    assert mgr.gc(apply=True) == [12]


def test_journal_requires_the_native_library(tmp_path, monkeypatch):
    """The JAX package degrades journal saves to full snapshots without a
    hash backend; this package has no hashless mode, so a journal save
    without the native library raises its build error and commits nothing."""
    from torchsnapshot_tpu_torch import native_io

    def _no_native(cls):
        raise NativeBuildError("g++ failed (rc 1): no compiler")

    root = str(tmp_path / "ckpts")
    with monkeypatch.context() as m:
        m.setattr(native_io.NativeFileIO, "_instance", None)
        m.setattr(native_io.NativeFileIO, "get", classmethod(_no_native))
        with knobs.override_sidecar(False), pytest.raises(NativeBuildError, match="g\\+\\+ failed"):
            SnapshotManager(root, journal=True).save(1, _state(1))
    assert SnapshotManager(root, journal=True).restore_points() == []


def test_journal_sidecar_records_delta_bytes(tmp_path):
    root = str(tmp_path / "ckpts")
    with knobs.override_slab_size_threshold_bytes(64), knobs.override_retry_base_s(0.001):
        mgr = SnapshotManager(root, journal=True)
        mgr.save(1, _state(1))
        mgr.save(2, _state(2))
    storage = url_to_storage_plugin(f"{root}/seg_2")
    try:
        docs = sidecar.read_all(storage)
    finally:
        storage.sync_close()
    (doc,) = [d for d in docs if d.get("action") == "take"]
    journal_extra = doc["journal"]
    assert journal_extra["base_step"] == 1
    assert journal_extra["entries_delta"] <= journal_extra["entries_total"]
    assert journal_extra["delta_bytes"] > 0
    assert "cas" in doc


def test_journal_functions_match_the_jax_package(tmp_path, journal_env):
    """On the same root, the JAX package's journal replays and reloads the
    port's chain to the same merged metadata and state, and computes the
    same delta and logical bytes."""
    from torchsnapshot_tpu import journal as jax_journal
    from torchsnapshot_tpu.storage_plugin import url_to_storage_plugin as jax_plugin

    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root, journal=True)
    for step in (1, 2, 3):
        mgr.save(step, _state(step, FROZEN, drop=step == 3))
    ours, theirs = url_to_storage_plugin(root), jax_plugin(root)
    try:
        for seg in (2, 3):
            merged, info = journal.merged_metadata(ours, seg)
            jax_merged, jax_info = jax_journal.merged_metadata(theirs, seg)
            assert merged.to_json() == jax_merged.to_json() and info == jax_info
            assert journal.manifest_logical_bytes(merged.manifest) == jax_journal.manifest_logical_bytes(
                jax_merged.manifest
            )
        state = journal.load_state(ours, [1])
        jax_state = jax_journal.load_state(theirs, [1])
        assert (state.base_step, state.segments, state.view, state.world_size, state.delta_bytes) == (
            jax_state.base_step,
            jax_state.segments,
            jax_state.view,
            jax_state.world_size,
            jax_state.delta_bytes,
        )
        seg3 = journal.read_segment_metadata(ours, 3)
        base, _ = journal.merged_metadata(ours, 2)
        full, _ = journal.merged_metadata(ours, 3)
        delta = journal.compute_delta(full, journal.view_of(base.manifest), 1, [2])
        jax_full, _ = jax_journal.merged_metadata(theirs, 3)
        jax_base, _ = jax_journal.merged_metadata(theirs, 2)
        jax_delta = jax_journal.compute_delta(jax_full, jax_journal.view_of(jax_base.manifest), 1, [2])
        assert delta.to_json() == jax_delta.to_json() == seg3.to_json()
        assert journal.sidecar_summary(seg3.journal) == jax_journal.sidecar_summary(seg3.journal)
    finally:
        ours.sync_close()
        theirs.sync_close()
