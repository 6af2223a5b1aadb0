"""Content-addressed chunk store of the port (torchsnapshot_tpu_torch.cas):
mirrors of tests/test_cas.py:268, :287, :484 and :499, the s3 case of
:98 (against the fake server), and its manager cases rewritten as takes
into ``<root>/step_N``.  Inputs are made from seeded numpy generators."""

import glob
import logging
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, cas, knobs
from torchsnapshot_tpu_torch._native.build import NativeBuildError
from torchsnapshot_tpu_torch.manifest import CAS_MANIFEST_VERSION, SnapshotMetadata

from torch_env import default_knob_env, no_leaked_threads, s3_server  # noqa: F401  fixtures

FROZEN = np.random.RandomState(0).rand(65536).astype(np.float32)


def _state(v):
    return {
        "m": StateDict(
            {
                "frozen": torch.from_numpy(FROZEN.copy()),
                "opt": torch.full((4096,), float(v)),
            }
        )
    }


def _chunk_files(root):
    return sorted(glob.glob(os.path.join(str(root), "cas", "*", "*", "*")))


def _assert_roundtrip(path, step):
    dst = _state(0)
    ptr = dst["m"]["frozen"].data_ptr()
    Snapshot(path).restore(dst)
    assert dst["m"]["frozen"].data_ptr() == ptr
    np.testing.assert_array_equal(dst["m"]["frozen"].numpy(), FROZEN)
    assert torch.equal(dst["m"]["opt"], torch.full((4096,), float(step)))


def test_three_step_save_stores_frozen_bytes_once(tmp_path):
    root = tmp_path / "ckpts"
    with knobs.override_cas(True), knobs.override_batching_disabled(True):
        for step in (1, 2, 3):
            Snapshot.take(str(root / f"step_{step}"), _state(step))
    chunks = _chunk_files(root)
    assert len(chunks) == 4, chunks
    total = sum(os.path.getsize(c) for c in chunks)
    assert total == FROZEN.nbytes + 3 * 4096 * 4
    assert len([c for c in chunks if os.path.getsize(c) == FROZEN.nbytes]) == 1
    for step in (1, 2, 3):
        _assert_roundtrip(str(root / f"step_{step}"), step)
    md = Snapshot(str(root / "step_2")).metadata
    assert md.version == CAS_MANIFEST_VERSION
    assert cas.is_cas_location(md.manifest["0/m/frozen"].location)
    locs = {Snapshot(str(root / f"step_{s}")).metadata.manifest["0/m/frozen"].location for s in (1, 2, 3)}
    assert len(locs) == 1
    # Step directories hold no payload: only the commit marker and the
    # telemetry sidecars of the take and the restore.
    assert sorted(os.listdir(root / "step_3")) == [".snapshot_metadata", "telemetry"]
    assert sorted(n.split("-")[0] for n in os.listdir(root / "step_3" / "telemetry")) == ["restore", "take"]


def test_async_take_dedups_and_restores(tmp_path):
    root = tmp_path / "ckpts"
    with knobs.override_cas(True), knobs.override_batching_disabled(True):
        Snapshot.take(str(root / "step_1"), _state(1))
        pending = Snapshot.async_take(str(root / "step_2"), _state(2))
        state = pending.wait()
    assert pending.staging_mode == "host"
    chunks = _chunk_files(root)
    assert len([c for c in chunks if os.path.getsize(c) == FROZEN.nbytes]) == 1
    assert state.metadata.version == CAS_MANIFEST_VERSION
    assert Snapshot(str(root / "step_2")).metadata.version == CAS_MANIFEST_VERSION
    _assert_roundtrip(str(root / "step_2"), 2)


def test_cas_degrades_without_digest(tmp_path, monkeypatch):
    """The JAX package degrades to per-step writes when no hash backend
    exists; the port has no hashless mode (the native library is required
    for every payload), so a CAS take without it raises the build error
    and commits nothing."""
    from torchsnapshot_tpu_torch import native_io

    def _no_native(cls):
        raise NativeBuildError("g++ failed (rc 1): no compiler")

    monkeypatch.setattr(native_io.NativeFileIO, "_instance", None)
    monkeypatch.setattr(native_io.NativeFileIO, "get", classmethod(_no_native))
    root = tmp_path / "ckpts"
    with knobs.override_cas(True), pytest.raises(NativeBuildError, match="g\\+\\+ failed"):
        Snapshot.take(str(root / "step_1"), _state(1))
    assert _chunk_files(root) == []
    assert not (root / "step_1" / ".snapshot_metadata").exists()


def test_incremental_from_delegates_to_cas_index(tmp_path):
    root = tmp_path / "ckpts"
    with knobs.override_cas(True), knobs.override_batching_disabled(True):
        Snapshot.take(str(root / "step_1"), _state(1))
        snap2 = Snapshot.take(str(root / "step_2"), _state(2), incremental_from=str(root / "step_1"))
    chunks = _chunk_files(root)
    assert len([c for c in chunks if os.path.getsize(c) == FROZEN.nbytes]) == 1
    dst = _state(0)
    snap2.restore(dst)
    np.testing.assert_array_equal(dst["m"]["frozen"].numpy(), FROZEN)


def test_incremental_from_cas_base_without_cas_warns_and_skips(tmp_path, caplog):
    root = tmp_path / "ckpts"
    with knobs.override_cas(True), knobs.override_batching_disabled(True):
        Snapshot.take(str(root / "step_1"), _state(1))
    with knobs.override_batching_disabled(True), caplog.at_level(
        logging.WARNING, logger="torchsnapshot_tpu_torch.incremental"
    ):
        snap2 = Snapshot.take(str(root / "step_2"), _state(2), incremental_from=str(root / "step_1"))
    assert any("CAS snapshot" in r.message for r in caplog.records)
    dst = _state(0)
    snap2.restore(dst)
    np.testing.assert_array_equal(dst["m"]["frozen"].numpy(), FROZEN)


def test_cas_location_grammar():
    loc = cas.location_for("xxh64", "ab12cd34ef56ab78")
    assert cas.is_cas_location(loc)
    assert cas.parse_cas_location(loc) == ("xxh64", "ab12cd34ef56ab78")
    assert cas.relpath_for_location(loc) == "cas/xxh64/ab/ab12cd34ef56ab78"
    assert not cas.is_cas_location("0/m/frozen")
    assert not cas.is_cas_location(None)
    with pytest.raises(ValueError):
        cas.parse_cas_location("cas://xxh64")
    with pytest.raises(ValueError):
        cas.parse_cas_location("cas://xxh64/ab/extra")


def test_cas_algo_knob_validates():
    with knobs.override_cas_algo("xxh64"):
        assert knobs.get_cas_algo() == "xxh64"
    with knobs.override_cas_algo("sha999"):
        with pytest.raises(ValueError, match="unsupported digest"):
            knobs.get_cas_algo()


def test_take_end_event_carries_dedup_stats(tmp_path):
    from torchsnapshot_tpu_torch import event_handlers

    seen = []
    root = tmp_path / "ckpts"
    event_handlers.register_event_handler(seen.append)
    try:
        with knobs.override_cas(True), knobs.override_batching_disabled(True):
            Snapshot.take(str(root / "step_1"), _state(1))
            Snapshot.take(str(root / "step_2"), _state(2))
    finally:
        event_handlers.unregister_event_handler(seen.append)
    ends = [e.metadata for e in seen if e.name == "take.end"]
    first, second = ends[-2]["cas"], ends[-1]["cas"]
    assert first["chunks_written"] == 2 and first["dedup_hits"] == 0
    # Step 2: the frozen leaf is a prestage hit, the optimizer a new chunk.
    assert second["prestage_hits"] == 1 and second["prestage_bytes"] == FROZEN.nbytes
    assert second["chunks_written"] == 1 and second["physical_bytes_written"] == 4096 * 4
    assert second["logical_bytes"] == FROZEN.nbytes + 4096 * 4
    assert any(e.name == "cas.dedup" for e in seen)


def test_orphan_chunk_is_verified_before_reuse(tmp_path):
    """A chunk no committed manifest references (a crashed take's debris)
    is reused only when its bytes hash to its name; a torn one is
    rewritten."""
    root = tmp_path / "ckpts"
    with knobs.override_cas(True), knobs.override_batching_disabled(True):
        Snapshot.take(str(root / "step_1"), _state(1))
    frozen_chunk = [c for c in _chunk_files(root) if os.path.getsize(c) == FROZEN.nbytes][0]
    os.remove(root / "step_1" / ".snapshot_metadata")  # step 1 never committed
    with open(frozen_chunk, "r+b") as f:
        f.truncate(100)  # torn debris under the right name
    with knobs.override_cas(True), knobs.override_batching_disabled(True):
        Snapshot.take(str(root / "step_2"), _state(2))
    assert os.path.getsize(frozen_chunk) == FROZEN.nbytes
    _assert_roundtrip(str(root / "step_2"), 2)


def test_shared_store_and_journal_segments_are_refused(tmp_path, monkeypatch):
    """With TPUSNAP_STORE set a CAS take lands its chunks under the shared
    store, not the root, and restores through the knob; the manager's
    store= does the same and leaves the root's .store pointer, which a
    restore with no knob set resolves through.  A 0.5.0 journal segment is
    read (its chunk references seed the index) but a direct restore of it
    is refused: only the manager's replay restores a delta."""
    from torchsnapshot_tpu_torch.manager import SnapshotManager

    store = tmp_path / "store"
    monkeypatch.setenv("TPUSNAP_STORE", str(store))
    with knobs.override_cas(True), knobs.override_batching_disabled(True):
        Snapshot.take(str(tmp_path / "root" / "step_1"), _state(1))
    assert _chunk_files(tmp_path / "root") == []
    assert len(_chunk_files(store)) == 2
    _assert_roundtrip(str(tmp_path / "root" / "step_1"), 1)
    monkeypatch.delenv("TPUSNAP_STORE")
    with knobs.override_batching_disabled(True):
        SnapshotManager(str(tmp_path / "root2"), store=str(store)).save(2, _state(2))
    assert _chunk_files(tmp_path / "root2") == []
    assert len(_chunk_files(store)) == 3  # the frozen chunk is shared
    _assert_roundtrip(str(tmp_path / "root2" / "step_2"), 2)
    doc = SnapshotMetadata(version="0.5.0", world_size=1, journal={"base_step": 1}).to_json()
    assert SnapshotMetadata.from_json(doc).journal == {"base_step": 1}
    (tmp_path / "root" / "seg_2").mkdir(parents=True)
    (tmp_path / "root" / "seg_2" / ".snapshot_metadata").write_text(doc)
    with pytest.raises(RuntimeError, match="journal delta segment"):
        Snapshot(str(tmp_path / "root" / "seg_2")).restore(_state(0))


def test_cas_roundtrip_on_fake_s3(s3_server):
    """Mirror of the s3 case of tests/test_cas.py:98: a manager root on S3
    stores the frozen payload once (a chunk PUT is atomic, no temp object),
    every step restores, and every chunk is referenced."""
    from torchsnapshot_tpu_torch.manager import SnapshotManager

    mgr = SnapshotManager("s3://bkt/casrun")
    with knobs.override_cas(True), knobs.override_batching_disabled(True):
        for step in (1, 2, 3):
            mgr.save(step, _state(step))
    chunk_keys = [k for k in s3_server.objects if "/cas/" in k]
    assert not [k for k in s3_server.objects if ".tmp" in k]
    assert len([k for k in chunk_keys if s3_server.objects[k] == FROZEN.tobytes()]) == 1
    for step in (1, 2, 3):
        _assert_roundtrip(mgr.path_for_step(step), step)
    referenced, orphan = mgr.chunk_classification()
    assert orphan == []
    assert len(referenced) == len(chunk_keys)
