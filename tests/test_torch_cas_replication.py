"""Replication of content-addressed steps and journal segments in the port
(``copy_snapshot`` through the two roots): mirrors of tests/test_cas.py:366,
:398 and :422, a CAS root streamed fs → s3 → gs, and server-side step copies
within one S3 or GCS bucket.  A step's copy ships only the chunks the
destination root lacks; a segment's copy ships its whole replay chain.
Inputs are made from seeded numpy generators."""

import glob
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, SnapshotManager, StateDict, cas, copy_snapshot, knobs, phase_stats
from torchsnapshot_tpu_torch.io_types import ReadIO
from torchsnapshot_tpu_torch.manifest import SnapshotMetadata
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

from test_torch_cas import FROZEN, _assert_roundtrip, _chunk_files, _state
from torch_env import default_knob_env, gcs_server, no_leaked_threads, s3_server  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


def _save_cas_steps(root, steps=(1, 2)):
    mgr = SnapshotManager(root)
    with knobs.override_cas(True), knobs.override_batching_disabled(True):
        for step in steps:
            mgr.save(step, _state(step))
    return mgr


def _chunk_keys(objects, prefix):
    return {k for k in objects if k.startswith(f"{prefix}/cas/")}


def test_cp_replicates_cas_snapshot_chunk_by_chunk(tmp_path):
    """Chunks go into the destination's cas/ store, the marker last, and a
    second step's copy ships only the chunk that step added."""
    root, dst_root = str(tmp_path / "ckpts"), str(tmp_path / "replica")
    _save_cas_steps(root)
    copied = copy_snapshot(f"{root}/step_1", f"{dst_root}/step_1", verify=True)
    dst = _state(0)
    copied.restore(dst)
    np.testing.assert_array_equal(dst["m"]["frozen"].numpy(), FROZEN)
    chunks_after_first = set(_chunk_files(dst_root))
    assert chunks_after_first
    copy_snapshot(f"{root}/step_2", f"{dst_root}/step_2", verify=True)
    chunks_after_second = set(_chunk_files(dst_root))
    assert chunks_after_first < chunks_after_second
    assert len(chunks_after_second - chunks_after_first) == 1
    _assert_roundtrip(f"{dst_root}/step_2", 2)
    with pytest.raises(RuntimeError, match="overwrite"):
        copy_snapshot(f"{root}/step_1", f"{dst_root}/step_1")
    copy_snapshot(f"{root}/step_1", f"{dst_root}/step_1", overwrite=True)
    _assert_roundtrip(f"{dst_root}/step_1", 1)


def test_cp_replicates_journal_segment_with_chain(tmp_path):
    root, dst_root = str(tmp_path / "ckpts"), str(tmp_path / "replica")
    with knobs.override_journal(True), knobs.override_batching_disabled(True):
        mgr = SnapshotManager(root)
        for step in (1, 2, 3):
            mgr.save(step, _state(step))
    copy_snapshot(f"{root}/seg_3", f"{dst_root}/seg_3", verify=True)
    dst = _state(0)
    assert SnapshotManager(dst_root).restore_latest(dst) == 3
    assert torch.equal(dst["m"]["opt"], torch.full((4096,), 3.0))
    np.testing.assert_array_equal(dst["m"]["frozen"].numpy(), FROZEN)
    assert SnapshotManager(dst_root).restore_points() == [(1, "full"), (2, "seg"), (3, "seg")]
    with pytest.raises(RuntimeError, match="rename"):
        copy_snapshot(f"{root}/seg_3", f"{dst_root}/seg_9")


def test_cp_journal_lineage_guard(tmp_path):
    """A committed chain member at the destination is trusted only when its
    manifest equals the source's: a foreign base refuses, a torn marker is
    copied again."""
    root = str(tmp_path / "ckpts")
    with knobs.override_journal(True), knobs.override_batching_disabled(True):
        mgr = SnapshotManager(root)
        mgr.save(1, _state(1))
        mgr.save(2, _state(2))
        foreign = str(tmp_path / "foreign")
        SnapshotManager(foreign).save(1, _state(7))
    with pytest.raises(RuntimeError, match="lineage"):
        copy_snapshot(f"{root}/seg_2", f"{foreign}/seg_2")
    torn = str(tmp_path / "torn")
    os.makedirs(os.path.join(torn, "step_1"))
    with open(os.path.join(torn, "step_1", ".snapshot_metadata"), "wb") as f:
        f.write(b"{ this is not json")
    copy_snapshot(f"{root}/seg_2", f"{torn}/seg_2", verify=True)
    dst = _state(0)
    assert SnapshotManager(torn).restore_latest(dst) == 2
    assert torch.equal(dst["m"]["opt"], torch.full((4096,), 2.0))
    storage = url_to_storage_plugin(torn)
    try:
        read_io = ReadIO(path="step_1/.snapshot_metadata")
        storage.sync_read(read_io)
        healed = SnapshotMetadata.from_json(bytes(read_io.buf).decode("utf-8"))
    finally:
        storage.sync_close()
    assert healed.to_json() == Snapshot(f"{root}/step_1").metadata.to_json()


def test_cas_root_streams_across_backends(tmp_path, s3_server, gcs_server):
    """A CAS root copied fs → s3 → gs, step by step: each hop streams the
    chunks through this host (no backend copies to another server-side),
    each step restores bit-exact at every hop, and every hop's store holds
    the source's chunks with the source's bytes."""
    root = str(tmp_path / "ckpts")
    _save_cas_steps(root)
    fs_chunks = {os.path.relpath(p, root): open(p, "rb").read() for p in _chunk_files(root)}
    for step in (1, 2):
        copy_snapshot(f"{root}/step_{step}", f"s3://bkt/run/step_{step}", verify=True)
        copy_snapshot(f"s3://bkt/run/step_{step}", f"gs://bkt/run/step_{step}", verify=True)
    assert s3_server.copies == 0 and gcs_server.copies == 0
    for server in (s3_server, gcs_server):
        got = {k[len("bkt/run/") :]: v for k, v in server.objects.items() if k.startswith("bkt/run/cas/")}
        assert got == fs_chunks
    for step in (1, 2):
        _assert_roundtrip(f"s3://bkt/run/step_{step}", step)
        _assert_roundtrip(f"gs://bkt/run/step_{step}", step)


@pytest.mark.parametrize("scheme", ["s3", "gs"])
def test_cas_step_copies_server_side_within_a_bucket(tmp_path, scheme, request):
    """Within one bucket every chunk the destination lacks is a server-side
    copy (CopyObject, rewriteTo): no chunk bytes go up from this host, only
    the commit marker."""
    server = request.getfixturevalue("s3_server" if scheme == "s3" else "gcs_server")
    src_root = f"{scheme}://bkt/run"
    _save_cas_steps(src_root)
    upload_phases = ("s3_put", "s3_multipart") if scheme == "s3" else ("gcs_upload",)
    marker_bytes = 0
    copied = set()
    for step in (1, 2):
        before_chunks = _chunk_keys(server.objects, "bkt/replica")
        copies_before = server.copies
        before = phase_stats.snapshot()
        copy_snapshot(f"{src_root}/step_{step}", f"{scheme}://bkt/replica/step_{step}", verify=True)
        moved = phase_stats.delta(before)
        new_chunks = _chunk_keys(server.objects, "bkt/replica") - before_chunks
        assert server.copies - copies_before == len(new_chunks) > 0
        marker_bytes = len(server.objects[f"bkt/replica/step_{step}/.snapshot_metadata"])
        assert sum(moved.get(p, {}).get("bytes", 0) for p in upload_phases) == marker_bytes
        assert sum(moved.get(p, {}).get("n", 0) for p in upload_phases) == 1
        copied |= new_chunks
    src_chunks = {k.replace("bkt/run/", "bkt/replica/"): v for k, v in server.objects.items() if k.startswith("bkt/run/cas/")}
    assert {k: server.objects[k] for k in copied} == src_chunks
    for step in (1, 2):
        _assert_roundtrip(f"{scheme}://bkt/replica/step_{step}", step)
    md = Snapshot(f"{scheme}://bkt/replica/step_2").metadata
    assert {f"bkt/replica/{r}" for r in cas.referenced_chunk_relpaths(md.manifest)} <= copied
