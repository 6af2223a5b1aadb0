"""Snapshot replication in the port (torchsnapshot_tpu_torch.replication):
mirrors of tests/test_replication.py, all but its CLI case (the ``cp``
command is not ported yet).  fs → s3 → fs round trips, the fs hard-link
path and ``force_stream``, the commit-last contract, overwrite, verify
catching corruption in transit and refusing a no-op audit, and the byte
sizes the copy budgets with, held against the JAX package's on the same
manifests.  Inputs are made from seeded numpy generators; restores are
bit-exact and in place."""

import inspect
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu import replication as jax_replication
from torchsnapshot_tpu_torch import ChecksumError, Snapshot, StateDict, copy_snapshot, knobs
from torchsnapshot_tpu_torch.replication import _payload_sizes
from torchsnapshot_tpu_torch.snapshot import SNAPSHOT_METADATA_FNAME
from torchsnapshot_tpu_torch.storage_plugins.s3 import S3StoragePlugin

from torch_env import default_knob_env, no_leaked_threads, s3_server  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


def _app(step=11):
    rng = np.random.default_rng(7)
    return {
        "m": StateDict(
            {
                "w": torch.from_numpy(rng.standard_normal((500, 200)).astype(np.float32)),
                "b": torch.from_numpy(rng.standard_normal(64).astype(np.float32)),
                "step": step,
            }
        )
    }


def _assert_restores(path, app):
    dst = {"m": StateDict({"w": torch.zeros(500, 200), "b": torch.zeros(64), "step": -1})}
    ptrs = {k: dst["m"][k].data_ptr() for k in ("w", "b")}
    Snapshot(path).restore(dst)
    for k in ("w", "b"):
        assert dst["m"][k].data_ptr() == ptrs[k]
        assert torch.equal(dst["m"][k], app["m"][k]), k
    assert dst["m"]["step"] == app["m"]["step"]


def _payload_locations(snap):
    return {e.location for e in snap.get_manifest().values() if getattr(e, "location", None)}


def test_fs_to_s3_and_back(tmp_path, s3_server):
    app = _app()
    src = str(tmp_path / "src")
    Snapshot.take(src, app)
    copy_snapshot(src, "s3://bkt/replica", verify=True)
    _assert_restores("s3://bkt/replica", app)
    back = str(tmp_path / "back")
    copy_snapshot("s3://bkt/replica", back, verify=True)
    _assert_restores(back, app)


def test_fs_to_fs_uses_server_side_path(tmp_path):
    """Same-backend fs copies are hard links: every payload shares its
    source inode."""
    app = _app()
    src = str(tmp_path / "src")
    snap = Snapshot.take(src, app)
    dst = str(tmp_path / "dst")
    copy_snapshot(src, dst, verify=True)
    _assert_restores(dst, app)
    locations = _payload_locations(snap)
    assert locations
    for loc in locations:
        assert os.stat(os.path.join(dst, loc)).st_ino == os.stat(os.path.join(src, loc)).st_ino, loc


def test_failed_copy_leaves_no_commit_marker(tmp_path, s3_server, monkeypatch):
    app = _app()
    src = str(tmp_path / "src")
    Snapshot.take(src, app)
    orig_write = S3StoragePlugin.write

    async def _failing_write(self, write_io):
        if write_io.path != SNAPSHOT_METADATA_FNAME:
            raise RuntimeError("injected payload write failure")
        await orig_write(self, write_io)

    monkeypatch.setattr(S3StoragePlugin, "write", _failing_write)
    with pytest.raises(RuntimeError, match="copying"):
        copy_snapshot(src, "s3://bkt/torn")
    monkeypatch.setattr(S3StoragePlugin, "write", orig_write)
    assert not any(k.endswith(SNAPSHOT_METADATA_FNAME) for k in s3_server.objects)
    with pytest.raises(RuntimeError, match="missing or unreadable"):
        Snapshot("s3://bkt/torn").metadata


def test_overwrite_semantics(tmp_path):
    app_a, app_b = _app(), _app(step=99)
    src_a, src_b = str(tmp_path / "a"), str(tmp_path / "b")
    Snapshot.take(src_a, app_a)
    Snapshot.take(src_b, app_b)
    dst = str(tmp_path / "dst")
    copy_snapshot(src_a, dst)
    with pytest.raises(RuntimeError, match="already holds"):
        copy_snapshot(src_b, dst)
    copy_snapshot(src_b, dst, overwrite=True)
    _assert_restores(dst, app_b)


def test_verify_catches_corruption_in_transit(tmp_path, s3_server, monkeypatch):
    """A payload corrupted between write and commit fails the copy, and
    the audit runs before the marker: the destination never commits."""
    app = _app()
    src = str(tmp_path / "src")
    Snapshot.take(src, app)
    orig_write = S3StoragePlugin.write

    async def _corrupting_write(self, write_io):
        await orig_write(self, write_io)
        if write_io.path != SNAPSHOT_METADATA_FNAME:
            key = f"bkt/rot/{write_io.path}"
            data = bytearray(s3_server.objects[key])
            data[0] ^= 0xFF
            s3_server.objects[key] = bytes(data)

    monkeypatch.setattr(S3StoragePlugin, "write", _corrupting_write)
    with pytest.raises(ChecksumError, match="copy verification failed"):
        copy_snapshot(src, "s3://bkt/rot", verify=True)
    assert not any(k.endswith(SNAPSHOT_METADATA_FNAME) for k in s3_server.objects)


def test_uncommitted_source_refused(tmp_path):
    src = str(tmp_path / "notasnap")
    os.makedirs(src)
    with pytest.raises(RuntimeError, match="missing or unreadable"):
        copy_snapshot(src, str(tmp_path / "dst"))
    assert not os.path.exists(os.path.join(tmp_path / "dst", SNAPSHOT_METADATA_FNAME))


def test_verify_refuses_noop_audit(tmp_path):
    src = str(tmp_path / "src")
    Snapshot.take(src, _app())
    with knobs.override_env("TPUSNAP_CHECKSUM", "0"), pytest.raises(RuntimeError, match="cannot verify"):
        copy_snapshot(src, str(tmp_path / "dst"), verify=True)
    assert not os.path.exists(tmp_path / "dst")


def test_verify_refuses_digestless_source(tmp_path, monkeypatch):
    app = _app()
    src = str(tmp_path / "src")
    monkeypatch.setenv("TPUSNAP_CHECKSUM_ON_SAVE", "0")
    Snapshot.take(src, app)
    monkeypatch.delenv("TPUSNAP_CHECKSUM_ON_SAVE")
    with pytest.raises(RuntimeError, match="records no checksums"):
        copy_snapshot(src, str(tmp_path / "dst"), verify=True)
    dst2 = str(tmp_path / "dst2")
    copy_snapshot(src, dst2)
    _assert_restores(dst2, app)


def test_force_stream_makes_physical_replica(tmp_path):
    app = _app()
    src = str(tmp_path / "src")
    snap = Snapshot.take(src, app)
    dst = str(tmp_path / "dst")
    copy_snapshot(src, dst, verify=True, force_stream=True)
    _assert_restores(dst, app)
    locations = _payload_locations(snap)
    assert locations
    for loc in locations:
        assert os.stat(os.path.join(dst, loc)).st_ino != os.stat(os.path.join(src, loc)).st_ino, loc


def test_payload_sizes_cover_standalone_tensors(tmp_path):
    """Standalone payloads record no byte range: their size is dtype ×
    shape, so the budget charges them and largest-first puts them first."""
    big = torch.zeros(1024, 256)  # 1 MiB
    small = torch.zeros(16)
    with knobs.override_batching_disabled(True):
        snap = Snapshot.take(str(tmp_path / "s"), {"m": StateDict({"big": big, "small": small})})
    sizes = _payload_sizes(snap.metadata)
    by_suffix = {loc.rsplit("/", 1)[-1]: n for loc, n in sizes.items()}
    assert by_suffix["big"] == big.nbytes
    assert by_suffix["small"] == small.nbytes
    assert sorted(sizes, key=lambda loc: -sizes[loc])[0].endswith("big")


@pytest.mark.parametrize("batched", [True, False], ids=["slabs", "standalone"])
def test_signature_and_payload_sizes_match_the_jax_package(tmp_path, batched):
    """``copy_snapshot`` takes the JAX package's parameters with its
    defaults, and ``_payload_sizes`` gives the JAX package's sizes on the
    same manifests (slab members and standalone payloads)."""
    from torchsnapshot_tpu import Snapshot as JaxSnapshot

    assert inspect.signature(copy_snapshot) == inspect.signature(jax_replication.copy_snapshot)
    with knobs.override_batching_disabled(not batched):
        Snapshot.take(str(tmp_path / "s"), _app())
    sizes = _payload_sizes(Snapshot(str(tmp_path / "s")).metadata)
    assert sizes == jax_replication._payload_sizes(JaxSnapshot(str(tmp_path / "s")).metadata)
    assert sum(sizes.values()) >= 500 * 200 * 4 + 64 * 4
