"""Restore-side degradation in torchsnapshot_tpu_torch's manager (mirror of
tests/test_restore_fallback.py): a corrupt or torn snapshot is named,
fails the JAX package's ``verify``, and is skipped by ``restore_latest``'s
last-good fallback; a transient storage error re-raises instead.  The
JAX package counts fallbacks in its metrics registry; the port's
``restore_latest.fallback`` events carry the same reason."""

import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import ChecksumError, Snapshot, StateDict, StorageTransientError, event_handlers, knobs
from torchsnapshot_tpu_torch.manager import SnapshotManager

from torch_env import default_knob_env  # noqa: F401  autouse fixture


def _state(v):
    return {"m": StateDict({"w": torch.full((1024,), float(v)), "step": v})}


def _corrupt_payload(snapshot_path: str, entry) -> str:
    """Flip one byte of an entry's stored payload (length preserved)."""
    payload = os.path.join(snapshot_path, entry.location)
    with open(payload, "r+b") as f:
        offset = (entry.byte_range[0] if entry.byte_range else 0) + 64
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))
    return payload


@pytest.fixture
def events():
    seen = []
    event_handlers.register_event_handler(seen.append)
    yield seen
    event_handlers.unregister_event_handler(seen.append)


def test_corrupt_latest_named_verified_and_skipped(tmp_path, events):
    from torchsnapshot_tpu.__main__ import main as jax_cli

    root = tmp_path / "ckpts"
    mgr = SnapshotManager(str(root))
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    step2 = str(root / "step_2")
    entry = Snapshot(step2).get_manifest()["0/m/w"]
    _corrupt_payload(step2, entry)

    # 1) the ChecksumError names the offending payload
    with pytest.raises(ChecksumError, match="Checksum mismatch") as excinfo:
        Snapshot(step2).restore(_state(0))
    assert entry.location in str(excinfo.value)

    # 2) the JAX package's `verify` fails the corrupt snapshot the port wrote
    assert jax_cli(["verify", step2]) == 1
    assert jax_cli(["verify", str(root / "step_1")]) == 0

    # 3) restore_latest falls back to the previous committed step
    dst = _state(0)
    assert mgr.restore_latest(dst) == 1
    assert torch.equal(dst["m"]["w"], torch.full((1024,), 1.0))
    assert dst["m"]["step"] == 1
    fallbacks = [e.metadata for e in events if e.name == "restore_latest.fallback"]
    assert [(f["step"], f["kind"]) for f in fallbacks] == [(2, "full")]
    assert fallbacks[0]["error"].startswith("ChecksumError")


def test_torn_manifest_skipped(tmp_path):
    """A .snapshot_metadata that exists but does not parse counts as
    committed for discovery yet does not stop a resume."""
    root = tmp_path / "ckpts"
    mgr = SnapshotManager(str(root))
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    (root / "step_2" / ".snapshot_metadata").write_bytes(b"{torn garbage")
    dst = _state(0)
    assert mgr.restore_latest(dst) == 1
    assert dst["m"]["step"] == 1


def test_all_snapshots_bad_raises(tmp_path):
    root = tmp_path / "ckpts"
    mgr = SnapshotManager(str(root))
    mgr.save(1, _state(1))
    (root / "step_1" / ".snapshot_metadata").write_bytes(b"{torn garbage")
    with pytest.raises(RuntimeError, match="all 1 committed restore points"):
        mgr.restore_latest(_state(0))


def test_empty_root_still_returns_none(tmp_path):
    mgr = SnapshotManager(str(tmp_path / "ckpts"))
    assert mgr.restore_latest(_state(0)) is None


def test_transient_error_reraises_without_fallback(tmp_path, events):
    """A transient storage error says nothing about the snapshot: it
    propagates, and no fallback lands on older weights."""
    root = tmp_path / "ckpts"
    mgr = SnapshotManager(str(root))
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    dst = _state(0)
    with knobs.override_env(knobs.IO_RETRIES_ENV_VAR, "0"), knobs.override_faults("read:1+:transient@*/m/w"):
        with pytest.raises(StorageTransientError):
            mgr.restore_latest(dst)
    assert not [e for e in events if e.name == "restore_latest.fallback"]
    np.testing.assert_array_equal(dst["m"]["w"].numpy(), np.zeros(1024, np.float32))
