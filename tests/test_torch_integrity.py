"""Checksum integrity in the port (mirrors of tests/test_integrity.py's
uncompressed cases): digests recorded at save, corruption detected at
restore, the same digest values as torchsnapshot_tpu for every size class
(plain xxh64 below 32 MiB, striped xxh64s at and above).  Exact."""

import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu import integrity as jax_integrity
from torchsnapshot_tpu_torch import ChecksumError, Snapshot, StateDict, integrity
from torchsnapshot_tpu_torch.native_io import STRIPED_MIN_BYTES, NativeFileIO

from torch_env import default_knob_env  # noqa: F401  autouse fixture


def _flip(path, entry, offset=100):
    payload = os.path.join(path, entry.location)
    with open(payload, "r+b") as f:
        at = (entry.byte_range[0] if entry.byte_range else 0) + offset
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))


def test_checksums_recorded(tmp_path):
    state = {"w": torch.arange(64, dtype=torch.float32), "obj": {1, 2, 3}}
    manifest = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(state)}).get_manifest()
    assert manifest["0/m/w"].checksum.startswith("xxh64:")
    assert manifest["0/m/obj"].checksum is not None


def test_checksum_known_vector():
    # xxh64 of empty input with seed 0 is the published constant
    assert NativeFileIO.get().xxhash64(b"") == 0xEF46DB3751D8E999


@pytest.mark.parametrize(
    "nbytes",
    [0, 1, 31, 32, 33, 4096, STRIPED_MIN_BYTES - 1, STRIPED_MIN_BYTES, STRIPED_MIN_BYTES + 12345],
)
def test_digests_equal_jax_package(nbytes):
    buf = np.random.RandomState(nbytes % 1000).randint(0, 256, size=nbytes).astype(np.uint8)
    assert integrity.digest(buf) == jax_integrity.digest(buf)


def test_striped_payload_roundtrip_and_corruption(tmp_path):
    """A payload of >= 32 MiB records an xxh64s digest, verifies fused with
    a parallel read, and still catches a flipped byte."""
    big = torch.rand(STRIPED_MIN_BYTES // 4 + 1024, generator=torch.Generator().manual_seed(2))
    path = str(tmp_path / "snap")
    snapshot = Snapshot.take(path, {"m": StateDict({"big": big})})
    entry = snapshot.get_manifest()["0/m/big"]
    assert entry.checksum.startswith("xxh64s:")
    dst = torch.zeros_like(big)
    Snapshot(path).restore({"m": StateDict({"big": dst})})
    assert torch.equal(dst, big)
    _flip(path, entry, offset=STRIPED_MIN_BYTES - 7)
    with pytest.raises(ChecksumError, match="m/big"):
        Snapshot(path).restore({"m": StateDict({"big": torch.zeros_like(big)})})


def test_checksum_disabled(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_CHECKSUM", "0")
    state = {"w": torch.arange(16, dtype=torch.float32)}
    snapshot = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(state)})
    assert snapshot.get_manifest()["0/m/w"].checksum is None
    dst = torch.zeros(16)
    snapshot.restore({"m": StateDict({"w": dst})})
    assert torch.equal(dst, state["w"])


def test_save_checksums_disabled_restore_still_verifies(tmp_path, monkeypatch):
    state = {"w": torch.arange(256, dtype=torch.float32)}
    snap_a = Snapshot.take(str(tmp_path / "a"), {"m": StateDict(state)})
    monkeypatch.setenv("TPUSNAP_CHECKSUM_ON_SAVE", "0")
    snap_b = Snapshot.take(str(tmp_path / "b"), {"m": StateDict(state)})
    assert snap_b.get_manifest()["0/m/w"].checksum is None
    dst = torch.zeros(256)
    snap_b.restore({"m": StateDict({"w": dst})})
    assert torch.equal(dst, state["w"])
    _flip(str(tmp_path / "a"), snap_a.get_manifest()["0/m/w"], offset=8)
    with pytest.raises(ChecksumError):
        Snapshot(str(tmp_path / "a")).restore({"m": StateDict({"w": torch.zeros(256)})})
