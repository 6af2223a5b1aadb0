"""The port's flight recorder (torchsnapshot_tpu_torch/telemetry/blackbox.py),
mirroring tests/test_postmortem.py's recorder cases: the ring's crash
contract (round trip, bounded wrap, oversize truncation, a torn slot, a
missing directory), the feeds of a real take, off by default, and the
calibrated per-record cost.  Added here: the liveness-lease records of
``dist_store`` (acquire, release, a survivor's ``peer_dead`` verdict), the
shared store's writer and sweep lease records, and the ``crash`` record a
``TPUSNAP_FAULTS`` crash spills just before ``os._exit``, from a child
process that runs the port."""

import glob
import os
import subprocess
import sys
import time

import pytest
import torch

from torchsnapshot_tpu_torch import SnapshotManager, StateDict, knobs
from torchsnapshot_tpu_torch import dist_store as ds
from torchsnapshot_tpu_torch import store as store_mod
from torchsnapshot_tpu_torch.telemetry import blackbox

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


def _names(records, kind):
    return [r["name"] for r in records if r["kind"] == kind]


def _own_ring(bb):
    rings = blackbox.read_all(bb)
    assert len(rings) == 1, rings.keys()
    return next(iter(rings.values()))


# ---------------------------------------------------------------- the ring


def test_ring_write_read_roundtrip(tmp_path):
    ring = blackbox.Ring(str(tmp_path / "bb"), slots=16, slot_bytes=256)
    assert ring.record("event", "take.start", {"rank": 0})
    assert ring.record("phase", "fs_write", {"nbytes": 123})
    ring.close()
    records = blackbox.read_ring(ring.path)
    assert [r["name"] for r in records] == ["take.start", "fs_write"]
    assert records[0]["data"] == {"rank": 0}
    assert records[0]["pid"] == os.getpid()
    assert records[1]["seq"] == 1
    assert os.path.basename(ring.path) == f"{records[0]['host']}-{os.getpid()}.ring"


def test_ring_wraps_bounded(tmp_path):
    slots, slot_bytes = 8, 256
    ring = blackbox.Ring(str(tmp_path / "bb"), slots=slots, slot_bytes=slot_bytes)
    for i in range(50):
        assert ring.record("event", f"e{i}")
    ring.close()
    # The file never grows past the ring; the newest `slots` survive, in seq
    # order.
    assert os.path.getsize(ring.path) == slots * slot_bytes
    records = blackbox.read_ring(ring.path)
    assert [r["name"] for r in records] == [f"e{i}" for i in range(42, 50)]


def test_ring_oversize_record_truncates_payload(tmp_path):
    ring = blackbox.Ring(str(tmp_path / "bb"), slots=8, slot_bytes=256)
    assert ring.record("event", "big", {"blob": "x" * 10_000})
    ring.close()
    (rec,) = blackbox.read_ring(ring.path)
    assert rec["name"] == "big"
    assert rec.get("trunc") is True
    assert "blob" not in (rec.get("data") or {})


def test_ring_tolerates_torn_slot(tmp_path):
    ring = blackbox.Ring(str(tmp_path / "bb"), slots=8, slot_bytes=256)
    for i in range(3):
        ring.record("event", f"e{i}")
    ring.close()
    # Tear the middle slot the way a kill mid-pwrite would.
    with open(ring.path, "r+b") as f:
        f.seek(1 * 256)
        f.write(b"\x00garbage" + b" " * 100)
    assert [r["name"] for r in blackbox.read_ring(ring.path)] == ["e0", "e2"]


def test_ring_reader_skips_missing_dir(tmp_path):
    assert blackbox.read_all(str(tmp_path / "nope")) == {}


# ------------------------------------------------------------------- feeds


def test_recorder_feeds_from_a_real_take(tmp_path):
    bb = str(tmp_path / "bb")
    state = {"m": StateDict({"w": torch.arange(4096, dtype=torch.float32)})}
    with knobs.override_blackbox_dir(bb), knobs.override_sidecar(False):
        SnapshotManager(str(tmp_path / "root")).save(0, state)
    records = _own_ring(bb)
    names = [(r["kind"], r["name"]) for r in records]
    assert ("op", "take.start") in names
    assert ("op", "take.end") in names
    end = next(r for r in records if r["kind"] == "op" and r["name"] == "take.end")
    assert end["data"]["success"] is True
    # Phase transitions ride along through the phase_stats observer hook,
    # and the events through the event fan-out.
    assert _names(records, "phase")
    assert "take.end" in _names(records, "event")


def test_recorder_off_by_default(tmp_path):
    root = str(tmp_path / "root")
    state = {"m": StateDict({"w": torch.arange(64, dtype=torch.float32)})}
    with knobs.override_sidecar(False):
        SnapshotManager(root).save(0, state)
    assert not glob.glob(os.path.join(root, "**", "*.ring"), recursive=True)
    assert blackbox.ring_path() is None


def test_calibrated_overhead_is_tiny():
    cal = blackbox.calibrated_overhead_s(samples=100)
    assert cal["records"] >= 0.0
    assert cal["estimated_s"] == pytest.approx(cal["per_record_s"] * cal["records"])
    # A record costs microseconds; near 1 ms would mean a sync or a reopen.
    assert cal["per_record_s"] < 1e-3


# ---------------------------------------------------------- lease records


def test_op_lease_and_dead_peer_records(tmp_path):
    """Acquire and release of this rank's liveness lease, and a survivor's
    verdict on a peer whose lease went stale, each leave a lease record."""
    bb = str(tmp_path / "bb")
    store = ds.FileStore(str(tmp_path / "kv"))
    store.set(f"{ds.OP_LEASE_PREFIX}/1", repr(time.time()).encode())  # peer 1 stops refreshing
    barrier = ds.LinearBarrier(prefix="t", store=store, rank=0, world_size=2)
    with knobs.override_blackbox_dir(bb), knobs.override_lease_interval_s(0.1), knobs.override_lease_grace_s(0.5):
        lease = ds.acquire_op_lease(store, rank=0)
        try:
            with pytest.raises(ds.StorePeerError, match="presumed dead"):
                barrier.arrive(timeout_s=60)
        finally:
            ds.release_op_lease(lease)
    records = _own_ring(bb)
    assert _names(records, "lease") == ["op_lease.acquire", "peer_dead", "op_lease.release"]
    dead = next(r for r in records if r["name"] == "peer_dead")["data"]
    assert dead["peer"] == 1 and dead["rank"] == 0 and dead["age_s"] >= 0.5


def test_store_writer_and_sweep_lease_records(tmp_path):
    """A take into a shared store starts and closes its writer lease; a
    sweep acquires its lease, moves through condemn and delete, and
    releases it."""
    bb = str(tmp_path / "bb")
    store = str(tmp_path / "store")
    state = {"m": StateDict({"w": torch.arange(1024, dtype=torch.float32)})}
    with knobs.override_blackbox_dir(bb), knobs.override_sidecar(False):
        SnapshotManager(str(tmp_path / "root"), store=store).save(0, state)
        store_mod.sweep(store)
    leases = [n for n in _names(_own_ring(bb), "lease") if n.startswith("store_")]
    assert leases == [
        "store_writer.start",
        "store_writer.close",
        "store_sweep.acquire",
        "store_sweep.condemn",
        "store_sweep.delete",
        "store_sweep.release",
    ]


# ------------------------------------------------------------ crash record

_CHILD_TAKE = """
import os, sys
import torch
from torchsnapshot_tpu_torch import SnapshotManager, StateDict

assert "jax" not in sys.modules
SnapshotManager(sys.argv[1]).save(0, {"m": StateDict({"w": torch.arange(1 << 18, dtype=torch.float32)})})
os._exit(7)  # never reached: the crash fault fires mid-take
"""


def test_crash_fault_spills_its_record_before_exit(tmp_path):
    """A child killed by a ``crash`` fault mid-take leaves a ring naming the
    open take, the fault's op and path, and the phase it died in."""
    root, bb = str(tmp_path / "root"), str(tmp_path / "bb")
    env = dict(os.environ)  # default_knob_env left no TPUSNAP_ knob set
    env.update(
        {
            "TPUSNAP_FAULTS": "write:1:crash@cas/*",
            "TPUSNAP_SIDECAR": "0",
            "TPUSNAP_BLACKBOX": bb,
            "TPUSNAP_CAS": "1",
            "TPUSNAP_DISABLE_BATCHER": "1",
        }
    )
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD_TAKE, root], env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 1, proc.stderr[-2000:]
    (ring_path,) = blackbox.read_all(bb)
    records = blackbox.read_ring(ring_path)
    # The ring is the child's: named after its pid, every record stamped so.
    pid = int(os.path.basename(ring_path)[: -len(".ring")].rsplit("-", 1)[1])
    assert pid != os.getpid() and records and {r["pid"] for r in records} == {pid}
    ops = _names(records, "op")
    assert "take.start" in ops and "take.end" not in ops
    (crash,) = [r for r in records if r["kind"] == "fault"]
    assert crash["name"] == "crash"
    assert crash["data"]["op"] == "write" and crash["data"]["path"].startswith("cas/")
    assert crash["data"]["phase"]
