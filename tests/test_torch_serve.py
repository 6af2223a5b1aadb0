"""The port's checkpoint-serving read tier at the ``Snapshot`` level.

Mirrors the Snapshot-level cases of ``tests/test_serve.py``: the second
restore served from the host cache, the restore sidecar's hit/miss record,
restores through origin faults over the cache, concurrent restores in
separate processes sharing one cache (2 workers here, the 8-worker soak
``slow``), a GCS origin read once, and the partial sharded reads that
``test_torch_sharded.py`` does not cover.  Plus ``read_object``,
``get_state_dict_for_key`` and the manager's journal replay through the
cache.  Origin traffic is metered by the fault wrapper
(``TPUSNAP_FAULTS=none``); worker processes import the port and no JAX."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu_torch import cache as cache_mod
from torchsnapshot_tpu_torch import faults, integrity, knobs
from torchsnapshot_tpu_torch.io_preparers.sharded_array import ShardedArrayIOPreparer, _ShardedRestore
from torchsnapshot_tpu_torch.io_types import WriteIO
from torchsnapshot_tpu_torch.manifest import Shard, ShardedArrayEntry, TensorEntry
from torchsnapshot_tpu_torch.scheduler import sync_execute_read_reqs
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
from torchsnapshot_tpu_torch.telemetry import sidecar

from torch_env import default_knob_env, gcs_server, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _payload_read_bytes() -> int:
    """Origin bytes requested for payloads (metadata and sidecars left out)."""
    return sum(
        nbytes
        for path, nbytes in faults.read_counters().items()
        if not path.rsplit("/", 1)[-1].startswith(".") and not path.startswith("telemetry/")
    )


def _arrays(nbytes_per_leaf=1 << 20, leaves=4, seed=0):
    return {
        f"w{i}": np.frombuffer(np.random.RandomState(seed * 100 + i).bytes(nbytes_per_leaf), np.uint8).copy()
        for i in range(leaves)
    }


def _state(arrays):
    return {"m": ts.StateDict({k: torch.from_numpy(v.copy()) for k, v in arrays.items()})}


def _zeros(arrays):
    return {"m": ts.StateDict({k: torch.zeros(v.shape, dtype=torch.uint8) for k, v in arrays.items()})}


def _assert_equal(dst, arrays):
    for k, v in arrays.items():
        assert dst["m"][k].numpy().tobytes() == v.tobytes(), k


# ------------------------------------------------------------- cache basics


def test_second_restore_served_from_cache(tmp_path):
    arrays = _arrays()
    snap = ts.Snapshot.take(str(tmp_path / "root" / "step_1"), _state(arrays))
    with knobs.override_cache_dir(str(tmp_path / "cache")), knobs.override_faults("none"):
        faults.reset_read_counters()
        snap.restore(_zeros(arrays))
        first_origin = _payload_read_bytes()
        faults.reset_read_counters()
        dst = _zeros(arrays)
        snap.restore(dst)
        second_origin = _payload_read_bytes()
    _assert_equal(dst, arrays)
    assert first_origin == 4 << 20
    assert second_origin == 0, (first_origin, second_origin)


def test_read_object_and_state_dict_for_key_served_from_cache(tmp_path):
    arrays = _arrays(nbytes_per_leaf=1 << 18)
    with knobs.override_batching_disabled(True):  # whole-object reads
        snap = ts.Snapshot.take(str(tmp_path / "root" / "step_1"), _state(arrays))
    with knobs.override_cache_dir(str(tmp_path / "cache")), knobs.override_faults("none"):
        snap.restore(_zeros(arrays))
        faults.reset_read_counters()
        got = snap.read_object("0/m/w2", device="cpu")
        sd = snap.get_state_dict_for_key("m", device="cpu")
        assert _payload_read_bytes() == 0
    assert got.numpy().tobytes() == arrays["w2"].tobytes()
    assert {k: v.numpy().tobytes() for k, v in sd.items()} == {k: v.tobytes() for k, v in arrays.items()}


def test_cache_sidecar(tmp_path):
    """The restore sidecar records the hit/miss byte split (the metrics
    half of the JAX case waits for the port's metrics module)."""
    arrays = _arrays()
    path = str(tmp_path / "root" / "step_1")
    snap = ts.Snapshot.take(path, _state(arrays))
    with knobs.override_cache_dir(str(tmp_path / "cache")):
        snap.restore(_zeros(arrays))
        snap.restore(_zeros(arrays))
    storage = url_to_storage_plugin(path)
    try:
        all_docs = sidecar.read_all(storage)
    finally:
        storage.sync_close()
    docs = [d for d in all_docs if d.get("action") == "restore"]
    caches = sorted((d["cache"]["hit_bytes"], d["cache"]["miss_bytes"]) for d in docs)
    assert caches == [(0, 4 << 20), (4 << 20, 0)]
    take_docs = [d for d in all_docs if d.get("action") == "take"]
    assert take_docs and all("cache" not in d for d in take_docs)


def test_manager_journal_replay_served_from_cache(tmp_path):
    """``restore_latest`` replays a journal segment over its base through
    ``Snapshot.restore``, so the second replay reads no origin byte."""
    root = str(tmp_path / "run")
    base = _arrays(nbytes_per_leaf=1 << 17, leaves=3, seed=21)
    changed = dict(base, w0=_arrays(nbytes_per_leaf=1 << 17, leaves=1, seed=99)["w0"])
    with knobs.override_batching_disabled(True):
        mgr = ts.SnapshotManager(root, journal=True)
        mgr.save(1, _state(base))
        mgr.save(2, _state(changed))
    assert os.path.isdir(os.path.join(root, "seg_2"))
    with knobs.override_cache_dir(str(tmp_path / "cache")), knobs.override_faults("none"):
        ts.SnapshotManager(root, journal=True).restore_latest(_zeros(base))
        faults.reset_read_counters()
        dst = _zeros(base)
        assert ts.SnapshotManager(root, journal=True).restore_latest(dst) == 2
        assert _payload_read_bytes() == 0
    _assert_equal(dst, changed)


# ----------------------------------------------------------- partial reads


def _sharded_entry(arr, checksum=True):
    return ShardedArrayEntry(
        dtype=str(arr.dtype),
        shape=list(arr.shape),
        shards=[
            Shard(
                offsets=[0] * arr.ndim,
                sizes=list(arr.shape),
                tensor=TensorEntry(
                    location="piece",
                    serializer="buffer_protocol",
                    dtype=str(arr.dtype),
                    shape=list(arr.shape),
                    replicated=False,
                    checksum=integrity.digest(arr.tobytes()) if checksum else None,
                ),
            )
        ],
    )


def _plan(entry, offsets, sizes):
    """Read requests of a restore whose one target box is ``sizes`` at
    ``offsets`` of the saved tensor."""
    restore = _ShardedRestore(entry, obj_out=None)
    restore._boxes = {tuple(offsets): torch.zeros(sizes, dtype=torch.float32)}
    reqs, _ = ShardedArrayIOPreparer._plan_reads(entry, restore)
    return reqs, restore


def test_half_shard_plan_reads_under_60_percent_and_then_from_cache(tmp_path):
    """A plan covering half an entry fetches only the rows it needs from
    origin; a second such restore takes them from the cache's range-keyed
    entry."""
    arr = np.random.RandomState(0).rand(1024, 256).astype(np.float32)
    origin = url_to_storage_plugin(str(tmp_path))
    origin.sync_write(WriteIO(path="piece", buf=arr.tobytes()))
    origin.sync_close()
    entry = _sharded_entry(arr)
    with knobs.override_partial_read_min_saved_bytes(1024), knobs.override_faults("none"):
        for expected_origin in (512 * 256 * 4, 0):
            reqs, restore = _plan(entry, [0, 0], [512, 256])
            assert [r.byte_range for r in reqs] == [[0, 512 * 256 * 4]]
            faults.reset_read_counters()
            counted = cache_mod.CacheReaderPlugin(
                url_to_storage_plugin(str(tmp_path)), cache_mod.CacheStore(str(tmp_path / "cache")), "ns"
            )
            try:
                sync_execute_read_reqs(reqs, counted, 1 << 30, 0)
            finally:
                counted.sync_close()
            origin_bytes = _payload_read_bytes()
            assert origin_bytes == expected_origin and origin_bytes < 0.6 * arr.nbytes
            assert np.array_equal(restore.box((0, 0)).numpy(), arr[:512])


def test_partial_read_interior_span_and_knob_off():
    arr = np.arange(1024 * 16, dtype=np.float32).reshape(1024, 16)
    entry = _sharded_entry(arr)
    with knobs.override_partial_read_min_saved_bytes(64):
        reqs, _ = _plan(entry, [256, 0], [128, 16])
        # Rows [256, 384) at 64 bytes per row.
        assert reqs[0].byte_range == [256 * 64, 384 * 64]
        # The shrunk piece drops the whole-payload digest.
        assert reqs[0].buffer_consumer._piece_entry.checksum is None
    with knobs.override_partial_reads(False):
        reqs, _ = _plan(entry, [256, 0], [128, 16])
        assert reqs[0].byte_range is None
    with knobs.override_partial_read_min_saved_bytes(1 << 30):
        reqs, _ = _plan(entry, [256, 0], [128, 16])
        assert reqs[0].byte_range is None  # the saving is under the floor


def test_partial_read_full_plan_keeps_checksum():
    arr = np.ones((64, 8), np.float32)
    entry = _sharded_entry(arr)
    reqs, _ = _plan(entry, [0, 0], [64, 8])
    assert reqs[0].byte_range is None
    assert reqs[0].buffer_consumer._piece_entry.checksum is not None


# ------------------------------------------------------- cache under faults


def test_chaos_restore_through_faults_over_cache(tmp_path):
    """Restores through the fault wrapper (latency, then a terminal origin
    fault mid-restore) stay byte-correct, the failure leaves no poisoned
    entry, and the retry mixes the partly populated cache with origin."""
    arrays = _arrays(leaves=4, seed=5)
    path = str(tmp_path / "root" / "step_1")
    with knobs.override_batching_disabled(True):  # one payload per leaf
        snap = ts.Snapshot.take(path, _state(arrays))
    with knobs.override_cache_dir(str(tmp_path / "cache_a")):
        with knobs.override_faults("read:1:latency:0.01;read:3:latency:0.01"):
            dst = _zeros(arrays)
            snap.restore(dst)
        _assert_equal(dst, arrays)
    with knobs.override_cache_dir(str(tmp_path / "cache_b")):
        with knobs.override_faults("read:2:terminal@0/m/*"):
            with pytest.raises(Exception):
                ts.Snapshot(path).restore(_zeros(arrays))
        with knobs.override_faults("read:1:latency:0.005"):
            dst2 = _zeros(arrays)
            ts.Snapshot(path).restore(dst2)
        _assert_equal(dst2, arrays)


# -------------------------------------------------- concurrent restore procs

# One serving worker: restores every key of the snapshot through the port
# (the cache comes from TPUSNAP_CACHE_DIR) and prints its bytes, the sha1
# of each tensor and this process's cache totals.
_WORKER = """
import hashlib, json, sys
import torch
import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu_torch import cache

assert "jax" not in sys.modules
snap = ts.Snapshot(sys.argv[1])
keys = sorted({p.split("/", 2)[1] for p in snap.metadata.manifest if "/" in p})
nbytes, digests = 0, {}
for key in keys:
    for name, value in snap.get_state_dict_for_key(key, device="cpu").items():
        if isinstance(value, torch.Tensor):
            nbytes += value.numel() * value.element_size()
            digests[f"{key}/{name}"] = hashlib.sha1(value.numpy().tobytes()).hexdigest()
assert "jax" not in sys.modules
print(json.dumps({"bytes": nbytes, "digests": digests, **cache.process_stats()}))
"""


def _spawn_serve_workers(snap_path, n, cache_dir):
    env = dict(os.environ)  # default_knob_env left no TPUSNAP_ knob set
    env["TPUSNAP_CACHE_DIR"] = cache_dir
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, snap_path],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
            cwd=REPO_ROOT,
        )
        for _ in range(n)
    ]
    docs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-2000:]
        docs.append(json.loads(out.strip().splitlines()[-1]))
    return docs


def _assert_serve_outcome(docs, arrays, n):
    logical = sum(v.nbytes for v in arrays.values())
    want = {f"m/{k}": hashlib.sha1(v.tobytes()).hexdigest() for k, v in arrays.items()}
    assert all(d["digests"] == want for d in docs)
    total = sum(d["bytes"] for d in docs)
    assert total == n * logical
    origin = sum(d["miss_bytes"] for d in docs)
    hit = sum(d["hit_bytes"] for d in docs)
    # One host-shared cache: the workers pull the snapshot from origin
    # about once (the per-key populate lock single-flights cold fetches).
    assert origin <= 1.25 * logical, (origin, logical)
    assert hit + origin == total
    return origin, hit


def test_two_worker_concurrent_restore_fast(tmp_path):
    arrays = _arrays(nbytes_per_leaf=1 << 20, leaves=4, seed=8)
    snap_path = str(tmp_path / "root" / "step_1")
    ts.Snapshot.take(snap_path, _state(arrays))
    docs = _spawn_serve_workers(snap_path, 2, str(tmp_path / "cache"))
    _assert_serve_outcome(docs, arrays, 2)


@pytest.mark.slow
def test_eight_worker_serve_soak(tmp_path):
    """Eight workers: at least 7/8 of the bytes come from the cache and
    origin traffic is about one snapshot."""
    arrays = _arrays(nbytes_per_leaf=1 << 21, leaves=8, seed=9)
    snap_path = str(tmp_path / "root" / "step_1")
    ts.Snapshot.take(snap_path, _state(arrays))
    docs = _spawn_serve_workers(snap_path, 8, str(tmp_path / "cache"))
    origin, hit = _assert_serve_outcome(docs, arrays, 8)
    assert hit / (hit + origin) >= 7 / 8, (hit, origin)


# ------------------------------------------------------------ fake-gcs serve


def test_serve_from_gcs_origin_downloads_once(tmp_path, gcs_server):
    """After one cache-mediated restore, later restores of a GCS snapshot
    send the bucket no download request."""
    arrays = _arrays(nbytes_per_leaf=1 << 18, leaves=2, seed=11)
    snap = ts.Snapshot.take("gs://ckpt/run/step_1", _state(arrays))
    with knobs.override_cache_dir(str(tmp_path / "cache")):
        snap.restore(_zeros(arrays))
        assert gcs_server.downloads > 0
        snap2 = ts.Snapshot("gs://ckpt/run/step_1")
        _ = snap2.metadata  # the commit marker is read from origin by design
        baseline = gcs_server.downloads
        dst = _zeros(arrays)
        snap2.restore(dst)
        assert gcs_server.downloads == baseline
    _assert_equal(dst, arrays)
