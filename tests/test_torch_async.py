"""Async take in the port: ``Snapshot.async_take`` returns once the state is
snapshot-stable, in every staging mode, and the caller may mutate, free or
reuse every tensor, array and object from then on.

Mirrors of tests/test_async_safety.py and tests/test_device_staging.py
(mode resolution and cross-rank agreement with a fake process group, the
pinned_host health and retry cycle, downgrade events, mutation after
return, PrePickled, RNG and primitives, digests in the committed manifest,
no sidecars left), plus the scheduler's PendingIOWork and the RSS profiler.

The device modes run here on the CPU: the ``cpu_as_device`` fixture widens
the residency predicate to every torch tensor and makes ``pinned_empty`` a
plain ``torch.empty``, so CPU tensors take the device and pinned_host copy
paths (which make stream and event calls only for CUDA tensors).  No test
holds a wall-clock threshold: "async_take did not wait for storage" is
proven by a storage whose writes block on an event that the test sets only
after async_take has returned.  Every comparison is exact (bytes)."""

import asyncio
import threading

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import (
    RNGState,
    Snapshot,
    StateDict,
    device_staging,
    event_handlers,
    knobs,
    staging,
)
from torchsnapshot_tpu_torch.io_preparers.array import ArrayBufferStager
from torchsnapshot_tpu_torch.manifest import TensorEntry
from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
from torchsnapshot_tpu_torch.rss_profiler import RSSWatermark, measure_rss_deltas, rss_bytes
from torchsnapshot_tpu_torch.scheduler import sync_execute_write_reqs
from torchsnapshot_tpu_torch.serialization import PrePickled
from torchsnapshot_tpu_torch.snapshot import _ManifestFinalizer
from torchsnapshot_tpu_torch.storage_plugins import memory as memory_mod

MODES = ["device", "pinned_host", "host"]
_GATE_TIMEOUT_S = 60.0


@pytest.fixture(autouse=True)
def _clean_health():
    device_staging.reset_pinned_host_health()
    yield
    device_staging.reset_pinned_host_health()


@pytest.fixture
def cpu_as_device(monkeypatch):
    monkeypatch.setattr(device_staging, "_is_device_resident", lambda obj: isinstance(obj, torch.Tensor))
    monkeypatch.setattr(staging, "pinned_empty", lambda n: torch.empty(n, dtype=torch.uint8))


@pytest.fixture
def events():
    seen = []
    event_handlers.register_event_handler(seen.append)
    yield seen
    event_handlers.unregister_event_handler(seen.append)


def _bits(t) -> bytes:
    if isinstance(t, np.ndarray):
        return t.tobytes()
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(64, 32, generator=g),
        "b": torch.randn(16, generator=g).to(torch.bfloat16),
        "nc": torch.randn(8, 24, generator=g).t(),  # non-contiguous
        "p": torch.nn.Parameter(torch.randn(12, generator=g)),
        "i": torch.arange(10, dtype=torch.int64),
    }


class _GatedMemory(memory_mod.MemoryStoragePlugin):
    """Memory storage whose writes wait (off the event loop) for ``gate``."""

    gate = threading.Event()

    async def write(self, write_io):
        gate = type(self).gate
        if not await asyncio.get_running_loop().run_in_executor(None, gate.wait, _GATE_TIMEOUT_S):
            raise TimeoutError("the storage gate never opened")
        await super().write(write_io)


@pytest.fixture
def gated_memory(monkeypatch):
    gate = threading.Event()

    class Gated(_GatedMemory):
        pass

    Gated.gate = gate
    monkeypatch.setattr(memory_mod, "MemoryStoragePlugin", Gated)
    yield Gated
    gate.set()
    memory_mod._REGISTRY.clear()


# ---------------------------------------------------------------- mode resolution


def test_resolve_host_when_forced(cpu_as_device):
    with knobs.override_async_staging("host"):
        assert device_staging.resolve_mode({"m/w": torch.ones(4)}) == "host"


def test_resolve_host_when_no_device_tensors():
    # Nothing needs a D2H copy (CPU tensors are not device-resident).
    flattened = {"m/w": np.ones(4), "m/t": torch.ones(4), "m/step": 3, "m/obj": ["a"]}
    with knobs.override_async_staging("auto"):
        assert device_staging.resolve_mode(flattened) == "host"


def test_resolve_device_when_forced(cpu_as_device):
    with knobs.override_async_staging("device"):
        assert device_staging.resolve_mode({"m/w": torch.ones(4)}) == "device"


def test_resolve_auto_prefers_pinned_host(cpu_as_device):
    with knobs.override_async_staging("auto"):
        assert device_staging.resolve_mode({"m/w": torch.ones(4)}) == "pinned_host"


def test_resolve_rejects_bad_mode():
    with knobs.override_async_staging("gpu"):
        with pytest.raises(ValueError):
            device_staging.configured_mode()


class _FakePG:
    def __init__(self, peer_signals):
        self._peer = peer_signals

    def get_world_size(self):
        return 2

    def all_gather_object(self, obj):
        return [obj, self._peer]


def test_resolve_mode_collective_agreement(cpu_as_device):
    """Ranks with diverging local signals agree on the most conservative
    mode."""
    pg = _FakePG({"mode": "host", "device_fits": False})
    with knobs.override_async_staging("auto"):
        assert device_staging.resolve_mode({"m/w": torch.ones(4)}, pg=pg) == "host"


def test_resolve_mode_empty_rank_is_wildcard(cpu_as_device):
    """A rank holding no device tensors must not drag its peers into host
    staging."""
    pg = _FakePG({"mode": "host", "device_fits": True, "any_ok": True})
    with knobs.override_async_staging("auto"):
        assert device_staging.resolve_mode({"m/w": torch.ones(4)}, pg=pg) == "pinned_host"


def test_resolve_mode_agreement_respects_device_capability(cpu_as_device, monkeypatch):
    """A rank preferring pinned_host that cannot hold a device copy is not
    agreement-downgraded into one: everyone takes host."""
    monkeypatch.setattr(device_staging, "_hbm_headroom_fits", lambda tensors: False)
    pg = _FakePG({"mode": "device", "device_fits": True})
    with knobs.override_async_staging("auto"):
        assert device_staging.resolve_mode({"m/w": torch.ones(4)}, pg=pg) == "host"


def test_agreement_downgrade_emits_event_only_when_staging(cpu_as_device, events):
    pg = _FakePG({"mode": "host", "device_fits": True})
    with knobs.override_async_staging("auto"):
        assert device_staging.resolve_mode({"m/w": torch.ones(4)}, pg=pg) == "host"
    assert not [e for e in events if e.name == "async_take.staging_downgrade"]
    with knobs.override_async_staging("auto"):
        assert device_staging.resolve_mode({"m/w": torch.ones(4)}, pg=pg, emit_events=True) == "host"
    downgrades = [e for e in events if e.name == "async_take.staging_downgrade"]
    assert downgrades and "agreement" in downgrades[-1].metadata["reason"]


def test_resolve_mode_mixed_platform_probe(cpu_as_device, monkeypatch):
    """pinned_host support and health are consulted for every platform in
    the state, not the first tensor's."""
    a, b = torch.ones(4), torch.ones(8)
    plat = {id(a): "cpu", id(b): "exotic"}
    monkeypatch.setattr(device_staging, "_platform_of", lambda t: plat.get(id(t), "cpu"))
    device_staging.record_pinned_host_failure("exotic")
    with knobs.override_async_staging("auto"):
        assert device_staging.resolve_mode({"m/a": a, "m/b": b}) == "device"
    device_staging.reset_pinned_host_health()
    with knobs.override_async_staging("auto"):
        assert device_staging.resolve_mode({"m/a": a, "m/b": b}) == "pinned_host"


def test_pinned_host_health_retry_cycle(monkeypatch):
    """A failure skips pinned_host for the backoff window, then allows a
    retry; the predicate is pure.  Time passing is simulated by moving the
    recorded failure back, not by sleeping."""
    monkeypatch.setenv(knobs.PINNED_HOST_RETRY_S_ENV_VAR, "300")
    device_staging.record_pinned_host_failure("cuda")
    assert not device_staging._pinned_host_usable("cuda")
    assert not device_staging._pinned_host_usable("cuda")  # pure: no decay
    device_staging._PINNED_HOST_HEALTH["cuda"]["last_failure"] -= 301
    assert device_staging._pinned_host_usable("cuda")  # backoff passed: retry
    device_staging.record_pinned_host_failure("cuda")
    assert not device_staging._pinned_host_usable("cuda")
    assert device_staging._PINNED_HOST_HEALTH["cuda"]["failures"] == 2
    device_staging.reset_pinned_host_health()
    assert device_staging._pinned_host_usable("cuda")


def test_hbm_headroom_ignores_host_tensors():
    assert device_staging._hbm_headroom_fits({"m/w": torch.ones(1 << 20)})


# ------------------------------------------------------ donation safety, all modes


@pytest.mark.parametrize("mode", MODES)
def test_async_roundtrip_with_mutation_after_return(tmp_path, cpu_as_device, events, mode):
    """Mutate every tensor in place and rebind (free) one right after
    return: the snapshot holds the values at the time of the take."""
    app_state = {"m": StateDict(_tensors())}
    expected = {k: _bits(v) for k, v in app_state["m"].items()}
    with knobs.override_async_staging(mode):
        pending = Snapshot.async_take(str(tmp_path / "snap"), app_state)
    with torch.no_grad():
        for t in app_state["m"].values():
            t.fill_(-7)
    app_state["m"]["w"] = torch.full((64, 32), 7.0)  # the old block is released
    assert pending.staging_mode == mode
    snapshot = pending.wait()
    dst = {k: torch.zeros_like(v.detach()) for k, v in _tensors(seed=1).items()}
    dst["nc"] = torch.zeros(24, 8)
    snapshot.restore({"m": StateDict(dst)})
    for k, v in expected.items():
        assert _bits(dst[k]) == v, k
    assert not [e for e in events if e.name == "async_take.staging_downgrade"]
    names = [e.name for e in events]
    assert names[0] == "async_take.start" and "async_take.end" in names
    assert ("async_take.device_staged" in names) == (mode != "host")


@pytest.mark.parametrize("mode", ["device", "pinned_host"])
def test_staging_mode_and_stage_stats(tmp_path, cpu_as_device, mode):
    from torchsnapshot_tpu_torch import phase_stats

    state = _tensors()
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    phase_stats.reset()
    with knobs.override_async_staging(mode):
        pending = Snapshot.async_take(str(tmp_path / "snap"), {"m": StateDict(state)})
        pending.wait()
    assert pending.staging_mode == mode
    assert phase_stats.snapshot()["device_stage"]["bytes"] == nbytes


def test_device_staging_copies_each_chunked_leaf_once(tmp_path, cpu_as_device):
    """A leaf cut into chunks is staged with one copy that its chunks view;
    a view that does not tile its storage is copied alone.  The restore
    holds the values at the take."""
    from torchsnapshot_tpu_torch import phase_stats

    state = {
        "w": torch.arange(4096, dtype=torch.float32),
        "v": torch.arange(64, dtype=torch.float32).reshape(8, 8)[:, :4],
    }
    expected = {k: _bits(v) for k, v in state.items()}
    staged = []
    real_stage = device_staging.stage_app_state

    def stage(flattened, mode):
        out, stats = real_stage(flattened, mode)
        staged.append(out)
        return out, stats

    phase_stats.reset()
    with knobs.override_max_chunk_size_bytes(4096), knobs.override_async_staging("device"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(device_staging, "stage_app_state", stage)
            pending = Snapshot.async_take(str(tmp_path / "snap"), {"m": StateDict(state)})
    for t in state.values():
        t.fill_(-1)
    snapshot = pending.wait()
    stats = phase_stats.snapshot()
    assert stats["stage_alloc"]["n"] == 2
    assert stats["stage_alloc"]["bytes"] == stats["device_stage"]["bytes"] == 4096 * 4 + 32 * 4
    (copies,) = staged
    assert len(copies) == 5  # four chunks of w and v
    assert len({c.untyped_storage().data_ptr() for c in copies.values()}) == 2
    dst = {"w": torch.zeros(4096), "v": torch.zeros(8, 4)}
    snapshot.restore({"m": StateDict(dst)})
    assert {k: _bits(v) for k, v in dst.items()} == expected


def test_host_mutation_after_async_take(tmp_path):
    """Host mode (the only mode without a card): CPU tensors and numpy
    arrays are copied when staged, before async_take returns."""
    arr = np.arange(1024, dtype=np.float32)
    t = torch.arange(256, dtype=torch.float64)
    pending = Snapshot.async_take(str(tmp_path / "snap"), {"m": StateDict({"a": arr, "t": t})})
    assert pending.staging_mode == "host"
    arr[:] = -1.0
    t.fill_(-1.0)
    snapshot = pending.wait()
    dst = {"m": StateDict({"a": np.zeros(1024, np.float32), "t": torch.zeros(256, dtype=torch.float64)})}
    snapshot.restore(dst)
    np.testing.assert_array_equal(dst["m"]["a"], np.arange(1024, dtype=np.float32))
    assert torch.equal(dst["m"]["t"], torch.arange(256, dtype=torch.float64))


def test_host_mode_charges_cpu_copies_to_budget():
    t = torch.ones(100, dtype=torch.float32)
    entry = TensorEntry(location="0/m/t", serializer="buffer_protocol", dtype="float32", shape=[100], replicated=False)
    assert ArrayBufferStager(t, entry).get_staging_cost_bytes() == 0
    assert ArrayBufferStager(t, entry, is_async_snapshot=True).get_staging_cost_bytes() == 400


@pytest.mark.parametrize("mode", ["device", "pinned_host"])
def test_np_array_and_cpu_tensor_mutation_after_return(tmp_path, cpu_as_device, monkeypatch, mode):
    """With a device mode, numpy arrays are copied on the caller's thread."""
    arr = np.arange(512, dtype=np.float32)
    with knobs.override_async_staging(mode):
        pending = Snapshot.async_take(
            str(tmp_path / "snap"), {"m": StateDict({"host": arr, "dev": torch.ones(8)})}
        )
    arr[:] = -5.0
    snapshot = pending.wait()
    dst = {"m": StateDict({"host": np.zeros(512, np.float32), "dev": torch.zeros(8)})}
    snapshot.restore(dst)
    np.testing.assert_array_equal(dst["m"]["host"], np.arange(512, dtype=np.float32))


def test_object_mutation_after_return(tmp_path, cpu_as_device):
    log = ["step_100"]
    with knobs.override_async_staging("device"):
        pending = Snapshot.async_take(str(tmp_path / "snap"), {"m": StateDict({"log": log, "dev": torch.ones(8)})})
    log.append("step_101")  # before the background pickling would run
    dst = {"m": StateDict({"dev": torch.zeros(8)})}
    pending.wait().restore(dst)
    assert dst["m"]["log"] == ["step_100"]


def test_rng_and_primitives_survive_device_staging(tmp_path, cpu_as_device):
    torch.manual_seed(7)
    app_state = {
        "m": StateDict({"step": 42, "lr": 1e-3, "name": "run", "dev": torch.full((8,), 2.0)}),
        "rng": RNGState(),
    }
    with knobs.override_async_staging("device"):
        pending = Snapshot.async_take(str(tmp_path / "snap"), app_state)
    expected = torch.rand(4)
    snapshot = pending.wait()
    torch.manual_seed(0)
    dst = {"m": StateDict({"dev": torch.zeros(8)}), "rng": RNGState()}
    snapshot.restore(dst)
    assert dst["m"]["step"] == 42 and dst["m"]["lr"] == 1e-3 and dst["m"]["name"] == "run"
    assert torch.equal(torch.rand(4), expected)


def test_checksums_present_in_committed_manifest(tmp_path, cpu_as_device):
    """Device staging moves digest computation to the background thread;
    the committed manifest still carries them."""
    with knobs.override_async_staging("device"):
        snapshot = Snapshot.async_take(str(tmp_path / "snap"), {"m": StateDict({"w": torch.ones(64, 64)})}).wait()
    assert [e for e in snapshot.get_manifest().values() if getattr(e, "checksum", None)]
    reread = Snapshot(str(tmp_path / "snap")).get_manifest()
    assert reread["0/m/w"].checksum == snapshot.get_manifest()["0/m/w"].checksum is not None


def test_no_sidecars_left_behind(tmp_path, cpu_as_device):
    with knobs.override_async_staging("device"):
        Snapshot.async_take(str(tmp_path / "snap"), {"m": StateDict({"w": torch.ones(64)})}).wait()
    assert [p.name for p in (tmp_path / "snap").iterdir() if "manifest_rank" in p.name] == []


def test_prepickled_holds_bytes():
    p = PrePickled({"a": 1})
    assert isinstance(p.data, bytes) and p.obj_type == "dict"


def test_staging_fallback_chain_end_to_end(tmp_path, cpu_as_device, monkeypatch, events):
    """pinned_host → device → host, forced by failing copies: the snapshot
    still commits bit-exact, the resolved mode is honest, every downgrade
    is an event, and the failure is recorded against the platform."""

    def boom(tensors):
        raise RuntimeError("forced copy failure")

    monkeypatch.setattr(device_staging, "_pinned_host_copy_batch", boom)
    monkeypatch.setattr(device_staging, "_device_copy_batch", boom)
    x = torch.arange(64, dtype=torch.float32)
    with knobs.override_async_staging("pinned_host"):
        pending = Snapshot.async_take(str(tmp_path / "snap"), {"m": StateDict({"w": x})})
        snapshot = pending.wait()
    assert pending.staging_mode == "host"
    dst = {"m": StateDict({"w": torch.zeros(64)})}
    snapshot.restore(dst)
    assert torch.equal(dst["m"]["w"], torch.arange(64, dtype=torch.float32))
    downgrades = [(e.metadata["from_mode"], e.metadata["to_mode"]) for e in events if e.name == "async_take.staging_downgrade"]
    assert ("pinned_host", "device") in downgrades
    assert any(to == "host" for _, to in downgrades)
    assert not device_staging._pinned_host_usable("cpu")


def test_async_take_end_event_telemetry(tmp_path, cpu_as_device, events):
    with knobs.override_async_staging("device"):
        Snapshot.async_take(str(tmp_path / "snap"), {"m": StateDict({"w": torch.ones(64, 64)})}).wait()
    md = [e for e in events if e.name == "async_take.end"][-1].metadata
    assert md["is_success"] is True and md["staging_mode"] == "device"
    assert md["copy_bytes"] == 64 * 64 * 4 and md["bytes"] > 0
    assert md["stall_s"] >= 0.0 and "copy_s" in md and "downgraded_from" not in md


# ------------------------------------------------------- the early-return contract


@pytest.mark.parametrize("mode", MODES)
def test_async_take_not_blocked_by_storage(gated_memory, cpu_as_device, mode):
    """Every write waits for a gate that opens only after async_take has
    returned: had the return waited for storage, the gate's timeout would
    fail the take.  No write finishes before the gate opens."""
    state = {"w": torch.arange(4096, dtype=torch.float32), "a": np.arange(100)}
    with knobs.override_async_staging(mode):
        pending = Snapshot.async_take("memory://gated", {"m": StateDict(state)})
    assert not pending.done()
    assert memory_mod._REGISTRY.get("gated", {}) == {}  # nothing written yet
    gated_memory.gate.set()
    snapshot = pending.wait()
    dst = {"m": StateDict({"w": torch.zeros(4096), "a": np.zeros(100, dtype=np.int64)})}
    snapshot.restore(dst)
    assert torch.equal(dst["m"]["w"], torch.arange(4096, dtype=torch.float32))
    np.testing.assert_array_equal(dst["m"]["a"], np.arange(100))


def test_progress_done_and_callbacks(gated_memory):
    seen = []
    pending = Snapshot.async_take("memory://gated", {"m": StateDict({"w": torch.ones(8)})})
    pending.add_done_callback(seen.append)
    progress = pending.progress()
    assert progress["action"] == "async_take" and progress["done"] is False and progress["success"] is None
    gated_memory.gate.set()
    pending.wait()
    assert pending.done() and seen == [pending]
    assert pending.progress()["success"] is True
    late = []
    pending.add_done_callback(late.append)  # already done: runs at once
    assert late == [pending]


def test_failure_before_commit_cleans_up(tmp_path, cpu_as_device, monkeypatch, events):
    """A write failure on the background thread (device mode: the whole
    pipeline runs there) surfaces from wait(), the partial snapshot is
    removed, and async_take.end reports the failure."""
    from torchsnapshot_tpu_torch.storage_plugins import fs as fs_mod

    class Broken(fs_mod.FSStoragePlugin):
        async def write(self, write_io):
            if not write_io.path.startswith("."):
                raise PermissionError("denied")
            await super().write(write_io)

    monkeypatch.setattr(fs_mod, "FSStoragePlugin", Broken)
    with knobs.override_async_staging("device"):
        pending = Snapshot.async_take(str(tmp_path / "snap"), {"m": StateDict({"w": torch.ones(8)})})
    with pytest.raises(PermissionError):
        pending.wait()
    assert isinstance(pending.exception, PermissionError)
    assert not (tmp_path / "snap" / ".snapshot_metadata").exists()
    assert not (tmp_path / "snap").exists() or not any((tmp_path / "snap").iterdir())
    end = [e for e in events if e.name == "async_take.end"][-1]
    assert end.metadata["is_success"] is False


def test_two_async_takes_back_to_back(tmp_path, cpu_as_device):
    with knobs.override_async_staging("device"):
        p1 = Snapshot.async_take(str(tmp_path / "s1"), {"m": StateDict({"w": torch.full((64,), 1.0)})})
        p2 = Snapshot.async_take(str(tmp_path / "s2"), {"m": StateDict({"w": torch.full((64,), 2.0)})})
    for p, v in ((p1, 1.0), (p2, 2.0)):
        dst = {"m": StateDict({"w": torch.zeros(64)})}
        p.wait().restore(dst)
        assert torch.equal(dst["m"]["w"], torch.full((64,), v))


# --------------------------------------------------- scheduler: PendingIOWork


def test_pending_io_work_first_failure_cancels_the_rest(gated_memory):
    """sync_complete raises the first write failure while a sibling write
    is still parked, cancels it, and closes the loop.  The failing write
    waits for its own gate, opened once staging has returned."""
    from torchsnapshot_tpu_torch import io_preparer

    fail_gate = threading.Event()

    class FailOne(gated_memory):
        async def write(self, write_io):
            if write_io.path.endswith("bad"):
                await asyncio.get_running_loop().run_in_executor(None, fail_gate.wait, _GATE_TIMEOUT_S)
                raise PermissionError("denied")
            await super().write(write_io)

    storage = FailOne(root="gated")
    reqs = []
    for name in ("good", "bad"):
        _, r = io_preparer.prepare_write(torch.ones(4), f"m/{name}", rank=0)
        reqs += r
    pending = sync_execute_write_reqs(reqs, storage, 1 << 20, rank=0)
    fail_gate.set()
    with pytest.raises(PermissionError):
        pending.sync_complete()
    assert all(t.done() for t in pending._io_tasks)
    assert any(t.cancelled() for t in pending._io_tasks)
    assert pending._loop.is_closed()


# ------------------------------------------------------------ manifest finalizer


def test_manifest_finalizer_sidecar_exchange():
    """World size 2 through storage: rank 1 writes its sidecar, rank 0
    merges it under the rank prefixes and removes it after the commit."""
    storage = memory_mod.MemoryStoragePlugin(root="finalizer")
    try:
        e0 = TensorEntry(location="0/m/w", serializer="buffer_protocol", dtype="float32", shape=[2], replicated=False)
        e1 = TensorEntry(location="1/m/w", serializer="buffer_protocol", dtype="float32", shape=[3], replicated=False)
        f0 = _ManifestFinalizer({"m/w": e0}, rank=0, world_size=2, staging_mode="device")
        f1 = _ManifestFinalizer({"m/w": e1}, rank=1, world_size=2, staging_mode="device")
        f0.write_sidecar(storage)  # rank 0 writes none
        f1.write_sidecar(storage)
        assert storage.sync_exists(".manifest_rank_1") and not storage.sync_exists(".manifest_rank_0")
        metadata = f0.build_global(storage)
        assert metadata.world_size == 2
        assert sorted(metadata.manifest) == ["0/m/w", "1/m/w"]
        assert metadata.manifest["1/m/w"].shape == [3]
        f0.cleanup_sidecars(storage)
        assert not storage.sync_exists(".manifest_rank_1")
    finally:
        memory_mod.MemoryStoragePlugin.reset("finalizer")


def test_manifest_finalizer_world_size_one_matches_sync_gather():
    e = TensorEntry(location="0/m/w", serializer="buffer_protocol", dtype="float32", shape=[2], replicated=False)
    metadata = _ManifestFinalizer({"m/w": e}, rank=0, world_size=1, staging_mode="host").build_global(None)
    assert metadata.world_size == 1
    assert metadata.manifest == Snapshot._gather_manifest({"m/w": e}, PGWrapper())


# ------------------------------------------------------------------ rss_profiler


def test_rss_watermark_is_monotone():
    wm = RSSWatermark()
    assert wm.baseline > 0 and wm.high_water == wm.baseline
    block = np.ones(32 << 20, dtype=np.uint8)  # 32 MiB, touched
    assert wm.sample() > 0
    assert wm.high_water >= wm.baseline and wm.delta >= 0
    high = wm.high_water
    del block
    wm.sample()
    assert wm.high_water >= high


def test_measure_rss_deltas_samples():
    deltas = []
    with measure_rss_deltas(deltas, interval_ms=1.0):
        np.ones(8 << 20, dtype=np.uint8).sum()
    assert len(deltas) >= 2
    assert rss_bytes() > 0
