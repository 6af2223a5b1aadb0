"""The port's sampling profiler (torchsnapshot_tpu_torch/telemetry/profiler.py),
mirroring tests/test_profiler.py: profiling off by default and at Hz 0, the
per-rank merge, schema validation, the monitor's driver tag, the busy/sleep
split, ``sample_burst``, and a profiled take and restore writing valid file
pairs; plus the attribution hooks of the port's scheduler (executor workers
inherit the submitter's phase, the drain samples as ``io_drain_drive``) and
the profiler's own failures costing only the profile.

The sampler's on/off-CPU split depends on the host's scheduler, so no case
here asserts a tick count or a share under a wall clock: ticks are driven by
hand through ``Sampler._sample_once``, with ``_thread_cpu_times`` replaced by
a synthetic reader where the state matters, and each case asserts only what
it drove.  Knobs are set through ``knobs.override_*``."""

import asyncio
import json
import logging
import os
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, event_handlers, knobs, phase_stats, scheduler
from torchsnapshot_tpu_torch.faults import FaultInjectionError
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.telemetry import monitor, profiler

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

# "<phase>;<on|off>cpu;<frame>;...;<frame> <count>"
_COLLAPSED = re.compile(r"^[^;]+;(?:on|off)cpu;.+ [1-9]\d*$")


@pytest.fixture(autouse=True)
def _no_leaks():
    drivers = {ident: list(tags) for ident, tags in phase_stats._driver_tags.items()}
    yield
    assert monitor._ACTIVE == [], "leaked op monitors"
    assert profiler._OPS == [], "leaked profiler ops"
    assert profiler._SAMPLER is None, "leaked shared sampler"
    assert phase_stats._driver_tags == drivers, "leaked driver tags"


def _profile_files(dirpath):
    return sorted(p for p in os.listdir(dirpath) if p.endswith(profiler.PROFILE_FILE_SUFFIX))


def _state():
    return {"m": StateDict({"w": torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64)})}


def _synthetic_meta(rank, stacks, hz=100.0, kind="restore", op="feed" * 8):
    samples = sum(n for states in stacks.values() for b in states.values() for n in b.values())
    oncpu = sum(n for states in stacks.values() for n in (states.get("on") or {}).values())
    return {
        "schema": profiler.PROFILE_SCHEMA,
        "op": op,
        "kind": kind,
        "rank": rank,
        "hz": hz,
        "weight_s": 1.0 / hz,
        "duration_s": 2.0 + rank,
        "ticks": samples,
        "samples_total": samples,
        "oncpu_samples": oncpu,
        "untagged_oncpu": 0,
        "success": True,
        "host": f"host{rank}",
        "stacks": stacks,
        "calibration": {"per_tick_s": 1e-5, "ticks": samples, "estimated_s": 1e-5 * samples},
    }


# ------------------------------------------------------------ off switches


def test_profiling_off_by_default():
    assert knobs.get_profile_dir() is None
    assert knobs.get_profile_hz() == 99.0
    assert not profiler.enabled()
    assert profiler.begin_op("take", "beef" * 8, rank=0) is None
    assert profiler.end_op(None) is None


def test_hz_zero_disables_cleanly(tmp_path):
    """TPUSNAP_PROFILE_HZ=0 with a profile directory set: no sampler thread,
    no profile file, begin_op returns None."""
    with knobs.override_profile_dir(str(tmp_path)), knobs.override_profile_hz(0):
        assert not profiler.enabled()
        assert knobs.get_profile_hz() == 0.0
        assert profiler.begin_op("take", "dead" * 8, rank=0) is None
        Snapshot.take(str(tmp_path / "snap"), _state())
    assert not any(t.name == "tpusnap-torch-profiler" for t in threading.enumerate())
    assert _profile_files(tmp_path) == []


# ------------------------------------------------------- merge + validation


def test_per_rank_merge(tmp_path):
    meta0 = _synthetic_meta(0, {"checksum": {"on": {"a;b;digest": 100}, "off": {"a;b;wait": 10}}})
    meta1 = _synthetic_meta(1, {"checksum": {"on": {"a;b;digest": 50}}, "fs_write": {"off": {"a;io": 7}}})
    paths = []
    for meta in (meta0, meta1):
        p = tmp_path / f"{meta['kind']}-{meta['op'][:8]}-rank{meta['rank']}{profiler.PROFILE_FILE_SUFFIX}"
        p.write_text(json.dumps(profiler.build_document(meta)))
        paths.append(str(p))
    merged_doc = profiler.merge_profile_files(paths)
    assert profiler.validate_profile(merged_doc) == []
    merged = merged_doc["tpusnap"]
    assert merged["samples_total"] == meta0["samples_total"] + meta1["samples_total"]
    assert merged["stacks"]["checksum"]["on"]["a;b;digest"] == 150
    assert merged["stacks"]["fs_write"]["off"]["a;io"] == 7
    assert merged["duration_s"] == 3.0  # the max across ranks, not the sum
    assert len(merged["merged_from"]) == 2
    assert [d["tpusnap"]["rank"] for d in profiler.load_profile_dir(str(tmp_path))] == [0, 1]


def test_validate_profile_rejects_garbage(tmp_path):
    assert profiler.validate_profile([]) != []
    assert profiler.validate_profile({}) != []
    doc = profiler.build_document(_synthetic_meta(0, {"d2h": {"on": {"x;y": 3}}}))
    assert profiler.validate_profile(doc) == []
    bad = json.loads(json.dumps(doc))
    bad["tpusnap"]["schema"] = "wrong"
    assert any("schema" in p for p in profiler.validate_profile(bad))
    bad = json.loads(json.dumps(doc))
    bad["profiles"][0]["samples"] = [[999]]
    assert any("out of range" in p for p in profiler.validate_profile(bad))
    garbage = tmp_path / "x.profile.json"
    garbage.write_text("]]]")
    with pytest.raises(ValueError, match="unreadable profile"):
        profiler.load_profile_dir(str(tmp_path))


# ------------------------------------------------------------ sampler core


def test_busy_vs_sleep_split_and_phase_tags(monkeypatch):
    """A thread spinning inside timed("checksum") whose CPU clock advances a
    full interval per tick samples on-CPU under checksum at every tick; a
    thread parked inside timed("fs_write") whose clock stands still samples
    off-CPU under fs_write at every tick; the spinning frame is named."""
    ticks, interval = 12, 0.01
    spinning, stop = [False], [False]
    parked, release = threading.Event(), threading.Event()

    def busy_spin():
        with phase_stats.timed("checksum"):
            spinning[0] = True  # no call from here on: the leaf frame is this one
            while not stop[0]:
                pass

    def sleeper():
        with phase_stats.timed("fs_write"):
            parked.set()
            release.wait()

    threads = [threading.Thread(target=busy_spin), threading.Thread(target=sleeper)]
    for t in threads:
        t.start()
    try:
        parked.wait(5.0)
        while not spinning[0]:
            time.sleep(0.001)
        busy, sleepy = (t.native_id for t in threads)
        clock = {"busy": 0.0}

        def synthetic_cpu_times():
            clock["busy"] += interval
            return {busy: clock["busy"], sleepy: 1.0}

        monkeypatch.setattr(profiler, "_thread_cpu_times", synthetic_cpu_times)
        sampler = profiler.Sampler(hz=1.0 / interval)
        prev = profiler._thread_cpu_times()
        for _ in range(ticks):
            prev = sampler._sample_once(interval, prev)
        state = sampler.snapshot_state()
    finally:
        stop[0] = True
        release.set()
        for t in threads:
            t.join(5.0)
    assert not any(t.is_alive() for t in threads)
    assert state["ticks"] == ticks
    checksum = {st: sum(b.values()) for (ph, st), b in state["stacks"].items() if ph == "checksum"}
    fs_write = {st: sum(b.values()) for (ph, st), b in state["stacks"].items() if ph == "fs_write"}
    assert checksum == {"on": ticks}
    assert fs_write == {"off": ticks}
    hot = state["stacks"][("checksum", "on")]
    assert list(hot) and all(stack.rsplit(";", 1)[-1] == "test_torch_profiler.busy_spin" for stack in hot)
    meta = profiler._meta_from_state("take", "cafe" * 8, 0, sampler.hz, dict(state, duration_s=0.12), True)
    assert profiler.validate_profile(profiler.build_document(meta)) == []
    lines = profiler.collapsed_lines(meta)
    assert any(line.startswith("checksum;oncpu;") for line in lines)
    assert any(line.startswith("fs_write;offcpu;") for line in lines)
    assert all(_COLLAPSED.match(line) for line in lines)


def test_pool_workers_sample_under_their_creators_tag(tmp_path, monkeypatch):
    """The workers of a pool made on a thread driving an op (the scheduler's
    executors, the fs plugin's I/O pool) fall back to the op's tag between
    their items: an on-CPU sample of an idle worker (on a host that counts
    CPU time in whole ticks, a worker waiting for the GIL shows as on-CPU)
    goes to the op, not to <untagged>.  Shutdown releases the fallback."""
    ident = threading.get_ident()
    phase_stats.register_driver(ident, "restore_drive")
    try:
        pool = scheduler._PhaseInheritingExecutor(max_workers=1)
        plugin = FSStoragePlugin(str(tmp_path))
    finally:
        phase_stats.unregister_driver(ident, "restore_drive")
    try:
        worker = pool.submit(threading.get_native_id).result()
        idle = next(t for t in threading.enumerate() if t.native_id == worker)
        assert phase_stats.thread_phases()[idle.ident] == "restore_drive"
        clock = {"cpu": 0.0}

        def synthetic_cpu_times():
            clock["cpu"] += 0.01
            return {worker: clock["cpu"]}

        monkeypatch.setattr(profiler, "_thread_cpu_times", synthetic_cpu_times)
        sampler = profiler.Sampler(hz=100.0)
        sampler._sample_once(0.01, profiler._thread_cpu_times())
        state = sampler.snapshot_state()
        assert state["oncpu_samples"] == 1 and state["untagged_oncpu"] == 0
        assert sum(state["stacks"][("restore_drive", "on")].values()) == 1
        fs_worker = plugin._executor.submit(threading.get_ident).result()
        assert phase_stats.thread_phases()[fs_worker] == "restore_drive"
    finally:
        plugin.sync_close()
        pool.shutdown()
    assert idle.ident not in phase_stats._driver_tags and fs_worker not in phase_stats._driver_tags
    # A pool made on a thread with no attribution gives its workers none.
    bare = scheduler._PhaseInheritingExecutor(max_workers=1)
    try:
        assert bare.submit(lambda: phase_stats.thread_phases().get(threading.get_ident())).result() is None
    finally:
        bare.shutdown()


def test_sample_burst_returns_valid_meta():
    """sample_burst samples inline: its meta validates, holds at least one
    tick, and tags a thread parked inside timed("serialize")."""
    inside, release = threading.Event(), threading.Event()

    def worker():
        with phase_stats.timed("serialize"):
            inside.set()
            release.wait()

    t = threading.Thread(target=worker)
    t.start()
    try:
        inside.wait(5.0)
        meta = profiler.sample_burst(0.05, hz=99)
    finally:
        release.set()
        t.join(5.0)
    assert not t.is_alive()
    assert meta["kind"] == "burst" and meta["ticks"] >= 1
    assert meta["samples_total"] >= meta["ticks"]
    assert "serialize" in meta["stacks"]
    assert profiler.validate_profile(profiler.build_document(meta)) == []


# ---------------------------------------------------- attribution hooks


def test_executor_workers_inherit_the_submitters_tag():
    """The scheduler's executor runs each callable under the submitter's
    innermost phase, else its op-driver tag, else untagged; attribution
    records no time."""
    ident = threading.get_ident()
    tags = ("checksum", "compress", "d2h")
    before = {k: v for k, v in phase_stats.snapshot().items() if k in tags}
    pool = scheduler._PhaseInheritingExecutor(max_workers=1)
    try:
        assert pool.submit(phase_stats.current_phase).result() is None
        phase_stats.register_driver(ident, "take_drive")
        try:
            assert pool.submit(phase_stats.current_phase).result() == "take_drive"
            with phase_stats.tagged("checksum"):
                assert pool.submit(phase_stats.current_phase).result() == "checksum"
                with phase_stats.tagged("compress"):
                    assert pool.submit(phase_stats.current_phase).result() == "compress"
        finally:
            phase_stats.unregister_driver(ident, "take_drive")
        loop = asyncio.new_event_loop()
        try:
            with phase_stats.tagged("d2h"):
                got = loop.run_until_complete(loop.run_in_executor(pool, phase_stats.current_phase))
        finally:
            loop.close()
        assert got == "d2h"
    finally:
        pool.shutdown()
    assert {k: v for k, v in phase_stats.snapshot().items() if k in tags} == before
    assert phase_stats.current_phase() is None


def test_drain_samples_as_io_drain_drive():
    """The thread completing an async take's writes (PendingIOWork's drain)
    samples as io_drain_drive while its loop runs the write tasks."""
    loop = asyncio.new_event_loop()
    pool = ThreadPoolExecutor(max_workers=1)
    sampler = profiler.Sampler(hz=99.0)
    drain_ident = threading.get_ident()
    seen = {}

    def tick():
        sampler._sample_once(0.01, profiler._thread_cpu_times())
        seen["phases"] = phase_stats.thread_phases()

    async def write():
        seen["in_task"] = phase_stats.current_phase()
        await asyncio.get_running_loop().run_in_executor(pool, tick)

    try:
        work = scheduler.PendingIOWork(loop, pool, [loop.create_task(write())], bytes_total=0)
        work.sync_complete()
    finally:
        loop.close()
    assert seen["in_task"] == "io_drain_drive"
    assert seen["phases"][drain_ident] == "io_drain_drive"
    drained = sampler.snapshot_state()["stacks"]
    stacks = [s for (ph, _), b in drained.items() if ph == "io_drain_drive" for s in b]
    assert stacks and all("scheduler._sync_complete_impl" in s for s in stacks)
    assert phase_stats.current_phase() is None


def test_monitor_releases_driver_tag():
    """OpMonitor registers <kind>_drive for its thread and removes it at
    finish: a leak would tag unrelated later samples."""
    ident = threading.get_ident()
    mon = monitor.op_started("take", "abba" * 8, rank=0)
    assert phase_stats.thread_phases().get(ident) == "take_drive"
    inner = monitor.op_started("read_object", "beef" * 8, rank=0, watchdog=False)
    assert phase_stats.thread_phases().get(ident) == "read_object_drive"
    monitor.op_finished(inner)
    assert phase_stats.thread_phases().get(ident) == "take_drive"
    monitor.op_finished(mon)
    assert phase_stats.thread_phases().get(ident) is None


# --------------------------------------------- profiled ops, end to end


def test_profiled_take_and_restore_write_valid_file_pairs(tmp_path):
    """A profiled take and restore each write a schema-valid
    ``.profile.json`` and its ``.profile.collapsed`` twin, with the
    profiler.start/end events naming them."""
    prof = tmp_path / "prof"
    events = []
    event_handlers.register_event_handler(events.append)
    try:
        with knobs.override_profile_dir(str(prof)), knobs.override_profile_hz(499):
            snap = Snapshot.take(str(tmp_path / "snap"), _state())
            dst = {"m": StateDict({"w": torch.zeros(64, 64)})}
            snap.restore(dst)
    finally:
        event_handlers.unregister_event_handler(events.append)
    assert torch.equal(dst["m"]["w"], _state()["m"]["w"])
    docs = profiler.load_profile_dir(str(prof))
    assert sorted(d["tpusnap"]["kind"] for d in docs) == ["restore", "take"]
    for doc in docs:
        meta = doc["tpusnap"]
        assert meta["rank"] == 0 and meta["hz"] == 499.0 and meta["success"] is True
        collapsed = prof / doc["_file"].replace(profiler.PROFILE_FILE_SUFFIX, profiler.COLLAPSED_FILE_SUFFIX)
        lines = [line for line in collapsed.read_text().splitlines() if line]
        assert all(_COLLAPSED.match(line) for line in lines)
        assert sum(int(line.rsplit(" ", 1)[1]) for line in lines) == meta["samples_total"]
    ends = [e.metadata for e in events if e.name == "profiler.end"]
    starts = [e.metadata for e in events if e.name == "profiler.start"]
    assert [m["action"] for m in starts] == [m["action"] for m in ends] == ["take", "restore"]
    assert sorted(os.path.basename(m["path"]) for m in ends) == sorted(d["_file"] for d in docs)


def test_concurrent_ops_share_one_sampler(tmp_path):
    """Nested ops share one refcounted sampler: it outlives the first op's
    end and stops with the last; each op writes its own profile."""
    with knobs.override_profile_dir(str(tmp_path)), knobs.override_profile_hz(99):
        outer = profiler.begin_op("take", "aa" * 16, rank=0)
        inner = profiler.begin_op("read_object", "bb" * 16, rank=0)
        sampler = profiler._SAMPLER
        assert sampler is not None and sampler._thread.is_alive()
        assert profiler.end_op(inner) is not None
        assert profiler._SAMPLER is sampler and sampler._thread.is_alive()
        assert profiler.end_op(inner) is None  # a second end is a no-op
        assert profiler.end_op(outer) is not None
    assert profiler._SAMPLER is None and sampler._thread is None
    assert [d["tpusnap"]["kind"] for d in profiler.load_profile_dir(str(tmp_path))] == ["read_object", "take"]


def test_profiler_failures_cost_only_the_profile(tmp_path, monkeypatch, caplog):
    """A sampler that cannot start is logged and the take runs unprofiled;
    a take that fails under the profiler raises its own error, and its
    profile says it failed."""
    def refuse(self):
        raise RuntimeError("no thread for the sampler")

    with knobs.override_profile_dir(str(tmp_path / "a")):
        with monkeypatch.context() as m, caplog.at_level(logging.WARNING):
            m.setattr(profiler.Sampler, "start", refuse)
            Snapshot.take(str(tmp_path / "snap_a"), _state())
        assert "profiler start failed" in caplog.text
        assert not (tmp_path / "a").exists()
    with knobs.override_profile_dir(str(tmp_path / "b")), knobs.override_retry_base_s(0.001), knobs.override_faults(
        "write:1+:terminal"
    ):
        with pytest.raises(FaultInjectionError, match="injected terminal fault"):
            Snapshot.take(str(tmp_path / "snap_b"), _state())
    (doc,) = profiler.load_profile_dir(str(tmp_path / "b"))
    assert doc["tpusnap"]["kind"] == "take" and doc["tpusnap"]["success"] is False
