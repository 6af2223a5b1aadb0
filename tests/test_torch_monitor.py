"""The port's health monitor (torchsnapshot_tpu_torch/telemetry/monitor.py),
mirroring tests/test_monitor.py: the live progress API, the progress
gauges, the sidecars' RSS high water, the stall watchdog (a latency fault
far past a short ``TPUSNAP_STALL_TIMEOUT_S`` must give a bundle, an event
and the counter; a slow but advancing take must not), escalation, the
heartbeat file and the step history.  Knobs and faults are set through
``knobs.override_*``.  The reference's sampled-profile section of a stall
bundle (tests/test_monitor.py:135-140) comes with the profiler's port
and is not asserted here."""

import glob
import json
import os
import time

import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, SnapshotManager, StateDict, event_handlers, knobs, phase_stats
from torchsnapshot_tpu_torch.telemetry import metrics, monitor

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

_WAIT_S = 10.0


@pytest.fixture(autouse=True)
def _clean_telemetry():
    metrics.uninstall_event_bridge()
    metrics.reset()
    event_handlers.reset_handlers_cache()
    saved = list(event_handlers._INPROCESS_HANDLERS)
    yield
    event_handlers._INPROCESS_HANDLERS[:] = saved
    metrics.uninstall_event_bridge()
    metrics.reset()
    event_handlers.reset_handlers_cache()
    assert monitor._ACTIVE == [], "leaked op monitors"


def _capture_events():
    events = []
    event_handlers.register_event_handler(events.append)
    return events


def _state(n_leaves=1, shape=(64, 64)):
    return {"m": StateDict({f"w{i}": torch.ones(shape) for i in range(n_leaves)})}


def _stall_bundles(trace_dir):
    return glob.glob(os.path.join(str(trace_dir), monitor.STALL_BUNDLE_PREFIX + "*.txt"))


def _wait_until(cond, what):
    deadline = time.monotonic() + _WAIT_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


# ----------------------------------------------------------- progress API


def test_progress_api_on_pending_snapshot(tmp_path):
    pending = Snapshot.async_take(str(tmp_path / "snap"), _state())
    doc = pending.progress()  # valid at any moment, from any thread
    assert doc["action"] == "async_take"
    pending.wait()
    doc = pending.progress()
    assert doc["done"] is True and doc["success"] is True
    assert doc["requests"]["total"] >= 1
    assert doc["requests"]["written"] == doc["requests"]["total"]
    assert doc["bytes"]["written"] >= 64 * 64 * 4
    assert doc["rss_high_water_bytes"] > 0
    assert doc["stalls"] == 0
    assert doc["pipelines"] and doc["pipelines"][0]["verb"] == "write"
    assert doc["pipelines"][0]["budget_total_bytes"] > 0


def test_progress_gauges_recorded(tmp_path):
    with knobs.override_metrics(True):
        Snapshot.take(str(tmp_path / "snap"), _state())
        written = metrics.gauge("tpusnap_progress_requests_written")
        total = metrics.gauge("tpusnap_progress_requests_total")
        assert total.get(pipeline="write") >= 1
        assert written.get(pipeline="write") == total.get(pipeline="write")
        assert metrics.gauge("tpusnap_progress_bytes_written").get(pipeline="write") >= 64 * 64 * 4


def test_sidecars_carry_rss_high_water(tmp_path):
    snap = Snapshot.take(str(tmp_path / "snap"), _state())
    snap.restore(_state())
    docs = [json.loads(p.read_text()) for p in (tmp_path / "snap" / "telemetry").glob("*.json")]
    assert {d["action"] for d in docs} == {"take", "restore"}
    for doc in docs:
        assert doc["rss_high_water_bytes"] > 0


# -------------------------------------------------------- stall watchdog


def test_watchdog_fires_on_injected_hang(tmp_path):
    """A payload write held far past the stall timeout gives a diagnostic
    bundle, a watchdog.stall event and the stalls counter, and the take
    still commits (latency, not an error)."""
    trace_dir = tmp_path / "traces"
    events = _capture_events()
    with knobs.override_retry_base_s(0.001), knobs.override_metrics(True), knobs.override_trace_dir(
        str(trace_dir)
    ), knobs.override_stall_timeout_s(0.3), knobs.override_faults("write:1:latency:1.5"):
        snap = Snapshot.take(str(tmp_path / "snap"), _state())
        stalls_total = metrics.counter("tpusnap_stalls_total").get(action="take")
    dst = _state()
    dst["m"]["w0"].zero_()
    snap.restore(dst)
    assert torch.equal(dst["m"]["w0"], torch.ones(64, 64))

    stalls = [e for e in events if e.name == "watchdog.stall"]
    assert stalls, [e.name for e in events]
    md = stalls[0].metadata
    assert md["action"] == "take"
    assert md["idle_s"] >= 0.3
    assert stalls_total >= 1

    bundles = _stall_bundles(trace_dir)
    assert bundles and md["bundle"] in bundles
    text = open(bundles[0], encoding="utf-8").read()
    # The parked pipeline state, the budget, the asyncio tasks and every
    # thread's stack.
    assert "pipeline states" in text
    assert "budget:" in text
    assert "pending asyncio tasks" in text
    assert "thread stacks (faulthandler)" in text
    assert "Thread" in text or "thread" in text


def test_watchdog_no_false_positive_when_advancing(tmp_path):
    """Eight writes each 0.1 s slow through one I/O slot: about 1 s of wall,
    but a counter moves every 0.1 s, so a 0.6 s stall timeout never fires."""
    trace_dir = tmp_path / "traces"
    events = _capture_events()
    with knobs.override_retry_base_s(0.001), knobs.override_trace_dir(str(trace_dir)), knobs.override_batching_disabled(
        True
    ), knobs.override_max_per_rank_io_concurrency(1), knobs.override_stall_timeout_s(0.6), knobs.override_faults(
        "write:1+:latency:0.1"
    ):
        Snapshot.take(str(tmp_path / "snap"), _state(n_leaves=8))
    assert [e.name for e in events if e.name == "watchdog.stall"] == []
    assert _stall_bundles(trace_dir) == []


def test_watchdog_escalates_through_assigned_channel(tmp_path):
    """With TPUSNAP_STALL_ESCALATE=1 a stall calls the op's escalation
    channel (PendingSnapshot points it at its commit barrier's
    report_error, so peers un-hang as StorePeerError)."""
    calls = []
    events = _capture_events()
    with knobs.override_stall_timeout_s(0.15), knobs.override_stall_escalate(True), knobs.override_trace_dir(
        str(tmp_path)
    ):
        mon = monitor.op_started("take", "deadbeef" * 4, rank=0)
        mon.escalate = calls.append
        try:
            _wait_until(lambda: calls, "the escalation")
        finally:
            monitor.op_finished(mon, success=False)
    assert calls and "stalled" in calls[0]
    stalls = [e for e in events if e.name == "watchdog.stall"]
    assert stalls and stalls[0].metadata["escalated"] is True
    assert stalls[0].metadata["bundle"] in _stall_bundles(tmp_path)


def test_watchdog_disabled_by_default_starts_no_thread():
    mon = monitor.op_started("take", "feedface" * 4, rank=0)
    try:
        assert mon._thread is None
    finally:
        monitor.op_finished(mon)


def test_concurrent_op_phase_activity_does_not_rearm_watchdog():
    """phase_stats is process-global: with two ops monitored, one op's
    phase activity must not count as the other's progress."""
    mon_a = monitor.op_started("take", "a" * 32, rank=0)
    mon_b = monitor.op_started("take", "b" * 32, rank=0)
    try:
        fp = mon_a._fingerprint()
        phase_stats.add("d2h", 0.01, 128)
        assert mon_a._fingerprint() == fp
        monitor.op_finished(mon_b)
        # The sole op again: phase activity counts as progress once more.
        fp = mon_a._fingerprint()
        phase_stats.add("d2h", 0.01, 128)
        assert mon_a._fingerprint() != fp
    finally:
        monitor.op_finished(mon_b)
        monitor.op_finished(mon_a)


def test_finish_releases_scheduler_debug_refs(tmp_path):
    """A held PendingSnapshot does not pin the scheduler's pipeline
    containers through the monitor's debug closures after the end."""
    pending = Snapshot.async_take(str(tmp_path / "snap"), _state())
    pending.wait()
    _wait_until(lambda: pending.progress()["done"], "the terminal progress")
    mon = pending._monitor
    assert mon._snapshot_reporters()
    for reporter in mon._snapshot_reporters():
        assert reporter.debug_refs is None
        assert reporter.loop is None
    assert pending.progress()["requests"]["written"] >= 1


# -------------------------------------------------------------- heartbeat


def test_heartbeat_file_rewritten(tmp_path):
    hb = tmp_path / "hb.json"
    with knobs.override_heartbeat_file(str(hb)), knobs.override_progress_interval_s(0.05):
        pending = Snapshot.async_take(str(tmp_path / "snap"), _state())
        pending.wait()
    # The monitor thread writes the terminal heartbeat before finish()
    # returns, and wait() joined the thread that called finish().
    doc = json.loads(hb.read_text())
    assert doc["done"] is True
    assert doc["success"] is True
    assert doc["action"] == "async_take" and doc["op_kind"] == "async_take"
    assert "heartbeat_time" in doc and "trace_id" in doc


# -------------------------------------------- history via SnapshotManager


def test_manager_records_step_history(tmp_path):
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
    from torchsnapshot_tpu_torch.telemetry import history

    root = tmp_path / "ckpts"
    mgr = SnapshotManager(str(root))
    mgr.save(1, _state())
    mgr.save(2, _state(), async_=True).wait()
    entries = []

    def two_entries():
        nonlocal entries
        storage = url_to_storage_plugin(str(root))
        try:
            entries = history.read(storage)
        finally:
            storage.sync_close()
        return len(entries) >= 2

    _wait_until(two_entries, "two history lines")
    assert [e["step"] for e in entries] == [1, 2]
    assert entries[0]["action"] == "take"
    assert entries[1]["action"] == "async_take"
    assert entries[0]["duration_s"] > 0
    assert entries[0]["rss_high_water_bytes"] > 0
