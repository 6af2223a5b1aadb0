"""The port's fleet telemetry (torchsnapshot_tpu_torch/telemetry/fleet.py),
mirroring the non-CLI cases of tests/test_fleet.py: the atomic spool
publish of a monitored op, the terminal fold counted once, stale entries
aged out or kept as suspected-dead with one ``fleet.peer_stale`` event per
death, per-process totals counted once, the spool's resolution, and the
``top`` view, table and Prometheus exposition built by ``aggregate``,
``render`` and ``render_prometheus`` (the CLI is a later step).  Also:
every monitored op of the port leaves one terminal entry, and the
monitor's periodic publishes keep a live op's entry fresh whatever the
overhead budget, driven tick by tick with a synthetic publish cost.  Knobs
are set through ``knobs.override_*``; no assertion reads a clock bound."""

import json
import os
import shutil
import time

import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, event_handlers, knobs
from torchsnapshot_tpu_torch.telemetry import fleet, metrics
from torchsnapshot_tpu_torch.telemetry import monitor as tmonitor

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

OP = "feedc0dedeadbeef" * 2
_WAIT_S = 10.0


@pytest.fixture(autouse=True)
def clean_telemetry():
    metrics.uninstall_event_bridge()
    metrics.reset()
    fleet.reset_process_totals()
    saved = list(event_handlers._INPROCESS_HANDLERS)
    yield
    event_handlers._INPROCESS_HANDLERS[:] = saved
    metrics.uninstall_event_bridge()
    metrics.reset()
    fleet.reset_process_totals()
    assert tmonitor._ACTIVE == [], "leaked op monitors"


def _entry(pid, publish_time, done=False, kind="take", rank=0):
    return {
        "schema": 1,
        "host": "h",
        "pid": pid,
        "rank": rank,
        "kind": kind,
        "op_id": OP,
        "publish_time": publish_time,
        "op": {"done": done, "requests": {}, "bytes": {}},
        "proc": {},
        "metrics": [],
        "cache": {},
    }


def _publish_one(spool, kind="restore"):
    with knobs.override_fleet_telemetry(spool):
        mon = tmonitor.op_started(kind, OP, 0, watchdog=False)
        tmonitor.op_finished(mon, success=True)


# ---------------------------------------------------------------- publisher


def test_publish_collect_aggregate_roundtrip(tmp_path):
    """A monitored op publishes periodic and terminal entries; the collector
    sees one entry in its terminal state and the aggregation folds it."""
    spool = str(tmp_path / "live")
    with knobs.override_fleet_telemetry(spool), knobs.override_fleet_telemetry_interval_s(0.05):
        mon = tmonitor.op_started("take", OP, 0)
        path = os.path.join(spool, fleet.entry_name("take", 0))
        deadline = time.monotonic() + _WAIT_S
        while not os.path.exists(path):  # the first periodic publish
            assert time.monotonic() < deadline, "no periodic publish"
            time.sleep(0.01)
        with open(path, encoding="utf-8") as f:
            assert json.load(f)["op"]["done"] is False
        tmonitor.op_finished(mon, success=True)
        entries = fleet.collect(spool)
    assert len(entries) == 1
    doc = entries[0]
    assert doc["kind"] == "take" and doc["op_id"] == OP
    assert doc["op"]["done"] is True and doc["op"]["success"] is True
    assert doc["proc"]["ops_done"] == 1
    assert doc["proc"]["overhead_s"] > 0  # self-metered
    view = fleet.aggregate(entries)
    assert view["n_entries"] == 1 and view["n_live"] == 0
    assert view["workers"][0]["state"] == "done"
    assert view["proc_totals"]["ops_done"] == 1


def test_terminal_fold_is_idempotent(tmp_path):
    """A monitor finished twice (op_finished, a direct finish, a second
    terminal publish) folds into the process totals once."""
    spool = str(tmp_path / "live")
    with knobs.override_fleet_telemetry(spool):
        mon = tmonitor.op_started("restore", OP, 0)
        tmonitor.op_finished(mon, success=True)
        tmonitor.op_finished(mon, success=True)
        mon.finish(True)
        fleet.publish(mon, final=True)
    totals = fleet.process_totals()
    assert totals["ops_done"] == 1 and totals["ops_failed"] == 0
    assert totals["publishes"] == 3


def test_spool_removed_between_publishes_is_made_again(tmp_path):
    """The spool directory is made when a publish finds it missing, also
    after an operator removed it mid-op, and the entry parses whole."""
    spool = tmp_path / "live" / "nested"
    mon = tmonitor.OpMonitor("take", OP, 0, watchdog=False)  # spool off: no tick thread
    with knobs.override_fleet_telemetry(str(spool)):
        first = fleet.publish(mon)
        shutil.rmtree(tmp_path / "live")
        second = fleet.publish(mon)
    mon.finish(True)
    assert first == second == str(spool / fleet.entry_name("take", 0))
    with open(second, encoding="utf-8") as f:
        doc = json.load(f)
    assert doc["op_id"] == OP and doc["op"]["done"] is False
    assert os.listdir(spool) == [fleet.entry_name("take", 0)]  # no temporary file left


def test_every_monitored_op_leaves_one_terminal_entry(tmp_path):
    """take, async_take, restore and read_object each leave one entry, done
    and successful, whose written bytes are the op's own; the process
    totals count each op once."""
    spool = str(tmp_path / "live")
    state = {"m": StateDict({"w": torch.arange(4096, dtype=torch.float32), "b": torch.ones(16)})}
    with knobs.override_fleet_telemetry(spool):
        snap = Snapshot.take(str(tmp_path / "a"), state)
        Snapshot.async_take(str(tmp_path / "b"), state).wait()
        snap.restore({"m": StateDict({"w": torch.zeros(4096), "b": torch.zeros(16)})})
        got = snap.read_object("0/m/w", device="cpu")
    assert torch.equal(got, state["m"]["w"])
    entries = fleet.collect(spool, stale_s=1e9)
    by_kind = {d["kind"]: d for d in entries}
    assert sorted(by_kind) == ["async_take", "read_object", "restore", "take"]
    assert len(entries) == 4
    for d in entries:
        assert d["op"]["done"] is True and d["op"]["success"] is True, d["kind"]
        assert d["pid"] == os.getpid() and d["rank"] == 0
    assert by_kind["take"]["op"]["bytes"]["written"] > 4096 * 4
    assert by_kind["take"]["op"]["bytes"]["written"] == by_kind["async_take"]["op"]["bytes"]["written"]
    assert fleet.process_totals()["ops_done"] == 4
    view = fleet.aggregate(entries)
    assert view["n_processes"] == 1 and view["proc_totals"]["ops_done"] == 4
    assert all(w["state"] == "done" for w in view["workers"])


def test_live_entry_stays_fresh_whatever_the_overhead_budget(monkeypatch):
    """The monitor's periodic publish, driven tick by tick with a synthetic
    publish cost: the overhead budget alone spaces the beacons at cost /
    OVERHEAD_BUDGET_FRAC, past the stale bound once a publish costs 5 ms;
    the monitor publishes at least every half stale bound, so a live op's
    entry never ages past it."""
    tick, stale_s = 0.15, 1.0
    with knobs.override_fleet_telemetry_interval_s(tick), knobs.override_fleet_telemetry_stale_s(stale_s):
        for cost, budget_alone_ages in ((0.001, False), (0.005, True)):
            # Built with the spool off, so no tick thread runs beside the
            # ticks driven here.
            mon = tmonitor.OpMonitor("serve", OP, 0, watchdog=False)
            assert not mon._fleet and mon._thread is None
            mon._fleet = True
            clock = {"now": mon._begin}
            stamps = []

            def synthetic_publish(m, final=False, cost=cost, stamps=stamps):
                m.fleet_overhead_s = getattr(m, "fleet_overhead_s", 0.0) + cost
                stamps.append(clock["now"])

            # The budget alone, as the JAX monitor applies it outside
            # deadline mode.
            duck = type("Duck", (), {"fleet_overhead_s": 0.0})()
            alone, due = [], 0.0
            for i in range(1, 200):
                now = mon._begin + i * tick
                if now >= due and fleet.within_overhead_budget(duck, now - mon._begin):
                    due = now + tick
                    duck.fleet_overhead_s += cost
                    alone.append(now)
            assert (max(b - a for a, b in zip(alone, alone[1:])) > stale_s) is budget_alone_ages, cost

            monkeypatch.setattr(fleet, "publish", synthetic_publish)
            for i in range(1, 200):
                clock["now"] = mon._begin + i * tick
                mon._fleet_tick(clock["now"])
            gaps = [b - a for a, b in zip([mon._begin] + stamps, stamps)]
            assert max(gaps) <= stale_s / 2 + tick + 1e-9, (cost, max(gaps))
            assert len(stamps) >= len(alone)
            mon._fleet = False
            mon.finish(True)


# -------------------------------------------------------------- collector


def test_stale_entries_age_out(tmp_path):
    """A finished op's stale entry is debris (skipped, swept); an in-flight
    op's stale entry is a suspected-dead row with its last-seen age, out of
    the live set, swept only past the longer horizon."""
    spool = tmp_path / "live"
    spool.mkdir()
    now = time.time()
    (spool / "h-1-take-rank0.fleet.json").write_text(json.dumps(_entry(1, now)))
    (spool / "h-2-take-rank0.fleet.json").write_text(json.dumps(_entry(2, now - 60)))
    done_path = spool / "h-3-take-rank0.fleet.json"
    done_path.write_text(json.dumps(_entry(3, now - 60, done=True)))
    ancient_path = spool / "h-4-take-rank0.fleet.json"
    ancient_path.write_text(json.dumps(_entry(4, now - 9999)))
    (spool / "garbage.fleet.json").write_text("{torn")
    entries = fleet.collect(str(spool), stale_s=30.0)
    assert sorted(e["pid"] for e in entries) == [1, 2]
    assert not done_path.exists() and not ancient_path.exists()
    assert (spool / "garbage.fleet.json").exists()  # skipped, never swept

    view = fleet.aggregate(entries)
    assert view["n_suspected_dead"] == 1
    assert view["suspected_dead"][0]["worker"] == "h:2"
    assert view["suspected_dead"][0]["last_seen_s"] >= 59
    rows = {w["worker"]: w for w in view["workers"]}
    assert rows["h:2"]["state"] == "suspected-dead"
    assert view["n_live"] == 1
    assert all(s["worker"] != "h:2" for s in view["stragglers"])
    rendered = fleet.render(view, str(spool))
    assert "SUSPECTED DEAD: h:2" in rendered and "suspected-dead" in rendered


def test_peer_stale_event_emitted_once(tmp_path):
    """One fleet.peer_stale event per death, not one per collect pass; the
    tpusnap_fleet_stale_peers gauge holds the current count."""
    spool = tmp_path / "live"
    spool.mkdir()
    (spool / "h-9-async_take-rank1.fleet.json").write_text(
        json.dumps(_entry(9, time.time() - 60, kind="async_take", rank=1))
    )
    events = []

    def capture(e):
        if e.name == "fleet.peer_stale":
            events.append(e)

    event_handlers.register_event_handler(capture)
    try:
        with knobs.override_metrics(True):
            fleet.collect(str(spool), stale_s=30.0)
            fleet.collect(str(spool), stale_s=30.0)
            assert metrics.gauge("tpusnap_fleet_stale_peers").get() == 1.0
    finally:
        event_handlers.unregister_event_handler(capture)
    assert len(events) == 1, [e.metadata for e in events]
    assert events[0].metadata["worker"] == "h:9"
    assert events[0].metadata["kind"] == "async_take" and events[0].metadata["rank"] == 1
    assert events[0].metadata["last_seen_s"] >= 59


def test_aggregate_counts_process_totals_once():
    """A process publishing several op kinds counts its cumulative cache and
    process totals once; op-level bytes sum across entries."""
    now = time.time()

    def entry(kind, pid, nbytes):
        return {
            "host": "h",
            "pid": pid,
            "rank": 0,
            "kind": kind,
            "op_id": OP,
            "publish_time": now,
            "op": {
                "done": False,
                "elapsed_s": 1.0,
                "requests": {"total": 4, "staged": 4, "written": 2},
                "bytes": {"staged": nbytes, "written": nbytes},
                "eta_s": 1.0,
            },
            "proc": {"ops_done": 3, "bytes_written": 100},
            "cache": {"hits": 1, "misses": 1, "hit_bytes": 10, "miss_bytes": 5},
            "metrics": [],
        }

    view = fleet.aggregate([entry("restore", 1, 7), entry("read_object", 1, 9), entry("take", 2, 1)])
    assert view["n_processes"] == 2
    assert view["cache"]["hit_bytes"] == 20 and view["cache"]["origin_bytes"] == 10
    assert view["proc_totals"]["ops_done"] == 6
    assert view["op_totals"]["bytes_written"] == 17
    assert view["straggler"] is not None


def test_resolve_spool_prefers_conventional_subdir(tmp_path):
    root = tmp_path / "root"
    nested = root / "telemetry" / "live"
    nested.mkdir(parents=True)
    assert fleet.resolve_spool(str(root)) == str(nested)
    assert fleet.resolve_spool(str(nested)) == str(nested)
    with knobs.override_fleet_telemetry(str(nested)):
        assert fleet.resolve_spool(None) == str(nested)
    assert fleet.resolve_spool(str(tmp_path / "absent")) is None


# ------------------------------------------------- the views `top` shows


def test_top_json_view(tmp_path):
    """What ``top --json`` prints: the aggregation of the collected spool."""
    spool = str(tmp_path / "live")
    _publish_one(spool)
    view = fleet.aggregate(fleet.collect(spool, sweep=False))
    view = json.loads(json.dumps(view))
    assert view["n_entries"] == 1
    assert view["workers"][0]["kind"] == "restore"


def test_top_table_and_missing_spool(tmp_path):
    """What ``top --once`` prints, and no spool behind a missing path."""
    spool = str(tmp_path / "live")
    _publish_one(spool, kind="take")
    out = fleet.render(fleet.aggregate(fleet.collect(spool, sweep=False)), spool)
    assert "tpusnap top" in out and "take" in out
    assert fleet.resolve_spool(str(tmp_path / "nope")) is None


def test_top_prometheus_merges_worker_registries(tmp_path):
    """Entries that embed a registry dump render as one exposition with
    per-worker labels plus the fleet gauges."""
    spool = str(tmp_path / "live")
    with knobs.override_metrics(True):
        metrics.counter("tpusnap_test_total", "t").inc(3, backend="fs")
        _publish_one(spool)
    out = fleet.render_prometheus(fleet.collect(spool, sweep=False))
    assert "tpusnap_fleet_workers 1" in out
    assert "tpusnap_test_total" in out
    assert 'worker="' in out
    assert "tpusnap_fleet_origin_bytes" in out
