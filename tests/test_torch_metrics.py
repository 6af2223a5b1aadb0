"""The port's metrics registry and event bridge
(torchsnapshot_tpu_torch/telemetry/metrics.py), and the event pipeline it
rides on, mirroring the JAX package's test_telemetry.py: operations
counted with no open operation left, a failed operation's terminal event,
the Prometheus text format, scheduler gauges zeroed after success and
error, and every event name the port emits covered by the bridge or by a
metric at its emit site.  Counter values are compared exactly; durations
and histogram sums never."""

import pathlib
import re

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch
from torchsnapshot_tpu_torch import Snapshot, StateDict, event_handlers, knobs
from torchsnapshot_tpu_torch.event import Event
from torchsnapshot_tpu_torch.telemetry import metrics

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

# Events the bridge contract names whose emitters are modules the port does
# not have yet: the postmortem analysis.
UNPORTED_EMITTERS = {"postmortem.report"}


@pytest.fixture(autouse=True)
def clean_telemetry():
    """Every test starts and ends with an empty registry, no bridge and a
    fresh entry-point cache; handlers a test registers do not leak out."""
    metrics.uninstall_event_bridge()
    metrics.reset()
    event_handlers.reset_handlers_cache()
    saved = list(event_handlers._INPROCESS_HANDLERS)
    yield
    event_handlers._INPROCESS_HANDLERS[:] = saved
    metrics.uninstall_event_bridge()
    metrics.reset()
    event_handlers.reset_handlers_cache()


def _capture_events():
    events = []
    event_handlers.register_event_handler(events.append)
    return events


def test_register_unregister_inprocess_handler():
    events = _capture_events()
    event_handlers.log_event(Event(name="unit.one"))
    event_handlers.unregister_event_handler(events.append)
    event_handlers.log_event(Event(name="unit.two"))
    assert [e.name for e in events] == ["unit.one"]


def test_raising_handler_does_not_starve_others():
    seen = []

    def bad(_event):
        raise RuntimeError("boom")

    event_handlers.register_event_handler(bad)
    event_handlers.register_event_handler(seen.append)
    try:
        event_handlers.log_event(Event(name="unit.isolated"))
    finally:
        event_handlers.unregister_event_handler(bad)
        event_handlers.unregister_event_handler(seen.append)
    assert [e.name for e in seen] == ["unit.isolated"]


def test_entry_point_discovery_and_cache_reset(monkeypatch):
    """Entry-point handlers load lazily and are cached; one installed after
    the first ``log_event`` is seen only after ``reset_handlers_cache``, and
    a broken one is isolated."""
    calls = []

    class _FakeEP:
        name = "fake"

        @staticmethod
        def load():
            return calls.append

    eps = []

    def fake_entry_points(group=None):
        assert group == "torchsnapshot_tpu_torch.event_handlers"
        return list(eps)

    monkeypatch.setattr(event_handlers, "entry_points", fake_entry_points)
    event_handlers.log_event(Event(name="ep.before"))  # caches the empty set
    eps.append(_FakeEP)
    event_handlers.log_event(Event(name="ep.ignored"))
    assert calls == []
    event_handlers.reset_handlers_cache()
    event_handlers.log_event(Event(name="ep.seen"))
    assert [e.name for e in calls] == ["ep.seen"]

    class _BrokenEP:
        name = "broken"

        @staticmethod
        def load():
            raise ImportError("missing dep")

    eps.append(_BrokenEP)
    event_handlers.reset_handlers_cache()
    event_handlers.log_event(Event(name="ep.resilient"))
    assert [e.name for e in calls] == ["ep.seen", "ep.resilient"]


def test_metrics_bridge_counts_operations(tmp_path):
    with knobs.override_metrics(True):
        state = {"m": StateDict({"w": torch.ones(32, 16)})}
        snap = Snapshot.take(str(tmp_path / "snap"), state)
        snap.restore({"m": StateDict({"w": torch.zeros(32, 16)})})
        snap.read_object("0/m/w", device="cpu")
        ops = metrics.counter("tpusnap_operations_total")
        for action in ("take", "restore", "read_object"):
            assert ops.get(action=action, outcome="success") == 1
            assert metrics.gauge("tpusnap_open_operations").get(action=action) == 0, f"leaked: {action}"
        assert metrics.histogram("tpusnap_operation_duration_seconds").get(action="take") == 1
        assert metrics.counter("tpusnap_storage_bytes_written_total").get() >= 32 * 16 * 4
        assert metrics.counter("tpusnap_manifest_entries_total").get(action="take") == 2


def test_metrics_bridge_failed_op_has_terminal_event(tmp_path):
    events = _capture_events()
    with knobs.override_metrics(True):
        with pytest.raises(RuntimeError):
            Snapshot(str(tmp_path / "nonexistent")).restore({"m": StateDict({"w": torch.zeros(4)})})
        assert metrics.counter("tpusnap_operations_total").get(action="restore", outcome="error") == 1
        assert metrics.gauge("tpusnap_open_operations").get(action="restore") == 0
    ends = [e for e in events if e.name == "restore.end"]
    assert len(ends) == 1
    assert ends[0].metadata["is_success"] is False and "duration_s" in ends[0].metadata


def test_async_take_early_raise_emits_terminal_event(tmp_path):
    """async_take.start gets its matching .end when validation raises
    before a background thread exists."""
    events = _capture_events()
    with pytest.raises(TypeError):
        Snapshot.async_take(str(tmp_path / "s"), {"bad": object()})
    assert "async_take.start" in [e.name for e in events]
    ends = [e for e in events if e.name == "async_take.end"]
    assert len(ends) == 1
    assert ends[0].metadata["is_success"] is False and "duration_s" in ends[0].metadata


def test_read_object_end_carries_bytes_and_duration(tmp_path):
    events = _capture_events()
    snap = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict({"w": torch.arange(64, dtype=torch.float32)})})
    snap.read_object("0/m/w", device="cpu")
    ends = [e for e in events if e.name == "read_object.end"]
    assert len(ends) == 1
    assert ends[0].metadata["bytes"] == 64 * 4
    assert "duration_s" in ends[0].metadata


def test_prometheus_exposition_format():
    with knobs.override_metrics(True):
        metrics.counter("t_total", "help text").inc(3, kind="a")
        metrics.gauge("t_gauge").set(1.5)
        hist = metrics.histogram("t_seconds", buckets=(1.0, 10.0, 100.0))
        hist.observe(2.0)
        # Under every bound: once per bucket cumulatively, never twice.
        hist.observe(0.5)
        text = metrics.render_prometheus()
    assert "# HELP t_total help text" in text and "# TYPE t_total counter" in text
    assert 't_total{kind="a"} 3' in text
    assert "t_gauge 1.5" in text
    assert 't_seconds_bucket{le="1.0"} 1' in text
    assert 't_seconds_bucket{le="10.0"} 2' in text
    assert 't_seconds_bucket{le="100.0"} 2' in text
    assert 't_seconds_bucket{le="+Inf"} 2' in text
    assert "t_seconds_count 2" in text


_SCHEDULER_GAUGES = (
    "tpusnap_scheduler_queue_depth",
    "tpusnap_scheduler_staging_inflight",
    "tpusnap_scheduler_io_inflight",
    "tpusnap_memory_budget_in_use_bytes",
    "tpusnap_worker_utilization",
)


def test_scheduler_gauges_zeroed_after_success(tmp_path):
    with knobs.override_metrics(True):
        snap = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict({"w": torch.ones(64, 256)})})
        snap.restore({"m": StateDict({"w": torch.zeros(64, 256)})})
        for name in _SCHEDULER_GAUGES:
            for pipeline in ("write", "read"):
                assert metrics.gauge(name).get(pipeline=pipeline) == 0, (name, pipeline)
        assert metrics.counter("tpusnap_storage_bytes_read_total").get() == 64 * 256 * 4


def test_scheduler_gauges_zeroed_after_error(tmp_path):
    """An op that dies mid-pipeline leaves idle gauges, and the retries it
    made count once each."""
    with knobs.override_metrics(True), knobs.override_faults("write:1+:terminal"), knobs.override_retry_base_s(0.001):
        with pytest.raises(Exception):
            Snapshot.take(str(tmp_path / "snap"), {"m": StateDict({"w": np.ones((64, 256), np.float32)})})
        for name in _SCHEDULER_GAUGES:
            assert metrics.gauge(name).get(pipeline="write") == 0, name
        assert metrics.counter("tpusnap_faults_injected_total").get(op="write", kind="terminal") >= 1
        assert metrics.counter("tpusnap_operations_total").get(action="take", outcome="error") == 1
        assert metrics.counter("tpusnap_gc_actions_total").get(kind="take_cleanup") == 1


def test_every_emitted_event_kind_is_covered_by_metrics():
    """Every ``Event`` name in the port's source is covered by the bridge's
    families or the direct-instrumentation set, and the sets name no event
    beyond the port's own and those of the modules it lacks yet."""
    pkg_dir = pathlib.Path(torchsnapshot_tpu_torch.__file__).parent
    event_re = re.compile(r'Event\(\s*name=(f?)"([^"]+)"', re.S)
    fstring_expansions = {"{action}": ("take", "async_take"), "{what}": ("read", "write")}
    emitted = set()
    for path in pkg_dir.rglob("*.py"):
        for is_f, name in event_re.findall(path.read_text(encoding="utf-8")):
            names = [name]
            for placeholder, values in fstring_expansions.items():
                if is_f and placeholder in name:
                    names = [n.replace(placeholder, v) for n in names for v in values]
            assert not [n for n in names if "{" in n], f"{path.name}: cannot expand {name!r}"
            emitted.update(names)
    assert {"take.start", "scheduler.write_retry", "async_take.cleanup", "peer.reject", "store.sweep"} <= emitted

    def covered(kind: str) -> bool:
        return (
            kind.endswith(metrics.BRIDGED_EVENT_SUFFIXES)
            or kind in metrics.BRIDGED_EVENTS
            or kind in metrics.DIRECT_METRIC_EVENTS
        )

    assert sorted(k for k in emitted if not covered(k)) == []
    assert (metrics.BRIDGED_EVENTS | metrics.DIRECT_METRIC_EVENTS) - emitted == UNPORTED_EMITTERS
