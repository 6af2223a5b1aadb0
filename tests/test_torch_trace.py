"""The port's span tracer (torchsnapshot_tpu_torch/telemetry/trace.py),
mirroring the tracer cases of the JAX package's test_telemetry.py and
test_peer_trace.py: a traced take emits a schema-valid trace whose spans
cover the pipeline, nothing is recorded or installed with tracing off,
trace files merge, the W3C ``traceparent`` round-trips and follows the
active span, an async take's trace ends on its background commit, and
the phase_stats raw-add wall clamp holds.  Comparisons are of span names,
counts, parents and bytes; durations are never compared."""

import json

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, knobs, phase_stats
from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin
from torchsnapshot_tpu_torch.telemetry import metrics, trace

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


@pytest.fixture(autouse=True)
def clean_telemetry():
    metrics.uninstall_event_bridge()
    metrics.reset()
    yield
    metrics.uninstall_event_bridge()
    metrics.reset()
    assert trace._ACTIVE == [], "a traced operation was left collecting"
    assert phase_stats._trace_hook is None


def _load(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _spans(doc):
    return [e for e in doc["traceEvents"] if e["ph"] == "X"]


def test_traced_take_on_memory_plugin_emits_valid_trace(tmp_path):
    """A traced take produces schema-valid trace-event JSON whose spans
    cover the pipeline (an object serialized, payloads hashed and framed,
    the memory plugin's writes, the scheduler's staging).  On the CPU no
    tensor crosses a device, so ``d2h`` is the card's to show."""
    trace_dir = tmp_path / "traces"
    state = {"m": StateDict({"w": torch.ones(64, 1024), "obj": set(range(100))})}
    try:
        with knobs.override_trace_dir(str(trace_dir)), knobs.override_compression(
            "zlib:1"
        ), knobs.override_compression_min_bytes(1024):
            Snapshot.take("memory://trace_smoke", state)
        files = sorted(trace_dir.glob("take-*" + trace.TRACE_FILE_SUFFIX))
        assert len(files) == 1
        doc = _load(files[0])
        assert trace.validate_trace(doc) == []
        spans = _spans(doc)
        names = {e["name"] for e in spans}
        for required in ("take", "flatten", "plan", "partition", "batch_write_plan", "serialize",
                         "checksum", "compress", "mem_write", "write_staging", "io_drain"):
            assert required in names, f"missing span {required!r}: {sorted(names)}"
        assert {e["args"].get("op") for e in spans} == {doc["otherData"]["op"]}
        assert any(e["args"].get("bytes", 0) > 0 for e in spans if e["name"] == "compress")
        root = [e for e in spans if e["name"] == "take"]
        assert len(root) == 1 and root[0]["args"]["success"] is True
        assert root[0]["args"]["trace"] == trace.trace_id_for(doc["otherData"]["op"])
    finally:
        MemoryStoragePlugin.reset("trace_smoke")


def test_trace_disabled_records_nothing(tmp_path):
    """With no trace directory and metrics off, a take and a restore write
    no trace file, leave phase_stats' hook unset and register no metric."""
    assert trace.begin_op("take", "abc", 0) is None
    with trace.span("unit"):  # no active op: the shared no-op
        pass
    state = {"m": StateDict({"w": torch.ones(8)})}
    snap = Snapshot.take(str(tmp_path / "snap"), state)
    assert phase_stats._trace_hook is None
    snap.restore({"m": StateDict({"w": torch.zeros(8)})})
    assert phase_stats._trace_hook is None
    assert not list(tmp_path.glob("**/*" + trace.TRACE_FILE_SUFFIX))
    assert metrics.dump_registry() == [] and metrics.render_prometheus() == ""


def test_trace_validate_rejects_malformed():
    assert trace.validate_trace([]) != []
    assert trace.validate_trace({"traceEvents": "nope"}) != []
    bad_event = {"traceEvents": [{"name": "x", "ph": "X", "ts": 1}]}
    assert any("pid" in p for p in trace.validate_trace(bad_event))
    ok = {"traceEvents": [{"name": "x", "ph": "X", "ts": 1.0, "dur": 2.0, "pid": 0, "tid": 0}]}
    assert trace.validate_trace(ok) == []


def test_merge_trace_files_of_a_take_and_a_restore(tmp_path):
    trace_dir = tmp_path / "traces"
    with knobs.override_trace_dir(str(trace_dir)):
        snap = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict({"w": torch.ones(16, 16)})})
        snap.restore({"m": StateDict({"w": torch.zeros(16, 16)})})
    paths = sorted(str(p) for p in trace_dir.glob("*" + trace.TRACE_FILE_SUFFIX))
    assert len(paths) == 2
    merged = trace.merge_trace_files(paths)
    assert trace.validate_trace(merged) == []
    assert {s.get("kind") for s in merged["otherData"]["merged_from"]} == {"take", "restore"}
    assert len(merged["traceEvents"]) == sum(len(_load(p)["traceEvents"]) for p in paths)


def test_traceparent_roundtrip_and_trace_id_determinism():
    tid = trace.trace_id_for("op-123")
    assert tid == trace.trace_id_for("op-123")
    assert len(tid) == 32 and int(tid, 16) != 0
    header = f"00-{tid}-00000000000000ab-01"
    assert trace.parse_traceparent(header) == (tid, 0xAB)
    assert trace.parse_traceparent(None) is None
    assert trace.parse_traceparent("junk") is None
    assert trace.parse_traceparent("00-short-ab-01") is None
    # All-zero trace and span ids are invalid in W3C trace-context.
    assert trace.parse_traceparent(f"00-{'0' * 32}-{'1' * 16}-01") is None
    assert trace.parse_traceparent(f"00-{tid}-{'0' * 16}-01") is None


def test_current_traceparent_tracks_active_span(tmp_path):
    assert trace.current_traceparent() is None
    with knobs.override_trace_dir(str(tmp_path / "tr")):
        op = trace.begin_op("restore", "ctxop1", 0)
        try:
            trace_id, parent = trace.parse_traceparent(trace.current_traceparent())
            assert trace_id == trace.trace_id_for("ctxop1")
            assert parent == op.root_span_id
            with trace.span("peer_fetch", cat="phase"):
                _, inner = trace.parse_traceparent(trace.current_traceparent())
                assert inner != parent  # the child span is now the parent
        finally:
            trace.end_op(op)
    assert trace.current_traceparent() is None
    spans = _spans(_load(next((tmp_path / "tr").glob("restore-*"))))
    fetch = next(e for e in spans if e["name"] == "peer_fetch")
    assert fetch["args"]["parent"] is None and fetch["args"]["span_id"] == inner


def test_calibrated_span_cost():
    cost = trace.calibrated_span_cost_s(samples=50)
    assert cost["per_span_s"] >= 0.0
    assert cost["per_span_s"] < 1e-3  # a span is microseconds, not milliseconds
    assert cost["estimated_s"] == pytest.approx(cost["per_span_s"] * cost["spans"])


def test_async_take_trace_ends_on_the_background_commit(tmp_path):
    """The async take's op stays collecting after ``async_take`` returns and
    is ended by the commit thread: its file holds the drain's spans and a
    successful root span."""
    trace_dir = tmp_path / "traces"
    w = torch.arange(4096, dtype=torch.float32)
    with knobs.override_trace_dir(str(trace_dir)):
        pending = Snapshot.async_take(str(tmp_path / "snap"), {"m": StateDict({"w": w})})
        snap = pending.wait()
    files = list(trace_dir.glob("async_take-*" + trace.TRACE_FILE_SUFFIX))
    assert len(files) == 1
    doc = _load(files[0])
    assert trace.validate_trace(doc) == [] and doc["otherData"]["success"] is True
    names = [e["name"] for e in _spans(doc)]
    assert names.count("async_take") == 1 and "io_drain" in names and "write_staging" in names
    dst = torch.zeros_like(w)
    snap.restore({"m": StateDict({"w": dst})})
    assert torch.equal(dst, w)


def test_failed_take_writes_a_trace_marked_failed(tmp_path):
    """A take that fails still ends its op: the file says so, and no op is
    left collecting (the autouse fixture checks)."""
    trace_dir = tmp_path / "traces"
    with knobs.override_trace_dir(str(trace_dir)), knobs.override_faults(
        "write:1+:terminal"
    ), knobs.override_retry_base_s(0.001):
        with pytest.raises(Exception):
            Snapshot.take(str(tmp_path / "snap"), {"m": StateDict({"w": torch.ones(64, 256)})})
    doc = _load(next(trace_dir.glob("take-*" + trace.TRACE_FILE_SUFFIX)))
    assert trace.validate_trace(doc) == []
    assert doc["otherData"]["success"] is False
    assert [e["args"]["success"] for e in _spans(doc) if e["name"] == "take"] == [False]


def test_raw_add_cannot_overstate_wall_past_compaction():
    """A retroactive raw add() reaching back into the compaction-retired
    region is clamped at the retired high-water mark."""
    phase_stats.reset()
    try:
        n = phase_stats._COMPACT_THRESHOLD
        for i in range(n):
            phase_stats.add("clamp_phase", 1.0, 10, end=i * 601.0 + 1.0)
        assert phase_stats.snapshot()["clamp_phase"]["wall"] == pytest.approx(n * 1.0)
        phase_stats.add("clamp_phase", n * 601.0, 10, end=n * 601.0)
        wall = phase_stats.snapshot()["clamp_phase"]["wall"]
        assert wall <= n * 601.0 + 1.0
        assert wall < n * 1.0 + n * 601.0 - 100.0
        assert phase_stats.snapshot()["clamp_phase"]["s"] == pytest.approx(n * 1.0 + n * 601.0)
    finally:
        phase_stats.reset()


def test_timed_blocks_unaffected_by_clamp():
    phase_stats.reset()
    try:
        with phase_stats.timed("clamp_timed", 100):
            pass
        phase_stats.add("clamp_timed", 0.5, 50)
        stats = phase_stats.snapshot()["clamp_timed"]
        assert stats["n"] == 2
        assert stats["bytes"] == 150
    finally:
        phase_stats.reset()
