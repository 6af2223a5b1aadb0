"""The port's bottleneck analyzer (torchsnapshot_tpu_torch/telemetry/analyze.py),
mirroring the library halves of tests/test_analyze.py: a synthetic two-rank
trace and sidecar fixture with a known straggler and a known dominant
phase, invalid trace input raising ``ValueError``, the wait groups naming
the limiting resource, the phase table, and the commit-barrier blame.
Each report is also held equal to the JAX package's over the same input.
The CLI halves come with the port's CLI.

Last, every phase name the port records classifies into a group other
than ``other``: a literal passed to ``phase_stats.timed``/``add``/
``tagged``, either branch of a conditional one, and the names the fs
plugin's read path returns."""

import ast
import json
import os

import pytest

from torchsnapshot_tpu.telemetry import analyze as jax_analyze
from torchsnapshot_tpu_torch.telemetry import analyze

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

OP = "deadbeefcafef00d" * 2
S = 1e6  # seconds -> trace microseconds
PORT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "torchsnapshot_tpu_torch")


def _trace_doc(kind, op, rank, op_dur_us, phases):
    """phases: [(name, begin_us, dur_us, nbytes)]"""
    events = [
        {
            "name": kind,
            "cat": "op",
            "ph": "X",
            "ts": 0.0,
            "dur": float(op_dur_us),
            "pid": rank,
            "tid": 0,
            "args": {"op": op, "success": True},
        }
    ]
    for name, begin, dur, nbytes in phases:
        events.append(
            {
                "name": name,
                "cat": "phase",
                "ph": "X",
                "ts": float(begin),
                "dur": float(dur),
                "pid": rank,
                "tid": 1,
                "args": {"bytes": nbytes},
            }
        )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"op": op, "kind": kind, "rank": rank, "success": True},
    }


@pytest.fixture
def two_rank_fixture(tmp_path):
    """Rank 0: 10 s take, fs_write-dominated.  Rank 1: the straggler,
    20 s, fs_write even more dominant.  Plus per-rank sidecars."""
    trace_dir = tmp_path / "traces"
    trace_dir.mkdir()
    layouts = {0: (10, 6), 1: (20, 16)}
    for rank, (dur, fs_s) in layouts.items():
        doc = _trace_doc(
            "take",
            OP,
            rank,
            dur * S,
            [("d2h", 0, 2 * S, 1 << 30), ("serialize", 2 * S, 1 * S, 1 << 30), ("fs_write", 3 * S, fs_s * S, 1 << 30)],
        )
        (trace_dir / f"take-{OP[:8]}-rank{rank}.trace.json").write_text(json.dumps(doc))
    snap_dir = tmp_path / "snap"
    (snap_dir / "telemetry").mkdir(parents=True)
    for rank, dur in ((0, 10.0), (1, 20.0)):
        (snap_dir / "telemetry" / f"take-{OP[:8]}-rank{rank}.json").write_text(
            json.dumps(
                {
                    "schema_version": "1.0",
                    "action": "take",
                    "op_id": OP,
                    "rank": rank,
                    "timestamp": 1700000000.0 + rank,
                    "success": True,
                    "duration_s": dur,
                    "bytes": 1 << 30,
                    "throughput_gbps": round((1 << 30) / 1e9 / dur, 4),
                    "phases": {},
                    "knobs": {},
                    "rss_high_water_bytes": 123456789,
                }
            )
        )
    return trace_dir, snap_dir


def test_analyze_names_straggler_and_dominant_phase(two_rank_fixture):
    trace_dir, snap_dir = two_rank_fixture
    docs = analyze.load_trace_dir(str(trace_dir))
    sidecars = analyze.load_sidecars(str(snap_dir))
    analysis = analyze.analyze_traces(docs, sidecars)
    (op,) = analysis["ops"]
    assert op["kind"] == "take" and op["world"] == 2
    assert op["straggler_rank"] == 1
    assert op["dominant_phase"] == "fs_write"
    assert op["limiting_resource"] == "storage_io"
    assert op["skew"] == pytest.approx(2.0)
    assert op["duration_s"]["max"] == pytest.approx(20.0)
    assert op["phases"]["fs_write"]["slowest_rank"] == 1
    assert op["phases"]["fs_write"]["max_wall_s"] == pytest.approx(16.0)
    # Idle: rank 0 has 1 s uncovered (10 - 9), rank 1 has 1 s (20 - 19).
    assert op["idle"]["by_rank"]["0"] == pytest.approx(1.0)
    assert op["sidecars"]["1"]["duration_s"] == 20.0
    assert op["sidecars"]["0"]["rss_high_water_bytes"] == 123456789
    jax_docs = jax_analyze.load_trace_dir(str(trace_dir))
    assert analysis == jax_analyze.analyze_traces(jax_docs, jax_analyze.load_sidecars(str(snap_dir)))


def test_render_names_straggler_dominant_phase_and_limit(two_rank_fixture):
    trace_dir, _ = two_rank_fixture
    analysis = analyze.analyze_traces(analyze.load_trace_dir(str(trace_dir)))
    out = analyze.render(analysis)
    assert "straggler: rank 1" in out
    assert "dominant phase fs_write" in out
    assert "limiting resource: storage_io" in out
    assert out == jax_analyze.render(analysis)


def test_invalid_trace_raises_and_empty_input_reports_nothing(tmp_path):
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "x.trace.json").write_text('{"traceEvents": "nope"}')
    with pytest.raises(ValueError, match="invalid trace"):
        analyze.load_trace_dir(str(bad))
    (bad / "x.trace.json").write_text("not json at all")
    with pytest.raises(ValueError, match="unreadable trace file"):
        analyze.load_trace_dir(str(bad))
    empty = tmp_path / "empty"
    empty.mkdir()
    assert analyze.load_trace_dir(str(empty)) == []
    assert analyze.analyze_traces([]) == {"ops": []}
    assert analyze.render({"ops": []}) == "no operations found in trace input"
    # A snapshot without sidecars yields none.
    assert analyze.load_sidecars(str(empty)) == []


def test_wait_groups_name_the_limiting_resource():
    budget_doc = _trace_doc(
        "take", "a" * 32, 0, 10 * S, [("budget_wait", 0, 7 * S, 0), ("fs_write", 0, 3 * S, 1 << 20)]
    )
    slot_doc = _trace_doc(
        "take", "b" * 32, 0, 10 * S, [("io_slot_wait", 0, 6 * S, 0), ("fs_write", 0, 4 * S, 1 << 20)]
    )
    d2h_doc = _trace_doc("take", "c" * 32, 0, 10 * S, [("d2h", 0, 8 * S, 1 << 20)])
    # The port's process-group wait is a barrier wait.
    pg_doc = _trace_doc("restore", "d" * 32, 0, 10 * S, [("pg_wait", 0, 5 * S, 0), ("h2d_land", 0, 2 * S, 1 << 20)])
    (op,) = analyze.analyze_traces([budget_doc])["ops"]
    assert op["limiting_resource"] == "memory_budget"
    assert op["dominant_phase"] == "fs_write"  # wait groups never dominate
    (op,) = analyze.analyze_traces([slot_doc])["ops"]
    assert op["limiting_resource"] == "io_concurrency"
    (op,) = analyze.analyze_traces([d2h_doc])["ops"]
    assert op["limiting_resource"] == "d2h"
    (op,) = analyze.analyze_traces([pg_doc])["ops"]
    assert op["limiting_resource"] == "barrier" and op["dominant_phase"] == "h2d_land"
    for doc in (budget_doc, slot_doc, d2h_doc):
        assert analyze.analyze_traces([doc]) == jax_analyze.analyze_traces([doc])


def test_phase_group_classification():
    assert analyze.classify_phase("d2h") == "d2h"
    assert analyze.classify_phase("compress") == "serialize"
    assert analyze.classify_phase("fs_write") == "storage_io"
    assert analyze.classify_phase("gcs_read") == "storage_io"
    assert analyze.classify_phase("h2d_land") == "h2d"
    assert analyze.classify_phase("budget_wait") == "memory_budget"
    assert analyze.classify_phase("io_slot_wait") == "io_concurrency"
    assert analyze.classify_phase("barrier_wait") == "barrier"
    assert analyze.classify_phase("cache_wait") == "cache_wait"
    for group in ("barrier", "cache_wait"):
        assert group in analyze.WAIT_GROUPS
    assert analyze.WAIT_GROUPS == jax_analyze.WAIT_GROUPS
    # The driver pseudo-phases classify into their own group.
    assert analyze.classify_phase("take_drive") == "driver"
    assert analyze.classify_phase("io_drain_drive") == "driver"
    # The port's own phases go to the group of their work.
    assert analyze.classify_phase("pinned_alloc") == "d2h"
    assert analyze.classify_phase("stage_alloc") == "d2h"
    assert analyze.classify_phase("native_write_batch") == "storage_io"
    # Every name the JAX package classifies lands in the same group here.
    for group, members in jax_analyze.PHASE_GROUPS.items():
        assert members <= analyze.PHASE_GROUPS[group], group


def _barrier_sidecar(rank, arrive_offsets, phases, t0=1700000000.0):
    """One rank's sidecar carrying the exchanged barrier table."""
    return {
        "schema_version": "1.0",
        "action": "async_take",
        "op_id": OP,
        "rank": rank,
        "timestamp": t0 + 30,
        "success": True,
        "duration_s": 30.0,
        "bytes": 1 << 30,
        "phases": phases,
        "knobs": {},
        "barrier": {
            "world_size": len(arrive_offsets),
            "arrivals": {str(r): {"arrive": t0 + off, "depart": t0 + 10.0} for r, off in arrive_offsets.items()},
        },
    }


@pytest.fixture
def barrier_fixture(tmp_path):
    """Two ranks: rank 1 arrives 5 s late with fs_write as its dominant
    pre-barrier work phase; rank 0 burned the skew in barrier_wait."""
    offsets = {0: 0.0, 1: 5.0}
    docs = [
        _barrier_sidecar(
            0,
            offsets,
            {
                "fs_write": {"s": 2.0, "wall": 2.0, "bytes": 1 << 30, "n": 4},
                "barrier_wait": {"s": 5.0, "wall": 5.0, "bytes": 0, "n": 1},
            },
        ),
        _barrier_sidecar(
            1,
            offsets,
            {
                "fs_write": {"s": 7.0, "wall": 7.0, "bytes": 1 << 30, "n": 4},
                "d2h": {"s": 1.0, "wall": 1.0, "bytes": 1 << 30, "n": 4},
                "barrier_wait": {"s": 0.01, "wall": 0.01, "bytes": 0, "n": 1},
            },
        ),
    ]
    snap_dir = tmp_path / "snap"
    (snap_dir / "telemetry").mkdir(parents=True)
    for doc in docs:
        path = snap_dir / "telemetry" / f"async_take-{OP[:8]}-rank{doc['rank']}.json"
        path.write_text(json.dumps(doc))
    return docs, snap_dir


def test_barrier_blame_golden(barrier_fixture):
    """Skew 5 s, rank 1 blamed, fs_write named as the phase the fleet
    waited on (barrier_wait excluded from blame)."""
    docs, _ = barrier_fixture
    (rep,) = analyze.barrier_blame(docs)
    assert rep["kind"] == "async_take" and rep["world"] == 2
    assert rep["skew_s"] == pytest.approx(5.0)
    assert rep["first_rank"] == 0
    assert rep["blamed_rank"] == 1
    assert rep["blamed_phase"] == "fs_write"
    assert rep["blamed_phase_wall_s"] == pytest.approx(7.0)
    assert rep["arrivals_rel_s"] == {"0": 0.0, "1": 5.0}
    assert rep["barrier_wait_s"]["0"] == pytest.approx(5.0)
    assert [rep] == jax_analyze.barrier_blame(docs)


def test_barrier_blame_from_sidecars_renders_the_straggler(barrier_fixture):
    _, snap_dir = barrier_fixture
    reports = analyze.barrier_blame(analyze.load_sidecars(str(snap_dir)))
    (rep,) = reports
    assert rep["blamed_rank"] == 1 and rep["blamed_phase"] == "fs_write"
    out = analyze.render_barrier(reports)
    assert "skew 5.000s" in out
    assert "rank 1 arrived last" in out
    assert "fs_write" in out and "<< straggler" in out
    assert out == jax_analyze.render_barrier(reports)


def test_barrier_blame_requires_two_ranks(tmp_path):
    """Single-rank sidecars (or none) yield no report."""
    snap_dir = tmp_path / "snap"
    (snap_dir / "telemetry").mkdir(parents=True)
    doc = _barrier_sidecar(0, {0: 0.0}, {})
    (snap_dir / "telemetry" / "async_take-x-rank0.json").write_text(json.dumps(doc))
    assert analyze.barrier_blame([doc]) == []
    assert analyze.barrier_blame(analyze.load_sidecars(str(snap_dir))) == []
    assert "no barrier data" in analyze.render_barrier([])


def _recorded_phase_names():
    """(name, file:line) of every phase the port's sources record: the
    first argument of ``phase_stats.timed``/``add``/``tagged`` when it is a
    literal or a conditional of literals, and the names that the fs
    plugin's ``_read_into`` returns for the read it made."""
    found = []
    for dirpath, _, files in os.walk(PORT_DIR):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), path)
            rel = os.path.relpath(path, PORT_DIR)
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                func = node.func
                if not (
                    isinstance(func, ast.Attribute)
                    and func.attr in ("timed", "add", "tagged")
                    and isinstance(func.value, ast.Name)
                    and func.value.id == "phase_stats"
                ):
                    continue
                arg = node.args[0]
                consts = [arg.body, arg.orelse] if isinstance(arg, ast.IfExp) else [arg]
                for const in consts:
                    if isinstance(const, ast.Constant) and isinstance(const.value, str):
                        found.append((const.value, f"{rel}:{node.lineno}"))
            if rel == os.path.join("storage_plugins", "fs.py"):
                for node in ast.walk(tree):
                    if isinstance(node, ast.Return) and isinstance(node.value, (ast.Tuple, ast.Constant)):
                        elts = node.value.elts if isinstance(node.value, ast.Tuple) else [node.value]
                        for const in elts:
                            if isinstance(const, ast.Constant) and isinstance(const.value, str):
                                if const.value.endswith(("_read", "_write")):
                                    found.append((const.value, f"{rel}:{node.lineno}"))
    return found


def test_every_phase_the_port_records_is_classified():
    found = _recorded_phase_names()
    names = {name for name, _ in found}
    # The scan sees the port's own names and the read path's returns.
    assert {"pinned_alloc", "stage_alloc", "native_write_batch", "fs_read", "native_read", "s3_put"} <= names
    assert len(names) >= 40
    unclassified = sorted(where for name, where in found if analyze.classify_phase(name) == "other")
    assert unclassified == []
    # The three port-only phases the JAX table leaves in "other".
    for name in ("pinned_alloc", "stage_alloc", "native_write_batch"):
        assert jax_analyze.classify_phase(name) == "other"
