"""``python -m torchsnapshot_tpu_torch trace`` and ``analyze``, mirroring the
``cli_main`` cases of tests/test_telemetry.py (the trace merge) and
tests/test_analyze.py (the straggler report as JSON and as text, invalid
and empty input, the barrier blame, one rank's sidecars), over the port's
own traced take and restore and over the synthetic fixtures of
tests/test_torch_analyze.py (a two-rank take with a known straggler and
dominant phase, two ranks' barrier sidecars):

- ``trace --out`` merges a take's and a restore's files into one valid
  document; an empty directory exits 2, an invalid file 1;
- ``trace --fleet --spool`` over a take and a restore that published into a
  fleet spool prints one ``trace <id>`` line per trace id, with the count of
  the files' events that carry it;
- ``analyze`` prints the library's report (``--json`` equal to
  ``analyze_traces``), exits 1 on an invalid trace and 2 on none;
  ``--barrier`` prints ``barrier_blame``'s reports and exits 2 without two
  ranks; ``--peer`` exits 2 when no span names a peer."""

import glob
import json
import os

import pytest
import torch

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.__main__ import main as cli_main
from torchsnapshot_tpu_torch.telemetry import analyze, fleet, trace
from torchsnapshot_tpu_torch.telemetry import monitor as tmonitor

from test_torch_analyze import _barrier_sidecar, barrier_fixture, two_rank_fixture  # noqa: F401  fixtures
from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


@pytest.fixture(autouse=True)
def _no_leaked_monitors():
    yield
    assert tmonitor._ACTIVE == [], "leaked op monitors"
    assert trace._ACTIVE == [], "leaked trace ops"


def _traced_take_restore(tmp_path, spool=None):
    """A traced take of a 16x16 tensor and its restore; returns the trace
    directory and the snapshot path."""
    trace_dir = str(tmp_path / "traces")
    snap_path = str(tmp_path / "snap")
    fleet.reset_process_totals()
    with knobs.override_trace_dir(trace_dir), knobs.override_fleet_telemetry(spool):
        snap = ts.Snapshot.take(snap_path, {"m": ts.StateDict({"w": torch.ones(16, 16)})})
        dst = {"m": ts.StateDict({"w": torch.zeros(16, 16)})}
        snap.restore(dst)
    assert torch.equal(dst["m"]["w"], torch.ones(16, 16))
    return trace_dir, snap_path


def _run(argv, capsys):
    capsys.readouterr()
    rc = cli_main(argv)
    return rc, capsys.readouterr().out


def test_trace_cli_merges_and_validates(tmp_path, capsys):
    trace_dir, _ = _traced_take_restore(tmp_path)
    out = tmp_path / "merged.json"
    rc, text = _run(["trace", trace_dir, "--out", str(out)], capsys)
    assert rc == 0
    merged = json.loads(out.read_text())
    assert trace.validate_trace(merged) == []
    kinds = {s.get("kind") for s in merged["otherData"]["merged_from"]}
    assert kinds == {"take", "restore"}
    n_spans = sum(1 for ev in merged["traceEvents"] if ev["ph"] == "X")
    assert f"merged 2 trace file(s): 1x restore, 1x take, {n_spans} spans" in text
    assert text.rstrip().endswith(f"wrote {out} (open in ui.perfetto.dev or chrome://tracing)")
    for path in sorted(glob.glob(os.path.join(trace_dir, "*" + trace.TRACE_FILE_SUFFIX))):
        assert f"  {os.path.basename(path)}\n" in text


def test_trace_cli_exit_codes(tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    assert _run(["trace", str(empty)], capsys) == (2, f"no *{trace.TRACE_FILE_SUFFIX} files under {empty}\n")
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "x.trace.json").write_text('{"traceEvents": [{"name": "x", "ph": "X", "ts": 1}]}')
    rc, out = _run(["trace", str(bad)], capsys)
    assert rc == 1 and out.startswith("invalid trace input: ")
    assert _run(["trace", str(bad), "--fleet"], capsys)[0] == 1


def test_trace_fleet_prints_each_trace_id(tmp_path, capsys):
    spool = str(tmp_path / "spool")
    trace_dir, _ = _traced_take_restore(tmp_path, spool=spool)
    want: dict = {}
    for path in glob.glob(os.path.join(trace_dir, "*" + trace.TRACE_FILE_SUFFIX)):
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        for ev in doc["traceEvents"]:
            tid = (ev.get("args") or {}).get("trace") or doc["otherData"].get("trace_id")
            if ev["ph"] != "M" and tid:
                want[tid] = want.get(tid, 0) + 1
    assert len(want) == 2  # the take's and the restore's
    rc, out = _run(["trace", trace_dir, "--fleet", "--spool", spool], capsys)
    assert rc == 0
    for tid, count in want.items():
        assert f"  trace {tid}: {count} span(s)\n" in out
    # One host: no skew to correct.
    assert "clock skew corrected" not in out
    assert os.listdir(spool)  # the ops did publish into it


def test_analyze_json_names_straggler_and_dominant_phase(two_rank_fixture, capsys):
    trace_dir, snap_dir = two_rank_fixture
    rc, out = _run(["analyze", str(trace_dir), "--snapshot", str(snap_dir), "--json"], capsys)
    assert rc == 0
    analysis = json.loads(out)
    (op,) = analysis["ops"]
    assert op["kind"] == "take" and op["world"] == 2
    assert op["straggler_rank"] == 1
    assert op["dominant_phase"] == "fs_write"
    assert op["limiting_resource"] == "storage_io"
    assert op["skew"] == pytest.approx(2.0)
    assert op["phases"]["fs_write"]["max_wall_s"] == pytest.approx(16.0)
    assert op["idle"]["by_rank"]["0"] == pytest.approx(1.0)
    assert op["sidecars"]["1"]["duration_s"] == 20.0
    assert op["sidecars"]["0"]["rss_high_water_bytes"] == 123456789
    want = analyze.analyze_traces(analyze.load_trace_dir(str(trace_dir)), analyze.load_sidecars(str(snap_dir)))
    assert out == json.dumps(want, indent=1) + "\n"


def test_analyze_human_output_names_both(two_rank_fixture, capsys):
    trace_dir, _ = two_rank_fixture
    rc, out = _run(["analyze", str(trace_dir)], capsys)
    assert rc == 0
    assert "straggler: rank 1" in out
    assert "dominant phase fs_write" in out
    assert "limiting resource: storage_io" in out
    assert out == analyze.render(analyze.analyze_traces(analyze.load_trace_dir(str(trace_dir)))) + "\n"


def test_analyze_rejects_invalid_trace(tmp_path, capsys):
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "x.trace.json").write_text('{"traceEvents": "nope"}')
    assert _run(["analyze", str(bad)], capsys)[0] == 1
    (bad / "x.trace.json").write_text("not json at all")
    rc, out = _run(["analyze", str(bad)], capsys)
    assert rc == 1 and out.startswith("invalid trace input: ")
    empty = tmp_path / "empty"
    empty.mkdir()
    assert _run(["analyze", str(empty)], capsys) == (2, f"no *{trace.TRACE_FILE_SUFFIX} files under {empty}\n")
    # No span names a peer: the peer report is empty.
    trace_dir, _ = _traced_take_restore(tmp_path)
    rc, out = _run(["analyze", trace_dir, "--peer", "--json"], capsys)
    assert rc == 2 and json.loads(out) == analyze.peer_report(analyze.load_trace_dir(trace_dir))


def test_analyze_of_a_traced_take_and_restore(tmp_path, capsys):
    trace_dir, snap_path = _traced_take_restore(tmp_path)
    rc, out = _run(["analyze", trace_dir, "--snapshot", snap_path, "--json"], capsys)
    assert rc == 0
    report = json.loads(out)
    assert sorted(op["kind"] for op in report["ops"]) == ["restore", "take"]
    assert all(op["sidecars"] for op in report["ops"])
    rc, text = _run(["analyze", trace_dir], capsys)
    assert rc == 0
    for op in report["ops"]:
        assert f"{op['kind']} {op['op'][:8]} " in text


def test_barrier_blame_cli_json_and_human(barrier_fixture, capsys):
    _, barrier_snapshot = barrier_fixture
    rc, out = _run(["analyze", str(barrier_snapshot), "--barrier", "--json"], capsys)
    assert rc == 0
    (rep,) = json.loads(out)
    assert rep["blamed_rank"] == 1 and rep["blamed_phase"] == "fs_write"
    assert json.loads(out) == analyze.barrier_blame(analyze.load_sidecars(str(barrier_snapshot)))
    rc, out = _run(["analyze", str(barrier_snapshot), "--barrier"], capsys)
    assert rc == 0
    assert "skew 5.000s" in out
    assert "rank 1 arrived last" in out
    assert "fs_write" in out and "<< straggler" in out
    # --snapshot names the sidecars' snapshot in place of the positional.
    assert _run(["analyze", "unused", "--barrier", "--snapshot", str(barrier_snapshot)], capsys) == (0, out)


def test_barrier_blame_requires_two_ranks(tmp_path, capsys):
    snap_dir = tmp_path / "snap"
    (snap_dir / "telemetry").mkdir(parents=True)
    doc = _barrier_sidecar(0, {0: 0.0}, {})
    (snap_dir / "telemetry" / "async_take-x-rank0.json").write_text(json.dumps(doc))
    rc, out = _run(["analyze", str(snap_dir), "--barrier"], capsys)
    assert rc == 2
    assert "no barrier data" in out
