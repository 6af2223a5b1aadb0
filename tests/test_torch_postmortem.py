"""The port's postmortem: mirrors of tests/test_postmortem.py's classifier
and server-tracer cases, and its verdicts one by one.

- A port child killed mid-take by a ``crash`` fault (``python -c``, CAS on,
  no JAX) is named by ``analyze_root``: ``killed_mid_take``, verdict
  ``crash_fault``, op ``take``, the ring's pid, the faulted write; the
  prescribed ``gc --force`` converges.  ``to_perfetto`` and
  ``format_report`` render that report (the library half of the CLI case,
  whose command line waits for the port's CLI).
- A clean root is ``no_failure``; the heartbeat written by the port's
  monitor lands in the timeline.
- ``ServerTracer`` flushes an idle daemon's spans and flushes on close.
- Each death verdict (``pid_dead``, ``exited``, ``silent_past_grace``,
  ``spool_stale``), the coordination leases of a FileStore directory, and
  the classifier's table."""

import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from torchsnapshot_tpu_torch import StateDict, knobs
from torchsnapshot_tpu_torch.dist_store import FileStore
from torchsnapshot_tpu_torch.manager import SnapshotManager
from torchsnapshot_tpu_torch.telemetry import blackbox, fleet, postmortem
from torchsnapshot_tpu_torch.telemetry import monitor as tmonitor
from torchsnapshot_tpu_torch.telemetry import trace as ttrace

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

_CHILD_TAKE = """
import os, sys
import torch
from torchsnapshot_tpu_torch import SnapshotManager, StateDict

assert "jax" not in sys.modules
SnapshotManager(sys.argv[1]).save(0, {"m": StateDict({"w": torch.arange(1 << 18, dtype=torch.float32)})})
os._exit(7)  # never reached: the crash fault fires mid-take
"""


def crash_child(root, bb, faults="write:1:crash@cas/*"):
    """Run a port child that saves step 0 of ``root`` under ``faults`` with
    the flight recorder in ``bb``; returns its pid (the ring's)."""
    env = dict(os.environ)  # default_knob_env left no TPUSNAP_ knob set
    env.update(
        {
            "TPUSNAP_FAULTS": faults,
            "TPUSNAP_SIDECAR": "0",
            "TPUSNAP_BLACKBOX": str(bb),
            "TPUSNAP_CAS": "1",
            "TPUSNAP_DISABLE_BATCHER": "1",
        }
    )
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD_TAKE, str(root)], env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 1, f"child should die on the crash fault, got {proc.returncode}: {proc.stderr[-2000:]}"
    (ring_path,) = blackbox.read_all(str(bb)).keys()
    return int(os.path.basename(ring_path).rsplit("-", 1)[1][: -len(".ring")])


def test_postmortem_names_mid_take_kill(tmp_path):
    root, bb = str(tmp_path / "root"), str(tmp_path / "bb")
    pid = crash_child(root, bb)
    report = postmortem.analyze_root(root, blackbox_dir=bb)
    assert report["classification"] == "killed_mid_take"
    fd = report["first_dead"]
    assert fd["verdict"] == "crash_fault" and fd["op"] == "take"
    assert fd["pid"] == pid != os.getpid()
    assert fd["fault"]["op"] == "write" and fd["fault"]["path"].startswith("cas/")
    # Within one phase of the kill point: the chunk write or the
    # serialize-side phase right before it.
    assert fd["phase_group"] in ("storage_io", "serialize"), fd
    markers = report["debris"]["inflight_markers"]
    assert markers and all(m["pid"] == pid for m in markers)
    (gc,) = [a for a in report["remediation"]["actions"] if a["action"] == "gc"]
    assert gc["force"] is True
    assert gc["command"] == f"python -m torchsnapshot_tpu_torch gc {root} --apply --force"
    assert gc["reclaims"]["markers"] == len(markers)
    assert report["remediation"]["restore"] == {"committed_points": 0, "newest": None, "expected_fallback_depth": 0}

    SnapshotManager(root).gc_detail(apply=True, force=True)
    after = postmortem.analyze_root(root, blackbox_dir=bb)
    assert after["debris"]["orphan_steps"] == []
    assert after["debris"]["orphan_chunks"] == []
    assert after["debris"]["orphan_segments"] == []
    assert after["debris"]["inflight_markers"] == []
    assert not any(a["action"] == "gc" for a in after["remediation"]["actions"])


def test_postmortem_clean_root_is_no_failure(tmp_path):
    root, bb = str(tmp_path / "root"), str(tmp_path / "bb")
    with knobs.override_blackbox_dir(bb), knobs.override_sidecar(False):
        SnapshotManager(root).save(0, {"m": StateDict({"w": torch.arange(256, dtype=torch.float32)})})
    # This process's own (live) ring shows a closed op: nothing died.
    report = postmortem.analyze_root(root, blackbox_dir=bb)
    assert report["classification"] == "no_failure"
    assert report["first_dead"] is None
    (proc,) = report["processes"]
    assert proc["pid"] == os.getpid() and proc["verdict"] == "alive" and proc["open_op"] is None
    assert report["remediation"]["restore"]["committed_points"] == 1
    assert [a["action"] for a in report["remediation"]["actions"]] == ["restore_latest"]


def test_postmortem_heartbeat_enrichment(tmp_path):
    """The port monitor's heartbeat names the op kind, trace id and phase,
    and the postmortem folds it into the timeline."""
    hb = str(tmp_path / "hb.json")
    with knobs.override_heartbeat_file(hb), knobs.override_sidecar(False):
        mon = tmonitor.op_started("take", "feedbeef" * 4, rank=0)
        try:
            mon._write_heartbeat()
        finally:
            tmonitor.op_finished(mon, success=True)
    with open(hb, encoding="utf-8") as f:
        doc = json.load(f)
    assert doc["op_kind"] == "take"
    assert doc["phase"] is None or isinstance(doc["phase"], str)
    assert "trace_id" in doc
    report = postmortem.analyze_root(str(tmp_path), heartbeat_path=hb, blackbox_dir=str(tmp_path / "bb"))
    (entry,) = [e for e in report["timeline"] if e["source"] == "heartbeat"]
    assert entry["name"] == "take" and entry["t"] == doc["heartbeat_time"]
    assert report["heartbeat"]["op_kind"] == "take"


def test_perfetto_and_text_of_a_kill(tmp_path):
    root, bb = str(tmp_path / "root"), str(tmp_path / "bb")
    pid = crash_child(root, bb)
    report = postmortem.analyze_root(root, blackbox_dir=bb)
    stamps = [e["t"] for e in report["timeline"]]
    assert stamps and stamps == sorted(stamps)
    doc = json.loads(json.dumps(postmortem.to_perfetto(report)))
    events = doc["traceEvents"]
    assert len(events) == len(report["timeline"]) and doc["displayTimeUnit"] == "ms"
    assert all(e["ph"] == "i" and "ts" in e for e in events)
    assert {e["pid"] for e in events} == {pid}
    assert "fault:crash" in [e["name"] for e in events]
    text = postmortem.format_report(report)
    assert "classification: killed_mid_take" in text
    assert f"first dead: pid {pid} rank 0" in text
    assert "  injected kill point: write cas/" in text
    assert f"  [gc] python -m torchsnapshot_tpu_torch gc {root} --apply --force" in text
    assert text.splitlines()[-1] == "restore: 0 committed point(s) available"


# ------------------------------------------------- ServerTracer idle flush


def test_server_tracer_flushes_while_idle(tmp_path):
    """Spans recorded after the last flush land within about one flush
    interval with no further traffic: the background flusher writes them."""
    with knobs.override_peer_trace_flush_s(0.2):
        tracer = ttrace.ServerTracer(str(tmp_path), "deadbeefcafe")
        try:
            tracer.record_span("peerd_handle", 0.0, 1000.0, {"trace": "t1"})
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and not os.path.exists(tracer.path):
                time.sleep(0.05)
            assert os.path.exists(tracer.path), "idle daemon never flushed its buffered span"
            with open(tracer.path, encoding="utf-8") as f:
                names = [e.get("name") for e in json.load(f)["traceEvents"]]
            assert "peerd_handle" in names
        finally:
            tracer.close()
        assert not tracer._flusher.is_alive()


def test_server_tracer_flush_on_close(tmp_path):
    with knobs.override_peer_trace_flush_s(3600.0):
        tracer = ttrace.ServerTracer(str(tmp_path), "deadbeefcafe")
        tracer.record_span("peerd_handle", 0.0, 1000.0, {"trace": "t1"})
        # The interval is far off: only close() can write the span.
        path = tracer.close()
    assert path and os.path.exists(path)
    with open(path, encoding="utf-8") as f:
        assert any(e.get("name") == "peerd_handle" for e in json.load(f)["traceEvents"])
    assert not tracer._flusher.is_alive()


# ------------------------------------------------------------- the verdicts


def _dead_pid() -> int:
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    return proc.pid


def _records(pid, host, t, open_op):
    recs = [{"seq": 0, "t": t, "host": host, "pid": pid, "kind": "op", "name": "take.start",
             "data": {"op_id": "ab" * 16, "rank": 3}}]
    if not open_op:
        recs.append({"seq": 1, "t": t, "host": host, "pid": pid, "kind": "op", "name": "take.end",
                     "data": {"op_id": "ab" * 16, "rank": 3, "success": True}})
    return recs


@pytest.mark.parametrize(
    "case,verdict,died_mid_work",
    [
        ("dead_pid_open_op", "pid_dead", True),
        ("dead_pid_ops_closed", "exited", False),
        ("other_host_silent", "silent_past_grace", True),
        ("live_pid_open_op", "alive", False),
    ],
)
def test_process_verdicts(case, verdict, died_mid_work):
    here, now = socket.gethostname(), time.time()
    pid, host, t, open_op = {
        "dead_pid_open_op": (_dead_pid(), here, now, True),
        "dead_pid_ops_closed": (_dead_pid(), here, now, False),
        "other_host_silent": (12345, here + "-elsewhere", now - 60.0, True),
        "live_pid_open_op": (os.getpid(), here, now - 60.0, True),
    }[case]
    records = _records(pid, host, t, open_op)
    story = postmortem._reconstruct_process("x.ring", records, grace_s=1.0)
    assert story["verdict"] == verdict
    assert story["dead"] == (verdict != "alive")
    assert story["died_mid_work"] == died_mid_work
    assert story["rank"] == 3 and story["records"] == len(records)
    assert (story["open_op"] is not None) == open_op


def test_stale_spool_entry_names_a_worker_without_a_ring(tmp_path):
    """A suspected-dead fleet entry (stale while its op was in flight) of a
    pid with no ring is a death: ``spool_stale``, op from the entry."""
    root = tmp_path / "root"
    spool = root / "telemetry" / "live"
    spool.mkdir(parents=True)
    doc = {"host": "elsewhere", "pid": 4242, "kind": "restore", "rank": 1, "op_id": "cd" * 16,
           "publish_time": time.time() - 30.0, "op": {"done": False}}
    (spool / f"elsewhere-4242-restore{fleet.ENTRY_SUFFIX}").write_text(json.dumps(doc))
    with knobs.override_fleet_telemetry_stale_s(5.0):
        report = postmortem.analyze_root(str(root), blackbox_dir=str(tmp_path / "bb"))
    assert report["classification"] == "killed_mid_restore"
    fd = report["first_dead"]
    assert (fd["pid"], fd["rank"], fd["verdict"], fd["op"]) == (4242, 1, "spool_stale", "restore")
    (entry,) = report["timeline"]
    assert (entry["source"], entry["name"]) == ("fleet_spool", "suspected_dead")


def test_coord_leases_of_a_filestore(tmp_path):
    store = FileStore(str(tmp_path / "coord"))
    now = time.time()
    store.set("oplease/0", b"done")
    store.set("oplease/1", str(now).encode())
    store.set("oplease/2", str(now - 100.0).encode())
    store.set("pg/other", b"x")
    with knobs.override_lease_grace_s(10.0):
        leases = postmortem._gather_coord_leases(str(tmp_path / "coord"))
    assert [(lease["rank"], lease["state"]) for lease in leases] == [(0, "tombstone"), (1, "live"), (2, "stale")]
    assert leases[2]["age_s"] >= 100.0
    assert postmortem._gather_coord_leases(str(tmp_path / "absent")) == []


def test_classifier_table():
    def story(open_kind=None, path="", lease_events=(), preempting=False, stalls=0):
        return {"open_op": {"kind": open_kind} if open_kind else None, "fault": {"path": path} if path else None,
                "lease_events": list(lease_events), "preempting": preempting, "stalls": stalls}

    sweep = ("store_sweep.acquire",)
    cases = [
        (None, [story()], None, "no_failure"),
        (None, [story(stalls=1)], None, "stalled"),
        (story("take", "cas/xxh64/ab"), [], None, "killed_mid_take"),
        (story("async_take"), [], None, "killed_mid_take"),
        (story("restore"), [], None, "killed_mid_restore"),
        (story(path="sweep/epoch.json"), [], None, "killed_mid_sweep"),
        (story(path="quarantine/3/.condemned"), [], None, "killed_mid_condemn"),
        (story(lease_events=sweep), [], {"sweep_lease": {"phase": "condemn"}}, "killed_mid_condemn"),
        (story(lease_events=sweep), [], {"sweep_lease": {"phase": "mark"}}, "killed_mid_sweep"),
        (story("take", preempting=True), [], None, "preempted"),
        (story(preempting=True), [], None, "preempted"),
        (story(), [], None, "killed"),
    ]
    assert [postmortem._classify(fd, procs, st) for fd, procs, st, _ in cases] == [c[-1] for c in cases]
