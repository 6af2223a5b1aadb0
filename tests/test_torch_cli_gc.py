"""The port CLI's ``gc`` and ``postmortem``: mirrors of
tests/test_faults.py's gc cases and tests/test_postmortem.py's CLI case,
and the remediation loop the postmortem prescribes.

- ``gc`` lists, then with ``--apply`` removes, an uncommitted step; it
  refuses a committed snapshot (exit 2) and a live in-flight marker
  (exit 3) unless ``--force``.
- The dry run and ``--apply`` name uncommitted journal segments and the
  orphan chunks they leave, line for line.
- A port child killed mid-take by a ``crash`` fault leaves a root whose
  report's ``gc`` command, run as printed in a subprocess
  (``python -m torchsnapshot_tpu_torch gc <root> --apply --force``),
  exits 0 and leaves a report with no debris and no ``gc`` action.
- ``postmortem --json`` and ``--perfetto`` through
  ``python -m torchsnapshot_tpu_torch``.

Two tests start the CLI in a subprocess; the others call ``main(argv)``."""

import json
import os
import shlex
import socket
import subprocess
import sys
import time

import pytest
import torch

from torchsnapshot_tpu_torch import StateDict
from torchsnapshot_tpu_torch.__main__ import main
from torchsnapshot_tpu_torch.manager import SnapshotManager
from torchsnapshot_tpu_torch.telemetry import postmortem

from test_torch_postmortem import crash_child
from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEBRIS = ("orphan_steps", "orphan_chunks", "orphan_segments", "inflight_markers")


def _state(v=1):
    return {"m": StateDict({"w": torch.full((256,), float(v)), "step": v})}


def _cli(*argv):
    """``python -m torchsnapshot_tpu_torch <argv>`` from the checkout."""
    return subprocess.run(
        [sys.executable, "-m", "torchsnapshot_tpu_torch", *argv],
        cwd=REPO_ROOT,
        capture_output=True,
        text=True,
        timeout=120,
    )


def test_gc_cli_lists_then_removes(tmp_path, capsys):
    root = tmp_path / "ckpts"
    mgr = SnapshotManager(str(root))
    mgr.save(1, _state(1))
    orphan = root / "step_9"
    orphan.mkdir(parents=True)
    (orphan / "0%2Fm%2Fw").write_bytes(b"junk")

    assert mgr.orphan_steps() == [9]

    # dry run: reports, removes nothing
    assert main(["gc", str(root)]) == 0
    assert orphan.exists()
    out = capsys.readouterr().out
    assert out.splitlines()[:2] == [
        "orphan step_9 (no .snapshot_metadata)",
        "1 orphaned snapshot dir(s); re-run with --apply to remove (only when no save is in flight)",
    ]
    # apply: removes the orphan, keeps the committed step
    assert main(["gc", str(root), "--apply"]) == 0
    assert capsys.readouterr().out == "removed step_9 (uncommitted)\n1 orphaned snapshot dir(s) removed\n"
    assert not orphan.exists()
    assert mgr.all_steps() == [1]
    dst = _state(0)
    assert mgr.restore_latest(dst) == 1
    assert torch.equal(dst["m"]["w"], torch.full((256,), 1.0))


def test_gc_refuses_committed_snapshot_root(tmp_path, capsys):
    mgr = SnapshotManager(str(tmp_path / "ckpts"))
    mgr.save(1, _state(1))
    # pointing gc INSIDE a committed snapshot would classify its payload
    # dirs as orphans: refused outright
    step = str(tmp_path / "ckpts" / "step_1")
    assert main(["gc", step, "--apply"]) == 2
    assert capsys.readouterr().out == (
        f"{step} is a committed snapshot, not a manager root; refusing to gc inside it\n"
    )
    assert mgr.all_steps() == [1]


def test_gc_live_marker_refuses_until_forced(tmp_path, capsys):
    """A marker whose pid is this live process and whose stamp is fresh
    looks like a save in flight: ``--apply`` exits 3 and removes nothing;
    ``--force`` removes the orphan and the marker."""
    root = tmp_path / "ckpts"
    mgr = SnapshotManager(str(root))
    mgr.save(1, _state(1))
    (root / "step_2").mkdir()
    (root / "step_2" / "0%2Fm%2Fw").write_bytes(b"partial")
    marker = {"step": 2, "kind": "step", "pid": os.getpid(), "host": socket.gethostname(),
              "started": time.time(), "stamp": time.time()}
    (root / ".inflight_step_2.json").write_text(json.dumps(marker))

    assert main(["gc", str(root)]) == 0
    out = capsys.readouterr().out
    assert f"in-flight marker .inflight_step_2.json (pid {os.getpid()} on {socket.gethostname()})" in out
    assert main(["gc", str(root), "--apply"]) == 3
    out = capsys.readouterr().out
    assert out.startswith("gc refused: in-flight save marker(s) ['.inflight_step_2.json']")
    assert (root / "step_2").exists() and (root / ".inflight_step_2.json").exists()

    assert main(["gc", str(root), "--apply", "--force"]) == 0
    assert capsys.readouterr().out == "removed step_2 (uncommitted)\n1 orphaned snapshot dir(s) removed\n"
    assert not (root / "step_2").exists() and not (root / ".inflight_step_2.json").exists()
    assert mgr.inflight_markers() == [] and mgr.all_steps() == [1]


def test_gc_names_segments_and_orphan_chunks(tmp_path, capsys):
    """A journal segment whose commit marker never landed: the dry run
    lists it and the chunks only it wrote; ``--apply`` removes both, and
    names each."""
    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root, journal=True)
    mgr.save(0, {"m": StateDict({"a": torch.arange(4096, dtype=torch.float32), "b": torch.zeros(4096)})})
    mgr.save(1, {"m": StateDict({"a": torch.arange(4096, dtype=torch.float32), "b": torch.ones(4096)})})
    assert [p for p in mgr.restore_points()] == [(0, "full"), (1, "seg")]
    os.unlink(os.path.join(root, "seg_1", ".snapshot_metadata"))
    steps, chunks, segs = mgr.gc_detail(apply=False)
    assert steps == [] and segs == [1] and chunks

    assert main(["gc", root]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "orphan/stale journal segment seg_1"
    assert out[2] == "1 journal segment(s); --apply sweeps them too"
    assert out[3 : 3 + len(chunks)] == [f"orphan chunk {c} (referenced by no committed step)" for c in chunks]
    assert out[3 + len(chunks)] == f"{len(chunks)} orphan CAS chunk(s); --apply sweeps them too"

    assert main(["gc", root, "--apply"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == (
        ["0 orphaned snapshot dir(s) removed", "removed seg_1 (journal)", "1 journal segment(s) removed"]
        + [f"removed orphan chunk {c}" for c in chunks]
        + [f"{len(chunks)} orphan CAS chunk(s) removed"]
    )
    assert not os.path.exists(os.path.join(root, "seg_1"))
    assert all(not os.path.exists(os.path.join(root, c)) for c in chunks)
    assert mgr.gc_detail(apply=False) == ([], [], [])


def test_postmortem_prescribed_gc_runs_and_converges(tmp_path, capsys):
    """The remediation loop end to end: the report names the killed child,
    ``postmortem --json`` in-process says the same, and the report's own gc
    line, run as a command (``python`` replaced by this interpreter),
    exits 0, names the step it removed, and converges."""
    root, bb = str(tmp_path / "root"), str(tmp_path / "bb")
    pid = crash_child(root, bb)
    report = postmortem.analyze_root(root, blackbox_dir=bb)
    assert main(["postmortem", root, "--blackbox", bb, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["classification"] == report["classification"] == "killed_mid_take"
    assert doc["first_dead"]["pid"] == report["first_dead"]["pid"] == pid
    assert main(["postmortem", root, "--blackbox", bb]) == 0
    assert f"  [gc] python -m torchsnapshot_tpu_torch gc {root} --apply --force" in capsys.readouterr().out

    (gc,) = [a for a in report["remediation"]["actions"] if a["action"] == "gc"]
    argv = shlex.split(gc["command"])
    assert argv[:3] == ["python", "-m", "torchsnapshot_tpu_torch"]
    proc = subprocess.run(
        [sys.executable, *argv[1:]], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    for step in gc["reclaims"]["steps"]:
        assert f"removed step_{step} (uncommitted)" in lines
    assert f"{len(gc['reclaims']['steps'])} orphaned snapshot dir(s) removed" in lines
    if gc["reclaims"]["chunks"]:
        assert f"{gc['reclaims']['chunks']} orphan CAS chunk(s) removed" in lines

    after = postmortem.analyze_root(root, blackbox_dir=bb)
    assert {k: after["debris"][k] for k in DEBRIS} == {k: [] for k in DEBRIS}
    assert not any(a["action"] == "gc" for a in after["remediation"]["actions"])
    # Nothing left to collect: a second run of the same line removes nothing.
    assert main(["gc", root, "--apply", "--force"]) == 0
    assert capsys.readouterr().out == "0 orphaned snapshot dir(s) removed\n"


def test_postmortem_cli_json_and_perfetto(tmp_path):
    root = str(tmp_path / "root")
    bb = str(tmp_path / "bb")
    pid = crash_child(root, bb)
    out = _cli("postmortem", root, "--blackbox", bb, "--json")
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(out.stdout)
    assert doc["classification"] == "killed_mid_take"
    assert doc["first_dead"]["pid"] == pid
    perfetto_path = str(tmp_path / "pm.json")
    out = _cli("postmortem", root, "--blackbox", bb, "--perfetto", "--out", perfetto_path)
    assert out.returncode == 0, out.stderr[-2000:]
    with open(perfetto_path, encoding="utf-8") as f:
        trace_doc = json.load(f)
    assert trace_doc["traceEvents"], "timeline must not be empty"
    assert all("ts" in e for e in trace_doc["traceEvents"])
    assert out.stdout == f"wrote {len(trace_doc['traceEvents'])} timeline event(s) to {perfetto_path}\n"
