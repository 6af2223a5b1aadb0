"""The health monitor and the flight recorder across the two packages:
what crosses between torchsnapshot_tpu and torchsnapshot_tpu_torch is the
same.

- A ring file written by either package's recorder is read by the other's
  ``read_ring``/``read_all`` with equal records, and has the same name,
  slot layout and size.
- The heartbeat document and ``PendingSnapshot.progress()`` have the same
  keys, nested ones included, and so do the ``watchdog.stall`` event's
  metadata and a stall bundle's sections, the sampled profile included.
- The JAX package's ``postmortem.analyze_root`` names a port child killed
  mid-take by a ``crash`` fault (tests/test_postmortem.py:187's case, the
  child running the port): ``killed_mid_take``, verdict ``crash_fault``,
  op ``take``, the ring's pid.

Durations and stamps are never compared."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jax_pkg
import torchsnapshot_tpu_torch as port_pkg
from torchsnapshot_tpu import event_handlers as jax_events
from torchsnapshot_tpu.telemetry import blackbox as jax_blackbox
from torchsnapshot_tpu.telemetry import monitor as jax_monitor
from torchsnapshot_tpu.telemetry import postmortem
from torchsnapshot_tpu_torch import event_handlers as port_events
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.telemetry import blackbox as port_blackbox
from torchsnapshot_tpu_torch.telemetry import monitor as port_monitor

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

BLACKBOX = {"jax": jax_blackbox, "port": port_blackbox}
RECORDS = [
    ("op", "take.start", {"op_id": "ab" * 16, "rank": 0}),
    ("phase", "d2h", {"dur_s": 0.5, "nbytes": 1 << 20}),
    ("lease", "op_lease.acquire", {"rank": 0}),
    ("progress", "take", {"op_id": "ab" * 16, "requests": {"total": 3, "written": 1}}),
    ("event", "big", {"blob": "x" * 4096}),  # oversize: the envelope survives
    ("fault", "crash", {"op": "write", "path": "cas/xxh64/ab", "phase": "native_write_hash"}),
]


@pytest.fixture(autouse=True)
def _no_leaked_monitors():
    yield
    assert jax_monitor._ACTIVE == [] and port_monitor._ACTIVE == []


def _state(pkg, shape=(64, 64)):
    if pkg == "port":
        return {"m": port_pkg.StateDict({"w0": torch.ones(shape)})}
    return {"m": jax_pkg.StateDict({"w0": np.ones(shape, np.float32)})}


def _pkg(pkg):
    return port_pkg if pkg == "port" else jax_pkg


def _without_time(records):
    return [{k: v for k, v in r.items() if k != "t"} for r in records]


def _keys(doc):
    """The key structure of a progress or heartbeat document."""
    out = set(doc)
    for name in ("requests", "bytes"):
        out |= {f"{name}.{k}" for k in doc[name]}
    for pipe in doc["pipelines"]:
        out |= {f"pipelines.{k}" for k in pipe}
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ring_written_by_one_package_is_read_by_the_other(tmp_path, writer):
    reader = "port" if writer == "jax" else "jax"
    ring = BLACKBOX[writer].Ring(str(tmp_path / "bb"), slots=4, slot_bytes=256)
    for kind, name, data in RECORDS:
        assert ring.record(kind, name, data)
    ring.close()
    # Wrapped: the newest four of six records, in seq order.
    assert os.path.getsize(ring.path) == 4 * 256
    assert os.path.basename(ring.path).endswith(f"-{os.getpid()}.ring")
    mine, theirs = BLACKBOX[writer].read_ring(ring.path), BLACKBOX[reader].read_ring(ring.path)
    assert theirs == mine
    assert [r["seq"] for r in theirs] == [2, 3, 4, 5]
    assert [r["name"] for r in theirs] == ["op_lease.acquire", "take", "big", "crash"]
    assert theirs[2].get("trunc") is True and "data" not in theirs[2]
    assert BLACKBOX[reader].read_all(str(tmp_path / "bb")) == {ring.path: mine}
    # The other package's writer lays out the same slots byte for byte,
    # wall-clock stamps aside.
    other = BLACKBOX[reader].Ring(str(tmp_path / "bb2"), slots=4, slot_bytes=256)
    for kind, name, data in RECORDS:
        other.record(kind, name, data)
    other.close()
    assert _without_time(BLACKBOX[writer].read_ring(other.path)) == _without_time(mine)


def test_rings_of_real_takes_read_across(tmp_path):
    """Each package's take, recorded into its own directory, reads the same
    op records with the other package's reader."""
    names = {}
    for pkg in ("jax", "port"):
        bb = str(tmp_path / f"bb_{pkg}")
        with knobs.override_blackbox_dir(bb), knobs.override_sidecar(False):
            _pkg(pkg).Snapshot.take(str(tmp_path / pkg), _state(pkg))
        other = "port" if pkg == "jax" else "jax"
        (records,) = BLACKBOX[other].read_all(bb).values()
        names[pkg] = [(r["kind"], r["name"]) for r in records if r["kind"] in ("op", "lease")]
        assert BLACKBOX[pkg].read_all(bb) == BLACKBOX[other].read_all(bb)
    assert names["port"] == names["jax"] == [("op", "take.start"), ("op", "take.end")]


def test_progress_and_heartbeat_documents_have_the_same_keys(tmp_path):
    progress, heartbeat = {}, {}
    for pkg in ("jax", "port"):
        hb = tmp_path / f"hb_{pkg}.json"
        with knobs.override_heartbeat_file(str(hb)), knobs.override_progress_interval_s(0.05):
            pending = _pkg(pkg).Snapshot.async_take(str(tmp_path / pkg), _state(pkg))
            pending.wait()
        progress[pkg] = pending.progress()
        heartbeat[pkg] = json.loads(hb.read_text())
        assert progress[pkg]["done"] is True and heartbeat[pkg]["done"] is True
        assert progress[pkg]["bytes"]["written"] >= 64 * 64 * 4
    assert _keys(progress["port"]) == _keys(progress["jax"])
    assert _keys(heartbeat["port"]) == _keys(heartbeat["jax"])
    assert set(heartbeat["port"]) - set(progress["port"]) == {"heartbeat_time", "op_kind", "trace_id", "phase"}


# A section heading, less a measured parenthetical such as the sampled
# profile's "(0.3s @ 99 Hz, ...)".
_SECTION = re.compile(r"^--- ([a-z ]+(?: \([a-z]+\))?)(?: \(\d.*\))? ---$", re.M)


def test_stall_event_and_bundle_sections_match(tmp_path):
    """The same injected hang in each package: the watchdog.stall metadata
    keys are equal, and so are the bundle's sections."""
    events = {"jax": [], "port": []}
    sections = {}
    registries = {"jax": jax_events, "port": port_events}
    for pkg in ("jax", "port"):
        registries[pkg].register_event_handler(events[pkg].append)
        trace_dir = tmp_path / f"traces_{pkg}"
        try:
            with knobs.override_retry_base_s(0.001), knobs.override_trace_dir(
                str(trace_dir)
            ), knobs.override_stall_timeout_s(0.3), knobs.override_faults("write:1:latency:1.5"):
                _pkg(pkg).Snapshot.take(str(tmp_path / pkg), _state(pkg))
        finally:
            registries[pkg].unregister_event_handler(events[pkg].append)
        stall = next(e for e in events[pkg] if e.name == "watchdog.stall")
        with open(stall.metadata["bundle"], encoding="utf-8") as f:
            sections[pkg] = _SECTION.findall(f.read())
        events[pkg] = stall.metadata
    assert set(events["port"]) == set(events["jax"])
    assert events["port"]["action"] == events["jax"]["action"] == "take"
    assert sections["port"] == [
        "progress",
        "pipeline states",
        "pending asyncio tasks",
        "thread stacks (faulthandler)",
        "sampled profile",
    ]
    assert sections["jax"] == sections["port"]


_CHILD_TAKE = """
import os, sys
import torch
from torchsnapshot_tpu_torch import SnapshotManager, StateDict

assert "jax" not in sys.modules
SnapshotManager(sys.argv[1]).save(0, {"m": StateDict({"w": torch.arange(1 << 18, dtype=torch.float32)})})
os._exit(7)  # never reached: the crash fault fires mid-take
"""


def test_jax_postmortem_names_a_port_child_killed_mid_take(tmp_path):
    root, bb = str(tmp_path / "root"), str(tmp_path / "bb")
    env = dict(os.environ)  # default_knob_env left no TPUSNAP_ knob set
    env.update(
        {
            "TPUSNAP_FAULTS": "write:1:crash@cas/*",
            "TPUSNAP_SIDECAR": "0",
            "TPUSNAP_BLACKBOX": bb,
            "TPUSNAP_CAS": "1",
            "TPUSNAP_DISABLE_BATCHER": "1",
        }
    )
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD_TAKE, root], env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 1, proc.stderr[-2000:]
    report = postmortem.analyze_root(root, blackbox_dir=bb)
    assert report["classification"] == "killed_mid_take"
    fd = report["first_dead"]
    assert fd["verdict"] == "crash_fault" and fd["op"] == "take"
    (ring_path,) = jax_blackbox.read_all(bb).keys()
    ring_pid = int(os.path.basename(ring_path).rsplit("-", 1)[1][: -len(".ring")])
    assert fd["pid"] == ring_pid != os.getpid()
    assert fd["fault"]["op"] == "write" and fd["fault"]["path"].startswith("cas/")
    assert fd["phase_group"] in ("storage_io", "serialize"), fd
