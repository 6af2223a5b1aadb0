"""The postmortem across the two packages: each package's ``analyze_root``
reads a root killed by either package's child into the same report.

- A root killed mid-take by a JAX child (``torchsnapshot_tpu``,
  ``write:1:crash@cas/*``, CAS on) is read by the port: ``killed_mid_take``,
  ``crash_fault``, the child's pid, the faulted chunk path.
- A root killed mid-take by a port child, and a store whose port sweeper
  died mid-sweep, are read by both packages.

The two reports of one root are compared key by key, and only these may
differ: ``generated_at`` and the ages measured at read time (``age_s``,
``_age_s``); the package named in a ``command``; and a phase only the port
records, which has its group in the port's report and ``other`` in the JAX
package's (the port's report, regrouped by the JAX package's
``classify_phase``, must equal the JAX package's).
tests/test_torch_monitor_parity.py holds the JAX postmortem over a port
child's ring; this file holds both directions over whole reports, and the
port's ``store._resolve_store_url`` against the JAX package's helper of
that name."""

import os
import subprocess
import sys

import pytest

from torchsnapshot_tpu.telemetry import analyze as jax_analyze
from torchsnapshot_tpu.telemetry import postmortem as jax_postmortem
from torchsnapshot_tpu_torch import store as port_store
from torchsnapshot_tpu_torch.telemetry import analyze as port_analyze
from torchsnapshot_tpu_torch.telemetry import blackbox
from torchsnapshot_tpu_torch.telemetry import postmortem as port_postmortem

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

_PORT_TAKE = """
import os, sys
import torch
from torchsnapshot_tpu_torch import SnapshotManager, StateDict

assert "jax" not in sys.modules
SnapshotManager(sys.argv[1]).save(0, {"m": StateDict({"w": torch.arange(1 << 18, dtype=torch.float32)})})
os._exit(7)  # never reached: the crash fault fires mid-take
"""

_JAX_TAKE = """
import os, sys
import numpy as np
from torchsnapshot_tpu import StateDict
from torchsnapshot_tpu.manager import SnapshotManager

SnapshotManager(sys.argv[1]).save(0, {"m": StateDict({"w": np.arange(1 << 18, dtype=np.float32)})})
os._exit(7)  # never reached: the crash fault fires mid-take
"""

_PORT_SWEEP = """
import os, sys
from torchsnapshot_tpu_torch import store as store_mod

assert "jax" not in sys.modules
store_mod.sweep(sys.argv[1])
os._exit(7)  # never reached: the crash fault fires mid-sweep
"""


def _kill(code, args, bb, faults, extra=None):
    """Run ``code`` in a child under ``faults`` with its ring in ``bb``; the
    child must die on the crash fault.  Returns its pid."""
    env = dict(os.environ)  # default_knob_env left no TPUSNAP_ knob set
    env.update(
        {
            "JAX_PLATFORMS": "cpu",
            "TPUSNAP_FAULTS": faults,
            "TPUSNAP_SIDECAR": "0",
            "TPUSNAP_BLACKBOX": str(bb),
            "TPUSNAP_DISABLE_BATCHER": "1",
        }
    )
    env.update(extra or {})
    proc = subprocess.run(
        [sys.executable, "-c", code, *[str(a) for a in args]], env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 1, f"child should die on the crash fault, got {proc.returncode}: {proc.stderr[-2000:]}"
    (ring_path,) = blackbox.read_all(str(bb)).keys()
    return int(os.path.basename(ring_path).rsplit("-", 1)[1][: -len(".ring")])


_AGES = ("age_s", "_age_s")


def _normalized(value, key=None):
    """The report with read-time ages and ``generated_at`` blanked and the
    port's package name in commands written as the JAX package's."""
    if isinstance(value, dict):
        return {k: _normalized(v, k) for k, v in value.items() if k != "generated_at"}
    if isinstance(value, list):
        return [_normalized(v) for v in value]
    if key in _AGES:
        return None
    if key == "command" and isinstance(value, str):
        return value.replace("torchsnapshot_tpu_torch", "torchsnapshot_tpu")
    return value


def _regrouped(report):
    """The port's report with every phase grouped the JAX package's way,
    after checking that each group it holds is the port's own."""
    for story in report["processes"] + ([report["first_dead"]] if report["first_dead"] else []):
        if story["phase"] is not None:
            assert story["phase_group"] == port_analyze.classify_phase(story["phase"])
            story["phase_group"] = jax_analyze.classify_phase(story["phase"])
    return report


def _both(root, bb, store_url=None):
    port = port_postmortem.analyze_root(str(root), store_url=store_url, blackbox_dir=str(bb))
    jax = jax_postmortem.analyze_root(str(root), store_url=store_url, blackbox_dir=str(bb))
    assert _normalized(_regrouped(port)) == _normalized(jax)
    return port, jax


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_both_packages_read_a_child_killed_mid_take(tmp_path, writer):
    root, bb = tmp_path / "root", tmp_path / "bb"
    code = {"jax": _JAX_TAKE, "port": _PORT_TAKE}[writer]
    pid = _kill(code, [root], bb, "write:1:crash@cas/*", {"TPUSNAP_CAS": "1"})
    port, jax = _both(root, bb)
    fd = port["first_dead"]
    assert port["classification"] == "killed_mid_take"
    assert (fd["verdict"], fd["op"], fd["pid"]) == ("crash_fault", "take", pid)
    assert fd["fault"]["op"] == "write" and fd["fault"]["path"].startswith("cas/")
    (gc,) = [a for a in port["remediation"]["actions"] if a["action"] == "gc"]
    assert gc["force"] and gc["command"].startswith("python -m torchsnapshot_tpu_torch gc ")
    (jax_gc,) = [a for a in jax["remediation"]["actions"] if a["action"] == "gc"]
    assert jax_gc["command"].startswith("python -m torchsnapshot_tpu gc ")


def test_both_packages_read_a_port_sweeper_killed_mid_sweep(tmp_path):
    """The store plane across the packages: a port tenant's committed step,
    an orphan chunk and a port sweeper killed right after taking its lease."""
    from torchsnapshot_tpu_torch import StateDict
    from torchsnapshot_tpu_torch.io_types import WriteIO
    from torchsnapshot_tpu_torch.manager import SnapshotManager
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    import torch

    store, root, bb = tmp_path / "store", tmp_path / "ra", tmp_path / "bb"
    SnapshotManager(str(root), max_to_keep=10, store=str(store)).save(1, {"m": StateDict({"w": torch.ones(512)})})
    storage = url_to_storage_plugin(str(store))
    try:
        storage.sync_write(WriteIO(path="cas/xxh64/de/deadbeef", buf=b"junk", durable=True))
    finally:
        storage.sync_close()
    _kill(_PORT_SWEEP, [store], bb, "ledger:3:crash@sweep/epoch.json", {"TPUSNAP_LEASE_INTERVAL_S": "9999"})
    # The root's .store pointer names the store: both resolve it themselves.
    assert port_store._resolve_store_url(str(root)) == str(store)
    port, jax = _both(root, bb)
    assert port["classification"] == "killed_mid_sweep"
    assert port["store"]["url"] == str(store) and port["store"]["sweep_lease"] is not None
    assert port["store"]["chunks"]["orphan"] == 1
    assert port["remediation"]["restore"]["committed_points"] == 1
    (sweep,) = [a for a in port["remediation"]["actions"] if a["action"] == "store_sweep"]
    assert sweep["force"] and "from torchsnapshot_tpu_torch import store" in sweep["command"]


def test_store_url_resolution_matches_the_jax_helper(tmp_path):
    """The port's ``store._resolve_store_url`` against the JAX package's
    ``__main__._resolve_store_url``: a root's pointer, a snapshot path under
    it (the parent's pointer), the ``TPUSNAP_STORE`` knob first, and no
    store at all."""
    from torchsnapshot_tpu.__main__ import _resolve_store_url as jax_resolve
    from torchsnapshot_tpu_torch import knobs
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    root, store = tmp_path / "root", tmp_path / "store"
    (root / "step_3").mkdir(parents=True)
    storage = url_to_storage_plugin(str(root))
    try:
        port_store.write_store_pointer(storage, str(store))
    finally:
        storage.sync_close()
    cases = {
        str(root): str(store),
        str(root / "step_3"): str(store),
        str(root / "step_3") + "/": str(store),
        str(tmp_path / "elsewhere"): None,
    }
    for path, expected in cases.items():
        assert port_store._resolve_store_url(path) == jax_resolve(path) == expected, path
    with knobs.override_store(str(tmp_path / "knob")):
        assert port_store._resolve_store_url(str(root)) == jax_resolve(str(root)) == str(tmp_path / "knob")
