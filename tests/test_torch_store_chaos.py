"""Multi-tenant shared-store chaos in the port: concurrent tenants, faults,
kills.  Mirrors of tests/test_store_chaos.py.

Two SnapshotManagers in different roots drive one shared store through
take, prune and gc concurrently, under injected delete and ledger faults,
and a kill (the ``crash`` fault) mid-take, mid-sweep and mid-condemn in a
child process that runs the port and imports no JAX.  After every scenario:
the store-wide ``chunk_classification`` accounts for every present chunk,
no committed manifest of any root references a chunk missing from both
``cas/`` and the quarantine, and ``restore_latest`` lands a good snapshot
on every root.  The port's postmortem reads each killed child's
flight-recorder ring and the store: ``killed_mid_take``,
``killed_mid_sweep`` and ``killed_mid_condemn``, each with the remediation
it prescribes, and no prescription left once that remediation ran; the
soak's roots, where faults raise and nothing dies, are ``no_failure``."""

import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from torchsnapshot_tpu_torch import StateDict, knobs
from torchsnapshot_tpu_torch import cas as cas_mod
from torchsnapshot_tpu_torch import store as store_mod
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.manager import SnapshotManager
from torchsnapshot_tpu_torch.manifest import SnapshotMetadata
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
from torchsnapshot_tpu_torch.telemetry import blackbox, postmortem

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


def _state(v):
    return {"m": StateDict({"w": torch.full((512,), float(v)), "step": v})}


def _zeros():
    return {"m": StateDict({"w": torch.zeros(512), "step": 0})}


def _assert_store_invariants(store, roots):
    """The acceptance invariant, checked fault-free."""
    storage = url_to_storage_plugin(str(store))
    try:
        present = cas_mod.list_chunk_relpaths(storage)
        quarantined = store_mod.quarantined_chunk_relpaths(storage)
    finally:
        storage.sync_close()
    cls = store_mod.chunk_classification(str(store))
    assert sorted(cls["referenced"] + cls["orphan"]) == sorted(present)
    assert cls["condemned"] == sorted(quarantined)
    # No committed manifest references a chunk gone from BOTH cas/ and the
    # quarantine (the resolver serves quarantined ones).
    available = set(present) | set(quarantined)
    for root in roots:
        rp = url_to_storage_plugin(str(root))
        try:
            for marker in cas_mod.committed_marker_relpaths(rp):
                read_io = ReadIO(path=marker)
                rp.sync_read(read_io)
                metadata = SnapshotMetadata.from_json(bytes(read_io.buf).decode("utf-8"))
                missing = cas_mod.referenced_chunk_relpaths(metadata.manifest) - available
                assert not missing, f"{root}: manifest {marker} references missing chunks {sorted(missing)}"
        finally:
            rp.sync_close()


def _restore_ok(root, store):
    mgr = SnapshotManager(str(root), max_to_keep=10, store=str(store))
    points = mgr.restore_points()
    if not points:
        return None
    dst = _zeros()
    mgr.restore_latest(dst)
    v = float(dst["m"]["w"][0])
    assert v == float(dst["m"]["step"]) == float(points[-1][0])
    return v


def _final_sweep(store):
    with knobs.override_store_quarantine_s(0.0):
        try:
            store_mod.sweep(str(store), force=True)
        except store_mod.StoreSweepBusyError:
            pass


# ------------------------------------------------------- concurrent faults

# (spec, both tenants must commit): transient faults are retried through,
# terminal ones may abort single takes; the invariant holds either way.
_MENU = [
    ("", True),
    ("delete:1:transient@cas/*", True),
    ("write:2:transient@cas/*; read:3:transient", True),
    ("ledger:1:transient", True),  # the first hit is a swallowed control read
    # A fault on the journal APPEND aborts that take before its commit;
    # the debris must still classify and sweep.
    ("ledger:1:transient@ledger/*", False),
    ("ledger:1:terminal@ledger/*", False),
    ("delete:2:terminal@cas/*", True),  # deletes are gc's: takes commit
]


def _run_tenants(store, roots, spec, must_commit, rounds):
    """Each root's manager saves ``rounds(i)`` steps in its own thread, with
    a forced gc after each, under the fault spec; returns the errors."""
    errors = []

    def tenant(i, root):
        try:
            mgr = SnapshotManager(str(root), max_to_keep=2, store=str(store))
            for v in rounds(i):
                try:
                    mgr.save(v, _state(v))
                except Exception:
                    if must_commit:
                        raise
                try:
                    mgr.gc_detail(apply=True, force=True)
                except Exception:
                    pass
        except Exception as e:  # noqa: BLE001 — surfaced through errors
            errors.append(e)

    with knobs.override_retry_base_s(0.001), knobs.override_sidecar(False), knobs.override_lease_interval_s(
        0.05
    ), knobs.override_store_quarantine_s(0.0), knobs.override_faults(spec or None):
        threads = [threading.Thread(target=tenant, args=(i, root)) for i, root in enumerate(roots)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    return errors


@pytest.mark.parametrize("spec,must_commit", _MENU)
def test_two_tenants_concurrent_under_faults(tmp_path, spec, must_commit):
    store = tmp_path / "store"
    roots = [tmp_path / "ra", tmp_path / "rb"]
    errors = _run_tenants(store, roots, spec, must_commit, lambda i: (10 * i + 1, 10 * i + 2, 10 * i + 3))
    assert not errors, errors
    # Fault-free epilogue: a final sweep converges the store, then the
    # invariant and the restores hold on both roots.
    _final_sweep(store)
    _assert_store_invariants(store, roots)
    for i, root in enumerate(roots):
        v = _restore_ok(root, store)
        if must_commit:
            assert v == 10 * i + 3


# ------------------------------------------------------------ process kills

_CHILD_TAKE = """
import os, sys
import torch
from torchsnapshot_tpu_torch import StateDict
from torchsnapshot_tpu_torch.manager import SnapshotManager

assert "jax" not in sys.modules
root, store = sys.argv[1], sys.argv[2]
mgr = SnapshotManager(root, max_to_keep=10, store=store)
mgr.save(1, {"m": StateDict({"w": torch.full((512,), 1.0), "step": 1})})
os._exit(7)  # never reached: the crash fault fires mid-take
"""

_CHILD_SWEEP = """
import os, sys
from torchsnapshot_tpu_torch import store as store_mod

assert "jax" not in sys.modules
store_mod.sweep(sys.argv[1])
os._exit(7)  # never reached: the crash fault fires mid-sweep
"""


def _run_child(code, args, faults, blackbox_dir):
    """Run ``code`` in a port child under ``faults`` with its flight
    recorder in ``blackbox_dir``; returns the child's pid (its ring's)."""
    env = dict(os.environ)  # default_knob_env left no TPUSNAP_ knob set
    env.update(
        {
            "TPUSNAP_FAULTS": faults,
            "TPUSNAP_SIDECAR": "0",
            # Lease refreshers quiet, so the fault counters follow the op
            # sequence and not a timer.
            "TPUSNAP_LEASE_INTERVAL_S": "9999",
            "TPUSNAP_BLACKBOX": str(blackbox_dir),
        }
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, *[str(a) for a in args]], env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 1, f"child should die on the crash fault, got {proc.returncode}: {proc.stderr[-2000:]}"
    (ring_path,) = blackbox.read_all(str(blackbox_dir)).keys()
    return int(os.path.basename(ring_path).rsplit("-", 1)[1][: -len(".ring")])


def _postmortem(root, store, bb):
    return postmortem.analyze_root(str(root), store_url=str(store), blackbox_dir=str(bb))


def _sweep_actions(report):
    return [a for a in report["remediation"]["actions"] if a["action"] == "store_sweep"]


def test_kill_mid_take_debris_swept_by_survivor(tmp_path):
    """A kill (crash fault) during a take: the dead writer's lease goes
    stale, its debris chunks classify as orphans, and the SURVIVING
    tenant's sweep condemns and deletes them."""
    store = tmp_path / "store"
    ra, rb = tmp_path / "ra", tmp_path / "rb"
    bb = tmp_path / "bb"
    # Crash at the reference-journal append: every chunk is in the store,
    # neither the journal nor the commit marker landed.
    pid = _run_child(_CHILD_TAKE, [ra, store], "ledger:1:crash@ledger/*", bb)
    assert store_mod.chunk_classification(str(store))["orphan"]
    # The postmortem names the dead writer from its ring, mid-take at the
    # journal append, and prescribes a store sweep for its orphan chunks.
    report = _postmortem(ra, store, bb)
    assert report["classification"] == "killed_mid_take", report
    fd = report["first_dead"]
    assert fd["pid"] == pid != os.getpid(), fd
    assert fd["verdict"] == "crash_fault" and fd["op"] == "take", fd
    assert fd["fault"]["path"].startswith("ledger/"), fd
    assert report["store"]["chunks"]["orphan"] > 0, report["store"]
    (sweep,) = _sweep_actions(report)
    assert sweep["store"] == str(store) and "from torchsnapshot_tpu_torch import store" in sweep["command"], sweep
    mb = SnapshotManager(str(rb), max_to_keep=10, store=str(store))
    mb.save(2, _state(2))
    with knobs.override_lease_interval_s(0.05), knobs.override_lease_grace_s(0.3), knobs.override_store_quarantine_s(
        0.0
    ):
        time.sleep(0.6)  # the dead writer's lease and journal age out
        report = store_mod.sweep(str(store))
        assert not report["deferred_epochs"]
        _assert_store_invariants(store, [ra, rb])
    assert _restore_ok(rb, store) == 2.0
    # The crashed root has no committed step; its debris and stale
    # in-flight marker are gc-able without force (dead pid).
    ma = SnapshotManager(str(ra), max_to_keep=10, store=str(store))
    removed, _, _ = ma.gc_detail(apply=True)
    assert removed in ([], [1])
    assert ma.restore_points() == []
    cls = store_mod.chunk_classification(str(store))
    assert cls["orphan"] == [] and cls["condemned"] == []
    # Converged: the postmortem finds no debris left at the store or root.
    after = _postmortem(ra, store, bb)
    assert after["store"]["chunks"]["orphan"] == 0 and after["store"]["quarantined"] == [], after["store"]
    assert after["debris"]["orphan_steps"] == [], after["debris"]


def test_kill_mid_sweep_lease_adopted(tmp_path):
    """A kill during a sweep (crash fault on the epoch bump) leaves the
    sweep lease behind; a concurrent sweep refuses while it looks live and
    ADOPTS it once stale."""
    store = tmp_path / "store"
    ra = tmp_path / "ra"
    SnapshotManager(str(ra), max_to_keep=10, store=str(store)).save(1, _state(1))
    # Touches of sweep/epoch.json in a sweep: the report's read, the bump's
    # read, the bump's WRITE; crashing on the third dies right after the
    # lease is acquired, with the lease on storage.
    bb = tmp_path / "bb"
    _run_child(_CHILD_SWEEP, [store], "ledger:3:crash@sweep/epoch.json", bb)
    assert (store / store_mod.SWEEP_LEASE_FNAME).exists()
    # The postmortem places the kill inside the two-phase GC and prescribes
    # the adopting sweep the rest of this test performs.
    report = _postmortem(ra, store, bb)
    assert report["classification"] == "killed_mid_sweep", report
    assert report["first_dead"]["verdict"] == "crash_fault", report["first_dead"]
    assert report["store"]["sweep_lease"] is not None, report["store"]
    (sweep,) = _sweep_actions(report)
    assert sweep["force"] is True, report["remediation"]
    with pytest.raises(store_mod.StoreSweepBusyError):
        store_mod.sweep(str(store))
    with knobs.override_lease_interval_s(0.05), knobs.override_lease_grace_s(0.3), knobs.override_store_quarantine_s(
        0.0
    ):
        time.sleep(0.6)
        assert store_mod.sweep(str(store))["adopted_lease"]
    _assert_store_invariants(store, [ra])
    assert _restore_ok(ra, store) == 1.0
    assert not (store / store_mod.SWEEP_LEASE_FNAME).exists()
    # Adoption converged: no sweep lease, so no sweep prescribed.
    after = _postmortem(ra, store, bb)
    assert after["store"]["sweep_lease"] is None, after["store"]
    assert _sweep_actions(after) == [], after["remediation"]


def test_kill_mid_condemn_quarantine_converges(tmp_path):
    """A kill between the condemn stamp and the chunk moves: the stamped
    epoch's age is known, so a later sweep processes it and the
    classification still accounts for everything."""
    store = tmp_path / "store"
    ra = tmp_path / "ra"
    SnapshotManager(str(ra), max_to_keep=10, store=str(store)).save(1, _state(1))
    storage = url_to_storage_plugin(str(store))
    try:  # an orphan gives the condemn phase something to move
        storage.sync_write(WriteIO(path="cas/xxh64/de/deadbeef", buf=b"junk", durable=True))
    finally:
        storage.sync_close()
    # The first quarantine write is the .condemned stamp; crashing on the
    # SECOND dies between the stamp and the chunk move.
    bb = tmp_path / "bb"
    _run_child(_CHILD_SWEEP, [store], "ledger:2:crash@quarantine/*", bb)
    assert list((store / store_mod.QUARANTINE_DIR).glob(f"*/{store_mod.CONDEMNED_FNAME}"))
    # The postmortem tells this window from mid-sweep: the fault landed on a
    # quarantine/ path, between the condemn stamp and the chunk moves.
    report = _postmortem(ra, store, bb)
    assert report["classification"] == "killed_mid_condemn", report
    assert report["first_dead"]["fault"]["path"].startswith("quarantine/"), report["first_dead"]
    assert any(a["force"] for a in _sweep_actions(report)), report["remediation"]
    with knobs.override_lease_interval_s(0.05), knobs.override_lease_grace_s(0.3), knobs.override_store_quarantine_s(
        0.0
    ):
        time.sleep(0.6)
        report = store_mod.sweep(str(store))
        assert report["adopted_lease"] or report["epoch"] >= 1
        _assert_store_invariants(store, [ra])
    assert _restore_ok(ra, store) == 1.0
    storage = url_to_storage_plugin(str(store))
    try:  # converged: the quarantine drained and the lease is gone
        assert store_mod.quarantined_chunk_relpaths(storage) == []
        assert not storage.sync_exists(store_mod.SWEEP_LEASE_FNAME)
    finally:
        storage.sync_close()
    after = _postmortem(ra, store, bb)
    assert after["store"]["quarantined"] == [] and after["store"]["sweep_lease"] is None, after["store"]


# -------------------------------------------------------------------- soak


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_chaos_soak(tmp_path, seed):
    """Randomized soak: 2 tenants × {take, prune, gc} × random fault specs,
    several rounds, the invariant after each round."""
    import random

    rng = random.Random(seed)
    store = tmp_path / "store"
    roots = [tmp_path / "ra", tmp_path / "rb"]
    step = {0: 0, 1: 100}

    def rounds(i):
        for _ in range(rng.randint(1, 3)):
            step[i] += 1
            yield step[i]

    for _ in range(4):
        spec = rng.choice([s for s, _ in _MENU])
        errors = _run_tenants(store, roots, spec, False, rounds)
        assert not errors, errors
        _final_sweep(store)
        _assert_store_invariants(store, roots)
        for root in roots:
            _restore_ok(root, store)
        # Faults here raise, nothing dies: the postmortem invents no death.
        for root in roots:
            verdict = _postmortem(root, store, tmp_path / "bb")["classification"]
            assert verdict == "no_failure", (seed, spec, verdict)
