"""Process-kill chaos on port ranks: a rank dying mid-take aborts its peer
fast and leaves a resumable, GC-able root that the port's postmortem reads.
Mirrors of tests/test_kill_chaos.py's ``test_sigkill_mid_take_fast`` and
its ``slow`` soak; that file's lease cases are mirrored in
tests/test_torch_dist_store.py.

The victim dies by the ``crash`` fault (``os._exit(1)`` at the faulted
call, after a ``fault`` record in its flight-recorder ring), unlike
tests/test_torch_distributed.py's SIGKILL, which writes no ring.  Then:

- **fast symmetric abort**: the survivor raises ``StorePeerError``
  ("presumed dead") within a quarter of the barrier timeout;
- **GC-able debris**: no commit marker, every CAS chunk classifiable;
- **the postmortem names the death**: ``killed_mid_take``, the victim's
  rank, verdict ``crash_fault``, op ``take``, the faulted chunk path, and
  the survivor's conviction of the same rank;
- **resumable retry**: the retried take adopts the dead attempt's durable
  chunks and writes under half the logical bytes;
- **convergence**: gc clears the debris, a second postmortem prescribes
  no gc, and ``restore_latest`` lands bit-exact.

Rank bodies run in forkserver children (test_utils.run_with_procs) and
touch no JAX; each reports its outcome in a JSON file."""

import json
import os
import random
import shutil
import time

import pytest
import torch

from torchsnapshot_tpu_torch import StateDict, knobs
from torchsnapshot_tpu_torch.test_utils import make_test_pg, run_with_procs

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

CHUNK_ELEMS = 16384  # 64 KiB of float32 per tensor
# Rank 0 owns more bytes, so a rank-1 kill can never force the retry to
# rewrite half the snapshot.
N_TENSORS = {0: 8, 1: 6}
BARRIER_TIMEOUT_S = 120.0
SOAK_BARRIER_TIMEOUT_S = 60.0
SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"


def _rank_state(rank: int, zero: bool = False):
    g = torch.Generator().manual_seed(1000 + rank)
    tensors = {f"r{rank}_w{i}": torch.rand(CHUNK_ELEMS, generator=g) for i in range(N_TENSORS[rank])}
    if zero:
        tensors = {k: torch.zeros_like(v) for k, v in tensors.items()}
    return {"m": StateDict(tensors)}


def _logical_bytes() -> int:
    return sum(n * CHUNK_ELEMS * 4 for n in N_TENSORS.values())


def _test_dir() -> str:
    return os.environ["TPUSNAP_TEST_DIR"]


def _plan() -> dict:
    with open(os.path.join(_test_dir(), "plan.json"), encoding="utf-8") as f:
        return json.load(f)


def _report(rank: int, outcome: dict) -> None:
    with open(os.path.join(_test_dir(), f"outcome_{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(outcome, f)


def _bits_equal(dst, src) -> bool:
    return all(torch.equal(dst["m"][k].view(torch.uint8), src["m"][k].view(torch.uint8)) for k in src["m"].keys())


@run_with_procs(nproc=2)
def _take_body():
    """One take of this rank's state into ``<root>/step_1``: the victim's
    under the plan's crash fault, the others metered (``none``); a rank
    that lives reports whether it committed, its wall, its written bytes
    and, with ``restore``, whether a restore came back bit-exact."""
    from torchsnapshot_tpu_torch import Snapshot, faults

    plan = _plan()
    pg = make_test_pg()
    rank = pg.get_rank()
    path = os.path.join(plan["root"], "step_1")
    app = _rank_state(rank)
    spec = plan["spec"] if rank == plan.get("victim") else "none"
    outcome = {"rank": rank}
    with knobs.override_faults(spec):
        faults.reset_write_counters()
        begin = time.monotonic()
        try:
            if plan.get("async_"):
                Snapshot.async_take(path, app, pg=pg).wait()
            else:
                Snapshot.take(path, app, pg=pg)
            outcome["committed"] = True
        except Exception as e:  # noqa: BLE001 — reported to the parent
            outcome.update(committed=False, error=type(e).__name__, error_str=str(e)[:200])
        outcome["wall_s"] = time.monotonic() - begin
        outcome["write_bytes"] = faults.total_write_bytes()
    if plan.get("restore") and outcome["committed"]:
        dst = _rank_state(rank, zero=True)
        Snapshot(path, pg=pg).restore(dst)
        outcome["restore_ok"] = _bits_equal(dst, _rank_state(rank))
    _report(rank, outcome)


def _run(tmp_path, monkeypatch, root, victim=None, spec="none", async_=False, restore=False, bb=None):
    """Run :func:`_take_body` on two ranks; returns their outcomes by rank
    (None for a rank that died) and the launcher's failure report."""
    monkeypatch.setenv("TPUSNAP_TEST_DIR", str(tmp_path))
    for rank in (0, 1):
        try:
            os.remove(tmp_path / f"outcome_{rank}.json")
        except FileNotFoundError:
            pass
    plan = {"root": root, "victim": victim, "spec": spec, "async_": async_, "restore": restore}
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    failure = ""
    with knobs.override_blackbox_dir(bb):
        try:
            _take_body()
        except AssertionError as e:
            failure = str(e)
    outcomes = {}
    for rank in (0, 1):
        p = tmp_path / f"outcome_{rank}.json"
        outcomes[rank] = json.loads(p.read_text()) if p.exists() else None
    return outcomes, failure


@pytest.fixture
def fast_knobs():
    with knobs.override_cas(True), knobs.override_sidecar(False), knobs.override_batching_disabled(
        True
    ), knobs.override_lease_interval_s(0.25), knobs.override_lease_grace_s(2.0), knobs.override_retry_base_s(0.001):
        yield


def _classify_debris(root):
    """(orphan steps, every classified chunk sorted, the chunks present
    sorted, the referenced chunks) of the root."""
    from torchsnapshot_tpu_torch import cas as cas_mod
    from torchsnapshot_tpu_torch.manager import SnapshotManager
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    mgr = SnapshotManager(root)
    referenced, orphan = mgr.chunk_classification()
    storage = url_to_storage_plugin(root)
    try:
        present = cas_mod.list_chunk_relpaths(storage)
    finally:
        storage.sync_close()
    return mgr.orphan_steps(), sorted(referenced + orphan), sorted(present), referenced


def _restore_latest_ok(root) -> None:
    from torchsnapshot_tpu_torch.manager import SnapshotManager

    dst = _rank_state(0, zero=True)
    assert SnapshotManager(root).restore_latest(dst) == 1
    assert _bits_equal(dst, _rank_state(0))


def test_sigkill_mid_take_fast(tmp_path, monkeypatch, fast_knobs):
    """Rank 1 dies at its 5th chunk write of a 2-rank CAS take."""
    from torchsnapshot_tpu_torch.manager import SnapshotManager
    from torchsnapshot_tpu_torch.telemetry import postmortem

    root = str(tmp_path / "ckpts")
    os.makedirs(root)
    bb = str(tmp_path / "blackbox")

    # --- attempt 1: rank 1 is killed at its 5th chunk write -------------
    with knobs.override_barrier_timeout_s(BARRIER_TIMEOUT_S):
        outcomes, failure = _run(tmp_path, monkeypatch, root, victim=1, spec="write:5:crash", bb=bb)
    assert outcomes[1] is None and "rank 1:\nexit code 1" in failure and "rank 0" not in failure, failure
    survivor = outcomes[0]
    assert survivor["committed"] is False, survivor
    assert survivor["error"] == "StorePeerError" and "presumed dead" in survivor["error_str"], survivor
    # Fast abort, not a barrier-timeout ride-out.
    assert survivor["wall_s"] < BARRIER_TIMEOUT_S / 4, survivor

    # --- debris: no commit marker; every CAS chunk classifiable ---------
    assert not os.path.exists(os.path.join(root, "step_1", SNAPSHOT_METADATA_FNAME))
    orphan_steps, classified, present, referenced = _classify_debris(root)
    assert orphan_steps in ([], [1])
    assert referenced == []
    assert classified == present and present, "the dead attempt should have left durable chunks"

    # --- the postmortem names the death ---------------------------------
    report = postmortem.analyze_root(root, blackbox_dir=bb)
    assert report["classification"] == "killed_mid_take", report
    fd = report["first_dead"]
    assert fd["rank"] == 1 and fd["verdict"] == "crash_fault" and fd["op"] == "take", fd
    assert fd["fault"]["op"] == "write" and fd["fault"]["path"].startswith("cas/"), fd
    assert fd["phase_group"] in ("storage_io", "serialize"), fd
    # The survivor's own conviction names the rank the postmortem found dead.
    peer = report["implicated"]["peer"]
    assert peer is not None and peer["rank"] == 1 and peer["convicted_by_rank"] == 0, report["implicated"]
    assert any(a["action"] == "gc" for a in report["remediation"]["actions"]), report["remediation"]

    # --- retry: adopt the durable chunks, write only the missing bytes ---
    with knobs.override_barrier_timeout_s(BARRIER_TIMEOUT_S):
        outcomes, failure = _run(tmp_path, monkeypatch, root, restore=True)
    assert not failure, failure
    for outcome in outcomes.values():
        assert outcome["committed"] is True and outcome["restore_ok"] is True, outcome
    retry_written = sum(o["write_bytes"] for o in outcomes.values())
    assert retry_written < 0.5 * _logical_bytes(), (
        f"retry rewrote {retry_written}/{_logical_bytes()} bytes: the dead attempt's chunks were not adopted"
    )

    # --- aftermath: gc clears the debris, restore_latest lands good ------
    mgr = SnapshotManager(root)
    assert mgr.all_steps() == [1]
    mgr.gc(apply=True, force=True)
    assert mgr.orphan_steps() == [] and mgr.orphan_chunks() == []
    after = postmortem.analyze_root(root, blackbox_dir=bb)
    assert after["debris"]["orphan_steps"] == [] and after["debris"]["orphan_chunks"] == [], after["debris"]
    assert not any(a["action"] == "gc" for a in after["remediation"]["actions"]), after["remediation"]
    _restore_latest_ok(root)


# -------------------------------------------------------------------- soak


def _kill_menu(seed: int):
    """Kill points across the take's life: (victim, spec, async_).  Chunk
    stream kills (first and a middle write), the commit (rank 0's metadata
    write, its peer parked in the post-commit barrier), the async commit
    barrier (rank 1's manifest sidecar), and a random rank-0 write."""
    rng = random.Random(seed)
    menu = [
        (1, "write:1:crash", False),
        (1, f"write:{rng.randrange(2, 6)}:crash", False),
        (0, f"write:1:crash@{SNAPSHOT_METADATA_FNAME}", False),
        (1, "write:1:crash@.manifest_rank*", True),
        (0, f"write:{rng.randrange(2, 8)}:crash", rng.random() < 0.5),
    ]
    rng.shuffle(menu)
    return menu


@pytest.mark.slow
def test_sigkill_chaos_soak(tmp_path, monkeypatch, fast_knobs):
    """Three seeds x the kill menu.  After each kill: the survivor aborts
    fast, no marker, every chunk classifiable, the postmortem names the
    victim; the clean retry commits and restore_latest lands bit-exact."""
    from torchsnapshot_tpu_torch.manager import SnapshotManager
    from torchsnapshot_tpu_torch.telemetry import postmortem

    with knobs.override_barrier_timeout_s(SOAK_BARRIER_TIMEOUT_S), knobs.override_lease_grace_s(1.5):
        for seed in range(3):
            root = str(tmp_path / f"ckpts_{seed}")
            os.makedirs(root)
            mgr = SnapshotManager(root)
            for scenario, (victim, spec, async_) in enumerate(_kill_menu(seed)):
                where = (seed, spec)
                # A fresh ring directory per kill: the postmortem judges this
                # kill, not an earlier scenario's rings.
                bb = str(tmp_path / f"bb_{seed}_{scenario}")
                outcomes, failure = _run(tmp_path, monkeypatch, root, victim=victim, spec=spec, async_=async_, bb=bb)
                survivor = outcomes[1 - victim]
                assert outcomes[victim] is None and f"rank {victim}:\nexit code 1" in failure, (where, failure)
                assert survivor["committed"] is False and survivor["error"] == "StorePeerError", (where, survivor)
                assert survivor["wall_s"] < SOAK_BARRIER_TIMEOUT_S / 2, (where, survivor)
                assert not os.path.exists(os.path.join(root, "step_1", SNAPSHOT_METADATA_FNAME)), where
                orphan_steps, classified, present, _ = _classify_debris(root)
                assert orphan_steps in ([], [1]) and classified == present, where
                report = postmortem.analyze_root(root, blackbox_dir=bb)
                assert report["classification"] == "killed_mid_take", (where, report["classification"])
                fd = report["first_dead"]
                assert fd["rank"] == victim and fd["verdict"] == "crash_fault", (where, fd)
                assert fd["op"] in ("take", "async_take"), (where, fd)

                outcomes, failure = _run(tmp_path, monkeypatch, root, restore=True)
                assert not failure, (where, failure)
                for outcome in outcomes.values():
                    assert outcome["committed"] is True and outcome["restore_ok"] is True, (where, outcome)
                mgr.gc(apply=True, force=True)
                assert mgr.orphan_chunks() == [], where
                _restore_latest_ok(root)
                # Reset for the next scenario: drop the step and its chunks,
                # so each kill starts from an empty root.
                shutil.rmtree(root)
                os.makedirs(root)
