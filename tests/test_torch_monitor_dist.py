"""The health monitor across two gloo ranks of the port on the CPU.

Mirrors tests/test_distributed.py:360: each rank's async-take sidecar
carries the commit barrier's arrival table (every rank's store-exchanged
arrive and depart stamps).  And the escalation path: a rank whose write is
held by a latency fault, with ``TPUSNAP_STALL_ESCALATE=1``, reports its
stall through the commit barrier's store, so its peer, already parked in
the barrier, raises ``StorePeerError`` naming the stall rather than
committing once the write lands.  Bodies run in forkserver children
(test_utils.run_with_procs) and touch no JAX."""

import contextlib
import glob
import json
import os

import pytest
import torch

from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.test_utils import make_test_pg, run_with_procs

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


def _run_dir(name: str) -> str:
    """A directory beside the run's FileStore (removed with the run)."""
    return os.path.join(os.path.dirname(knobs.get_store_path()), name)


@run_with_procs(nproc=2, gloo=True)
def _async_take_barrier_sidecar_body():
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    pg = make_test_pg()
    rank = pg.get_rank()
    path = _run_dir("barrier_blame")
    pending = Snapshot.async_take(path, {"m": StateDict({"w": torch.full((8,), float(rank))})}, pg=pg)
    pending.wait()
    pg.barrier()
    if rank == 0:
        docs = [json.load(open(p)) for p in glob.glob(os.path.join(path, "telemetry", "async_take-*.json"))]
        assert len(docs) == 2, docs
        tables = [d.get("barrier") for d in docs if d.get("barrier")]
        assert len(tables) == 2, docs
        for table in tables:
            assert table["world_size"] == 2
            assert set(table["arrivals"]) == {"0", "1"}
            assert all("arrive" in row for row in table["arrivals"].values())
        assert all(d["rss_high_water_bytes"] > 0 for d in docs)


def test_async_take_sidecar_carries_barrier_table():
    _async_take_barrier_sidecar_body()


@run_with_procs(nproc=2, gloo=True)
def barrier_snapshot_2():
    """Two ranks' async take into ``TPUSNAP_TEST_SNAPSHOT``: each rank's
    sidecar carries the commit barrier's arrival table (the input of
    ``analyze --barrier``; tests/test_torch_cli_telemetry_parity.py)."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    pg = make_test_pg()
    state = {"m": StateDict({"w": torch.full((8,), float(pg.get_rank()))})}
    Snapshot.async_take(os.environ["TPUSNAP_TEST_SNAPSHOT"], state, pg=pg).wait()


@run_with_procs(nproc=2, gloo=True)
def _stall_escalation_body():
    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.dist_store import StorePeerError

    pg = make_test_pg()
    rank = pg.get_rank()
    path = _run_dir("escalate")
    state = {"m": StateDict({"w": torch.full((8,), float(rank))})}
    with contextlib.ExitStack() as knobs_of_rank:
        if rank == 1:
            # Only rank 1 runs a watchdog: its one write is held for 5 s, far
            # past the 0.5 s stall timeout.  Its bundle goes to the trace dir.
            knobs_of_rank.enter_context(knobs.override_stall_timeout_s(0.5))
            knobs_of_rank.enter_context(knobs.override_faults("write:1:latency:5"))
            knobs_of_rank.enter_context(knobs.override_trace_dir(_run_dir("traces")))
        pending = Snapshot.async_take(path, state, pg=pg)
        with pytest.raises(StorePeerError, match=r"rank 1: async_take op \w+ stalled for .*\(watchdog escalation\)"):
            pending.wait()
    assert pending.progress()["done"] is True and pending.progress()["success"] is False
    if rank == 1:
        assert pending.progress()["stalls"] >= 1
        assert glob.glob(os.path.join(_run_dir("traces"), "stall-async_take-*-rank1-1.txt"))
    pg.barrier()
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))


def test_stalled_rank_escalates_to_its_peer(monkeypatch):
    """Without the escalation rank 0 would commit once rank 1's write
    lands; with it both ranks' ``wait`` raise the stalled rank's report."""
    monkeypatch.setenv(knobs.STALL_ESCALATE_ENV_VAR, "1")
    _stall_escalation_body()
