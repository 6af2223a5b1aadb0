"""Overlapping async journal saves that commit out of step order, in
torchsnapshot_tpu_torch's manager.

Async saves run on their own background threads, so a later step can
commit before an earlier one.  The manager's journal bookkeeping must still
end on the newest step: the deferred fold lands on the newest segment, and
``restore_latest`` returns it.  Each case forces one commit order by holding
a save's manifest transform (which runs on its background thread, before its
commit) on a ``threading.Event``."""

import threading

import pytest
import torch

from torchsnapshot_tpu_torch import StateDict, knobs
from torchsnapshot_tpu_torch.snapshot import Snapshot
from torchsnapshot_tpu_torch.manager import SnapshotManager

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures


def _state(v):
    return {"m": StateDict({"hot": torch.full((128,), float(v)), "step": v, "extra": torch.full((16,), 7.0)})}


def _zeros():
    return {"m": StateDict({"hot": torch.zeros(128), "step": 0, "extra": torch.zeros(16)})}


@pytest.fixture
def held_commits(monkeypatch):
    """``gates[step]``: an Event the async save of ``step`` waits on before
    its commit (steps without a gate commit freely)."""
    gates = {}
    real = Snapshot.async_take.__func__

    def async_take(cls, path, app_state, *args, manifest_transform=None, **kwargs):
        step = int(path.rstrip("/").rsplit("_", 1)[-1])
        gate = gates.get(step)
        if gate is not None and manifest_transform is not None:
            inner = manifest_transform

            def manifest_transform(metadata):
                assert gate.wait(30), f"step {step} was never released"
                return inner(metadata)

        return real(cls, path, app_state, *args, manifest_transform=manifest_transform, **kwargs)

    monkeypatch.setattr(Snapshot, "async_take", classmethod(async_take))
    return gates


@pytest.mark.parametrize(
    "held",
    [
        pytest.param((3,), id="middle_commits_last"),
        pytest.param((2, 3), id="newest_commits_first"),
    ],
)
def test_out_of_order_commits_fold_onto_the_newest_step(tmp_path, held, held_commits, no_leaked_threads):
    root = str(tmp_path / "ckpts")
    with knobs.override_sidecar(False), knobs.override_slab_size_threshold_bytes(64), knobs.override_journal_max_segments(2):
        mgr = SnapshotManager(root, journal=True)
        mgr.save(1, _state(1))
        for step in held:
            held_commits[step] = threading.Event()
        pendings = {step: mgr.save(step, _state(step), async_=True) for step in (2, 3, 4)}
        # Step 4 commits, and its done-callback runs, before any held step.
        pendings[4].wait()
        for step in held:
            held_commits[step].set()
            pendings[step].wait()
        for p in pendings.values():
            p.wait()
        assert mgr.restore_points() == [(1, "full"), (4, "full")]
        dst = _zeros()
        assert mgr.restore_latest(dst) == 4
        assert torch.equal(dst["m"]["hot"], torch.full((128,), 4.0))
        assert dst["m"]["step"] == 4
        assert mgr.orphan_segments() == []
        assert mgr.orphan_chunks() == []
