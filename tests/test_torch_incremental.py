"""Incremental takes of the port (torchsnapshot_tpu_torch.incremental):
unchanged payloads are hard-linked from the base.  Mirrors of
tests/test_incremental.py:30-135 and :330; inputs from seeded numpy
generators."""

import os
import shutil

import numpy as np
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, knobs

from torch_env import default_knob_env  # noqa: F401  autouse fixture


def _inode(path):
    return os.stat(path).st_ino


def _t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr))


def _restored(path):
    dst = {"m": StateDict({})}
    Snapshot(path).restore(dst)
    return dst["m"]


def test_unchanged_payloads_hard_linked(tmp_path):
    frozen = np.random.RandomState(0).rand(256).astype(np.float32)
    hot = np.zeros(128, np.float32)
    with knobs.override_batching_disabled(True):
        Snapshot.take(str(tmp_path / "s1"), {"m": StateDict({"frozen": _t(frozen.copy()), "hot": _t(hot.copy())})})
        hot2 = hot + 1.0
        s2 = Snapshot.take(
            str(tmp_path / "s2"),
            {"m": StateDict({"frozen": _t(frozen.copy()), "hot": _t(hot2)})},
            incremental_from=str(tmp_path / "s1"),
        )
    frozen_loc = s2.get_manifest()["0/m/frozen"].location
    hot_loc = s2.get_manifest()["0/m/hot"].location
    assert _inode(tmp_path / "s2" / frozen_loc) == _inode(tmp_path / "s1" / frozen_loc)
    assert _inode(tmp_path / "s2" / hot_loc) != _inode(tmp_path / "s1" / hot_loc)
    got = _restored(str(tmp_path / "s2"))
    np.testing.assert_array_equal(got["frozen"].numpy(), frozen)
    np.testing.assert_array_equal(got["hot"].numpy(), hot2)


def test_unchanged_slabs_dedup_through_batching(tmp_path):
    rng = np.random.RandomState(1)
    frozen = {f"f{i:02d}": rng.rand(128).astype(np.float32) for i in range(8)}
    hot = {f"h{i:02d}": np.zeros(128, np.float32) for i in range(8)}
    with knobs.override_slab_size_threshold_bytes(2048):
        s1 = Snapshot.take(
            str(tmp_path / "s1"), {"m": StateDict({k: _t(v) for k, v in {**frozen, **hot}.items()})}
        )
        hot2 = {k: v + 1.0 for k, v in hot.items()}
        s2 = Snapshot.take(
            str(tmp_path / "s2"),
            {"m": StateDict({k: _t(v) for k, v in {**frozen, **hot2}.items()})},
            incremental_from=str(tmp_path / "s1"),
        )
    man1, man2 = s1.get_manifest(), s2.get_manifest()
    linked = rewritten = 0
    for name in frozen:
        loc1, loc2 = man1[f"0/m/{name}"].location, man2[f"0/m/{name}"].location
        assert loc1 == loc2 and loc1.startswith("batched/")
        if _inode(tmp_path / "s2" / loc2) == _inode(tmp_path / "s1" / loc1):
            linked += 1
    for name in hot:
        loc2 = man2[f"0/m/{name}"].location
        if _inode(tmp_path / "s2" / loc2) != _inode(tmp_path / "s1" / man1[f"0/m/{name}"].location):
            rewritten += 1
    assert linked == len(frozen)
    assert rewritten == len(hot)
    got = _restored(str(tmp_path / "s2"))
    for name, arr in {**frozen, **hot2}.items():
        np.testing.assert_array_equal(got[name].numpy(), arr)


def test_incremental_survives_base_pruning(tmp_path):
    value = np.random.RandomState(1).rand(512).astype(np.float32)
    with knobs.override_batching_disabled(True):
        Snapshot.take(str(tmp_path / "s1"), {"m": StateDict({"w": _t(value.copy())})})
        Snapshot.take(
            str(tmp_path / "s2"),
            {"m": StateDict({"w": _t(value.copy())})},
            incremental_from=str(tmp_path / "s1"),
        )
    shutil.rmtree(tmp_path / "s1")
    np.testing.assert_array_equal(_restored(str(tmp_path / "s2"))["w"].numpy(), value)


def test_incremental_missing_base_falls_back(tmp_path):
    value = torch.ones(64)
    snap = Snapshot.take(
        str(tmp_path / "snap"),
        {"m": StateDict({"w": value})},
        incremental_from=str(tmp_path / "nonexistent"),
    )
    assert torch.equal(_restored(snap.path)["w"], value)


def test_rewrite_over_link_does_not_corrupt_base(tmp_path):
    value = np.random.RandomState(4).rand(256).astype(np.float32)
    with knobs.override_batching_disabled(True):
        Snapshot.take(str(tmp_path / "s1"), {"m": StateDict({"w": _t(value.copy())})})
        Snapshot.take(
            str(tmp_path / "s2"),
            {"m": StateDict({"w": _t(value.copy())})},
            incremental_from=str(tmp_path / "s1"),
        )
        changed = value * -1.0
        Snapshot.take(str(tmp_path / "s2"), {"m": StateDict({"w": _t(changed)})})
    np.testing.assert_array_equal(_restored(str(tmp_path / "s1"))["w"].numpy(), value)
    np.testing.assert_array_equal(_restored(str(tmp_path / "s2"))["w"].numpy(), changed)


def test_slab_dedup_random_change_sets(tmp_path):
    rng = np.random.RandomState(7)
    base_arrays = {f"p{i:02d}": rng.rand(96).astype(np.float32) for i in range(24)}
    with knobs.override_slab_size_threshold_bytes(1024):
        Snapshot.take(str(tmp_path / "s1"), {"m": StateDict({k: _t(v) for k, v in base_arrays.items()})})
        for trial in range(3):
            changed = set(rng.choice(sorted(base_arrays), size=rng.randint(1, 8), replace=False))
            arrays2 = {k: (v + 1.0 if k in changed else v.copy()) for k, v in base_arrays.items()}
            dst_dir = tmp_path / f"s2_{trial}"
            s2 = Snapshot.take(
                str(dst_dir),
                {"m": StateDict({k: _t(v) for k, v in arrays2.items()})},
                incremental_from=str(tmp_path / "s1"),
            )
            man2 = s2.get_manifest()
            slab_dirty = {}
            for name in base_arrays:
                loc = man2[f"0/m/{name}"].location
                slab_dirty[loc] = slab_dirty.get(loc, False) or name in changed
            for loc, dirty in slab_dirty.items():
                same = _inode(dst_dir / loc) == _inode(tmp_path / "s1" / loc)
                assert same != dirty, (loc, dirty)
            got = _restored(str(dst_dir))
            for k, v in arrays2.items():
                np.testing.assert_array_equal(got[k].numpy(), v)
