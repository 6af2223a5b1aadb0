"""Randomized nested-state round trips through the port, and across the
two packages (mirror of tests/test_fuzz_roundtrip.py's raw-format cases).
Tensors restore into an empty StateDict, so every value comes back fresh;
comparisons are exact (bytes)."""

import random
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu import Snapshot as JaxSnapshot
from torchsnapshot_tpu import StateDict as JaxStateDict
from torchsnapshot_tpu_torch.serialization import host_bytes, state_from_numpy

from torch_env import default_knob_env  # noqa: F401  autouse fixture


def _random_leaf(rng: random.Random):
    choice = rng.randrange(7)
    np_rng = np.random.RandomState(rng.randrange(1 << 31))
    if choice == 0:
        return rng.randrange(-(10**12), 10**12)
    if choice == 1:
        return rng.random() * 1e6 - 5e5
    if choice == 2:
        return "".join(chr(rng.randrange(32, 1000)) for _ in range(rng.randrange(20)))
    if choice == 3:
        return bool(rng.randrange(2))
    if choice == 4:
        dtype = rng.choice([np.float32, np.float64, np.int16, ml_dtypes.bfloat16, np.uint8])
        shape = tuple(rng.randrange(1, 5) for _ in range(rng.randrange(0, 3)))
        return np_rng.uniform(-10, 10, size=shape).astype(dtype)
    if choice == 5:
        return bytes(np_rng.bytes(rng.randrange(0, 30)))
    return None  # pickled object path


def _random_state(rng: random.Random, depth: int = 0):
    if depth >= 3 or rng.random() < 0.4:
        return _random_leaf(rng)
    kind = rng.randrange(3)
    if kind == 0:
        return {
            f"k{i}_{rng.randrange(100)}": _random_state(rng, depth + 1)
            for i in range(rng.randrange(1, 4))
        }
    if kind == 1:
        return [_random_state(rng, depth + 1) for _ in range(rng.randrange(1, 4))]
    return tuple(_random_state(rng, depth + 1) for _ in range(rng.randrange(1, 3)))


def _assert_same(expected, got):
    """``expected`` holds numpy arrays; ``got`` tensors or arrays."""
    if isinstance(expected, np.ndarray):
        assert list(np.shape(got)) == list(expected.shape)
        raw = host_bytes(got) if isinstance(got, torch.Tensor) else np.asarray(got).reshape(-1).view(np.uint8)
        assert raw.tobytes() == expected.reshape(-1).view(np.uint8).tobytes()
    elif isinstance(expected, dict):
        assert set(expected) == set(got)
        for k in expected:
            _assert_same(expected[k], got[k])
    elif isinstance(expected, (list, tuple)):
        assert type(expected) is type(got) and len(expected) == len(got)
        for a, b in zip(expected, got):
            _assert_same(a, b)
    else:
        assert expected == got


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_roundtrip(tmp_path, seed, toggle_batching):
    rng = random.Random(seed)
    state = {f"top{i}": _random_state(rng) for i in range(4)}
    snapshot = ts.Snapshot.take(str(tmp_path / "snap"), {"s": ts.StateDict(state_from_numpy(state))})
    dst = {"s": ts.StateDict({})}
    snapshot.restore(dst)
    _assert_same(state, dst["s"].state_dict())


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("taker", ["jax", "port"])
def test_fuzz_cross_package(tmp_path, seed, taker):
    rng = random.Random(100 + seed)
    state = {f"top{i}": _random_state(rng) for i in range(4)}
    path = str(tmp_path / "snap")
    if taker == "jax":
        JaxSnapshot.take(path, {"s": JaxStateDict(state)})
        dst = {"s": ts.StateDict({})}
        ts.Snapshot(path).restore(dst)
    else:
        ts.Snapshot.take(path, {"s": ts.StateDict(state_from_numpy(state))})
        dst = {"s": JaxStateDict({})}
        JaxSnapshot(path).restore(dst)
    _assert_same(state, dst["s"].state_dict())


def test_many_leaves_scale(tmp_path):
    # 3000 small leaves: flatten/manifest/batcher/scheduler breadth
    state = {f"w{i}": torch.full((4,), float(i)) for i in range(3000)}
    begin = time.monotonic()
    snapshot = ts.Snapshot.take(str(tmp_path / "snap"), {"m": ts.StateDict(state)})
    take_s = time.monotonic() - begin
    dst = {"m": ts.StateDict({})}
    begin = time.monotonic()
    snapshot.restore(dst)
    restore_s = time.monotonic() - begin
    assert len(dst["m"].state_dict()) == 3000
    assert torch.equal(dst["m"]["w2999"], torch.full((4,), 2999.0))
    # sanity bounds, generous for shared CI hardware
    assert take_s < 60 and restore_s < 60, (take_s, restore_s)
