"""Helpers of the port's peer-tier test files (test_torch_peer*.py).

``peer_env`` (after ``default_knob_env``, which would unset its knobs): a
FileStore registry under the test's directory (``TPUSNAP_STORE_PATH``),
origin metered by the fault wrapper (``TPUSNAP_FAULTS=none``), the port's
peer totals and scoreboard reset; at teardown it waits, at most 5 s, for
the threads the test started to end (a daemon's handler threads end once
their client closes the connection) before ``no_leaked_threads`` looks.  ``daemon(cache_dir)`` runs a port
``PeerDaemon`` advertising 127.0.0.1 and closes it on exit.  States are
uint8 tensors of seeded random bytes."""

import contextlib
import threading

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu_torch import cache as cache_mod
from torchsnapshot_tpu_torch import faults, knobs
from torchsnapshot_tpu_torch import peer as peer_mod
from torchsnapshot_tpu_torch import peerd as peerd_mod

from torch_env import default_knob_env, no_leaked_threads, wait_for_threads  # noqa: F401  fixtures


def arrays(nbytes_per_leaf=1 << 20, leaves=4, seed=0):
    return {
        f"w{i}": np.frombuffer(np.random.RandomState(seed * 100 + i).bytes(nbytes_per_leaf), np.uint8).copy()
        for i in range(leaves)
    }


def state(arrs):
    return {"m": ts.StateDict({k: torch.from_numpy(v.copy()) for k, v in arrs.items()})}


def zeros(arrs):
    return {"m": ts.StateDict({k: torch.zeros(v.shape, dtype=torch.uint8) for k, v in arrs.items()})}


def assert_equal(dst, arrs):
    for k, v in arrs.items():
        got = dst["m"][k]
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        assert got.tobytes() == v.tobytes(), k


def payload_read_bytes(faults_mod=faults) -> int:
    """Origin bytes read for payloads (metadata and sidecars left out)."""
    return sum(
        nbytes
        for path, nbytes in faults_mod.read_counters().items()
        if not path.rsplit("/", 1)[-1].startswith(".") and not path.startswith("telemetry/")
    )


def warm_into(snap_path, metadata, cache_dir, peerd=peerd_mod, cache=cache_mod):
    """Warm a snapshot into ``cache_dir`` through the package's read stack."""
    with knobs.override_cache_dir(cache_dir):
        storage = peerd._rollout_storage(snap_path, metadata)
        try:
            return cache.warm_snapshot(storage, metadata)
        finally:
            storage.sync_close()


@contextlib.contextmanager
def daemon(cache_dir, root=None, register=True, peerd=peerd_mod):
    d = peerd.PeerDaemon(root=root, cache_dir=cache_dir, advertise="127.0.0.1", register=register)
    d.start()
    try:
        yield d
    finally:
        d.close()


@pytest.fixture
def peer_env(tmp_path, default_knob_env, no_leaked_threads):  # noqa: F811
    before = set(threading.enumerate())
    with knobs.override_store_path(str(tmp_path / "kv")), knobs.override_faults("none"):
        faults.reset_read_counters()
        peer_mod.reset_process_stats()
        yield tmp_path
    peer_mod.reset_process_stats()
    wait_for_threads(before)
