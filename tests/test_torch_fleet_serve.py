"""Fleet telemetry on the port's serving paths, mirroring
tests/test_peer_trace.py's daemon fleet presence and rollout cases and the
multi-process, barrier and cache-wait cases of tests/test_fleet.py:

- a port daemon that outlives the stale bound is not suspected-dead: its
  ``serve`` op keeps its entry fresh (read until a fresh entry from past
  twice the bound arrives, so a loaded host delays the test but cannot
  fail it), and its close leaves a terminal entry;
- a rollout's wave document reaches the aggregated view and the ``top``
  banner, and the terminal fold clears it; a real two-daemon rollout emits
  its wave events and leaves a terminal entry with the final wave, its
  hosts and its delta bytes split between peers and origin;
- two spawned port workers restoring through one cache publish into one
  spool, and the aggregated cache totals equal the workers' own;
- ``LinearBarrier`` exchanges arrival stamps and meters ``barrier_wait``;
  a reader parked on a held populate lock meters ``cache_wait``.

The one duration checked in each case is an injected delay's lower bound,
and each delay starts once the waiter is known to wait."""

import hashlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu_torch import cache as cache_mod
from torchsnapshot_tpu_torch import event_handlers, knobs, phase_stats
from torchsnapshot_tpu_torch import peerd as peerd_mod
from torchsnapshot_tpu_torch.dist_store import FileStore, LinearBarrier
from torchsnapshot_tpu_torch.telemetry import fleet, metrics
from torchsnapshot_tpu_torch.telemetry import monitor as tmonitor

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures
from torch_peer_env import arrays, daemon, peer_env, state  # noqa: F401

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WAIT_S = 60.0


@pytest.fixture(autouse=True)
def clean_telemetry():
    metrics.uninstall_event_bridge()
    metrics.reset()
    fleet.reset_process_totals()
    saved = list(event_handlers._INPROCESS_HANDLERS)
    yield
    event_handlers._INPROCESS_HANDLERS[:] = saved
    metrics.uninstall_event_bridge()
    metrics.reset()
    fleet.reset_process_totals()
    assert tmonitor._ACTIVE == [], "leaked op monitors"


def _wait_until(cond, what):
    deadline = time.monotonic() + _WAIT_S
    while True:
        got = cond()
        if got:
            return got
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


# ------------------------------------------------ daemon fleet presence


def test_daemon_outliving_stale_window_not_suspected_dead(peer_env):
    """A daemon older than the stale bound reads live: its serve entry is
    refreshed past twice the bound and collected fresh; its close folds
    the entry terminal."""
    spool = str(peer_env / "spool")
    with knobs.override_fleet_telemetry(spool), knobs.override_fleet_telemetry_interval_s(
        0.15
    ), knobs.override_fleet_telemetry_stale_s(1.0):
        stale_s = knobs.get_fleet_telemetry_stale_s()
        with daemon(str(peer_env / "cacheA")):
            born = time.time()

            def fresh_reading():
                entries = fleet.collect(spool)
                serve = [d for d in entries if d.get("kind") == "serve"]
                if serve and all(not d.get("_stale") and d["publish_time"] >= born + 2 * stale_s for d in serve):
                    return entries
                return None

            entries = _wait_until(fresh_reading, "a fresh serve entry from past twice the stale bound")
            rows = [w for w in fleet.aggregate(entries)["workers"] if w["kind"] == "serve"]
            assert len(rows) == 1 and rows[0]["state"] != "suspected-dead" and not rows[0]["done"]
        entries = fleet.collect(spool, stale_s=1e9)
    serve = [d for d in entries if d.get("kind") == "serve"]
    assert len(serve) == 1 and serve[0]["op"]["done"] is True and serve[0]["op"]["success"] is True


def test_rollout_progress_surfaces_in_top(tmp_path):
    """An in-flight rollout's wave document reaches the aggregated view and
    renders as the banner; the terminal fold clears it."""
    spool = str(tmp_path / "spool")
    with knobs.override_fleet_telemetry(spool):
        mon = tmonitor.op_started("rollout", "r" * 32, 0, watchdog=False)
        try:
            mon.fleet_extra = {
                "rollout": {
                    "root": "mem://ckpts",
                    "step": 7,
                    "wave": "fleet",
                    "completed": 2,
                    "total": 4,
                    "peer_bytes": 1 << 20,
                    "origin_bytes": 1024,
                    "eta_s": 3.5,
                }
            }
            fleet.publish(mon)
            view = fleet.aggregate(fleet.collect(spool, stale_s=1e9))
            assert view["rollout"] is not None
            assert view["rollout"]["wave"] == "fleet" and view["rollout"]["completed"] == 2
            assert view["rollout"]["worker"].endswith(f":{os.getpid()}")
            out = fleet.render(view, spool)
            assert "ROLLOUT in flight" in out and "wave fleet" in out and "2/4 hosts" in out
        finally:
            tmonitor.op_finished(mon, success=True)
        view = fleet.aggregate(fleet.collect(spool, stale_s=1e9))
        assert view["rollout"] is None


def test_rollout_fleet_emits_wave_events_and_progress(peer_env):
    """A two-daemon rollout emits rollout.wave for each wave and leaves a
    terminal rollout entry with the final wave document: every fleet host
    completed, the delta's bytes from peers and from origin as the hosts'
    warm splits report them."""
    root = str(peer_env / "ckpts")
    with knobs.override_cas(True):
        mgr = ts.SnapshotManager(root)
        arrs = arrays(leaves=2)
        mgr.save(1, state(arrs))
        arrs["w0"] = np.frombuffer(np.random.RandomState(777).bytes(1 << 20), np.uint8).copy()
        mgr.save(2, state(arrs))
    spool = str(peer_env / "spool")
    events = []
    event_handlers.register_event_handler(events.append)
    with knobs.override_peer_fetch(True), knobs.override_fleet_telemetry(spool):
        with daemon(str(peer_env / "cacheA"), root=root), daemon(str(peer_env / "cacheB"), root=root):
            out = peerd_mod.rollout_fleet(root, None, canary=1)
    assert out["ok"], out
    assert [e.metadata["wave"] for e in events if e.name == "rollout.wave"] == ["canary", "verify", "fleet"]
    entries = fleet.collect(spool, stale_s=1e9)
    rollouts = [d for d in entries if d.get("kind") == "rollout" and (d.get("extra") or {}).get("rollout")]
    assert len(rollouts) == 1 and rollouts[0]["op"]["done"] is True and rollouts[0]["op"]["success"] is True
    doc = rollouts[0]["extra"]["rollout"]
    assert doc["wave"] == "fleet" and doc["step"] == out["step"] == 2 and doc["root"] == root
    assert doc["completed"] == doc["total"] == 1 and doc["eta_s"] == 0.0
    warms = [r["warm"] for r in out["canary_results"] + out["fleet_results"]]
    assert doc["peer_bytes"] == sum(w["peer"]["hit_bytes"] for w in warms) == out["fleet_results"][0]["warm"][
        "delta_bytes"
    ] > 0
    assert doc["origin_bytes"] == sum(w["peer"]["miss_bytes"] for w in warms)
    assert fleet.aggregate(entries)["rollout"] is None  # terminal: no banner


# ------------------------------------------- multi-process fleet aggregation

# One serving worker: restores the snapshot through the port (the cache and
# the spool come from its environment) into zeroed tensors and prints their
# sha1 digests and this process's cache totals.
_WORKER = """
import hashlib, json, sys
import torch
import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu_torch import cache

assert "jax" not in sys.modules
sizes = json.loads(sys.argv[2])
dst = {"m": ts.StateDict({k: torch.zeros(n, dtype=torch.uint8) for k, n in sizes.items()})}
ts.Snapshot(sys.argv[1]).restore(dst)
digests = {k: hashlib.sha1(v.numpy().tobytes()).hexdigest() for k, v in dst["m"].items()}
assert "jax" not in sys.modules
print(json.dumps({"digests": digests, **cache.process_stats()}))
"""


def test_multiprocess_fleet_aggregation(tmp_path):
    """Two port workers restore one snapshot through one cache and publish
    into one spool: the view holds both processes, done, and its cache
    totals are the sums of the workers' own; origin is about one snapshot;
    an aggressive stale bound then empties the view."""
    n = 2
    arrs = arrays(nbytes_per_leaf=1 << 19, leaves=4, seed=3)
    snap_path = str(tmp_path / "root" / "step_1")
    ts.Snapshot.take(snap_path, state(arrs))
    spool = os.path.join(snap_path, fleet.SPOOL_DIRNAME)
    env = dict(os.environ)  # default_knob_env left no TPUSNAP_ knob set
    env[knobs.CACHE_DIR_ENV_VAR] = str(tmp_path / "cache")
    env[knobs.FLEET_TELEMETRY_ENV_VAR] = spool
    env[knobs.FLEET_TELEMETRY_INTERVAL_S_ENV_VAR] = "0.1"
    sizes = json.dumps({k: v.nbytes for k, v in arrs.items()})
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, snap_path, sizes],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
            cwd=REPO_ROOT,
        )
        for _ in range(n)
    ]
    docs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-2000:]
        docs.append(json.loads(out.strip().splitlines()[-1]))
    want = {k: hashlib.sha1(v.tobytes()).hexdigest() for k, v in arrs.items()}
    assert all(d["digests"] == want for d in docs)

    assert fleet.resolve_spool(snap_path) == spool
    view = fleet.aggregate(fleet.collect(spool, stale_s=600, sweep=False))
    assert view["n_processes"] == n, view
    assert {w["worker"].split(":")[1] for w in view["workers"]} == {str(p.pid) for p in procs}
    assert all(w["kind"] == "restore" and w["done"] and w["state"] == "done" for w in view["workers"])
    assert view["cache"]["hit_bytes"] == sum(d["hit_bytes"] for d in docs)
    assert view["cache"]["miss_bytes"] == sum(d["miss_bytes"] for d in docs)
    logical = sum(v.nbytes for v in arrs.values())
    assert view["cache"]["origin_bytes"] <= 1.25 * logical
    assert view["cache"]["hit_bytes"] + view["cache"]["miss_bytes"] == n * logical
    assert view["proc_totals"]["ops_done"] == n
    time.sleep(0.05)
    assert fleet.aggregate(fleet.collect(spool, stale_s=0.001))["n_entries"] == 0


# ----------------------------------------------- barrier stamps and phase


def test_linear_barrier_records_arrival_table_and_wait_phase(tmp_path):
    """Two ranks over one FileStore: rank 1 arrives 0.5 s after rank 0's
    stamp, which the exchanged arrival table shows, and the leader's wait
    is metered as barrier_wait."""
    store = FileStore(str(tmp_path))
    b0 = LinearBarrier(prefix="t", store=store, rank=0, world_size=2)
    b1 = LinearBarrier(prefix="t", store=store, rank=1, world_size=2)
    before = phase_stats.snapshot()
    errors = []

    def rank1():
        try:
            _wait_until(lambda: b1._store.try_get("ts_arrive/0") is not None, "rank 0's arrival stamp")
            time.sleep(0.5)
            b1.arrive(timeout_s=30)
            b1.depart(timeout_s=30)
        except BaseException as e:  # noqa: BLE001 — reported by the main thread
            errors.append(e)

    t = threading.Thread(target=rank1)
    t.start()
    b0.arrive(timeout_s=30)  # the leader waits here for rank 1
    b0.depart(timeout_s=30)
    t.join(_WAIT_S)
    assert not t.is_alive() and not errors, errors
    table = b0.arrival_table()
    assert set(table) == {0, 1}
    assert "arrive" in table[0] and "arrive" in table[1]
    assert table[1]["arrive"] - table[0]["arrive"] >= 0.5
    delta = phase_stats.delta(before)
    assert delta["barrier_wait"]["s"] >= 0.2


def test_cache_wait_is_metered(tmp_path, monkeypatch):
    """A reader parked on a held populate lock records the cache_wait
    phase, the cache.wait event and tpusnap_cache_wait_seconds_total."""
    arrs = arrays(nbytes_per_leaf=1 << 16, leaves=1, seed=5)
    snap_path = str(tmp_path / "step_1")
    # Batching off: the leaf is its own payload, so the reader's cache key
    # (the whole object, no range) is the one whose lock is held here.
    with knobs.override_batching_disabled(True):
        snap = ts.Snapshot.take(snap_path, state(arrs))
    md = snap.metadata
    location = cache_mod.payload_locations(md)[0][0]
    exact_key, _, _ = cache_mod.keys_for(cache_mod.snapshot_fingerprint(md), location, None)
    parked = threading.Event()
    try_acquire = cache_mod.CacheStore.try_acquire_populate_lock

    def observed_try_acquire(self, key):
        fd = try_acquire(self, key)
        if fd is None and key == exact_key:
            parked.set()  # the reader found the lock held: it waits now
        return fd

    monkeypatch.setattr(cache_mod.CacheStore, "try_acquire_populate_lock", observed_try_acquire)
    events = []
    event_handlers.register_event_handler(events.append)
    with knobs.override_cache_dir(str(tmp_path / "cache")), knobs.override_metrics(True):
        store = cache_mod.CacheStore(str(tmp_path / "cache"))
        fd = try_acquire(store, exact_key)
        assert fd is not None
        before = phase_stats.snapshot()
        result = {}

        def read():
            result["value"] = snap.read_object("0/m/w0", device="cpu")

        t = threading.Thread(target=read)
        t.start()
        assert parked.wait(_WAIT_S), "the reader never found the lock held"
        time.sleep(0.3)
        store.release_populate_lock(fd)
        t.join(timeout=_WAIT_S)
        assert not t.is_alive() and "value" in result
        assert result["value"].numpy().tobytes() == arrs["w0"].tobytes()
        delta = phase_stats.delta(before)
        assert delta["cache_wait"]["s"] >= 0.25, delta
        assert metrics.counter("tpusnap_cache_wait_seconds_total").get() > 0
    assert any(e.name == "cache.wait" for e in events)
