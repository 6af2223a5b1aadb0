"""The port's staged delta rollout, a killed daemon, and a standard-library
consumer of a port daemon.

Mirrors ``tests/test_peer.py``'s rollout cases (a two-step fine-tune
rolled out as a delta: the canary from origin once, the fleet host from
the canary, digest spot-checks gating the fleet wave; a canary that cannot
warm aborts before any fleet host), its kill -9 case (a port daemon in a
``python -c`` child, the port having no command line yet: the puller
falls back to origin), the consumer half of its command-line case
(``examples/http_range_pull.py``, which imports nothing of either package,
against a port daemon), and its soak, ``slow`` as there."""

import contextlib
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu_torch import faults, knobs
from torchsnapshot_tpu_torch import peer as peer_mod
from torchsnapshot_tpu_torch import peerd as peerd_mod

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures
from torch_peer_env import (  # noqa: F401  peer_env is a fixture
    arrays,
    assert_equal,
    daemon,
    payload_read_bytes,
    peer_env,
    state,
    warm_into,
    zeros,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DAEMON = r"""
import sys
import time

from torchsnapshot_tpu_torch import peerd

d = peerd.PeerDaemon(cache_dir=sys.argv[1], advertise="127.0.0.1")
print("listening on", d.start(), flush=True)
assert "jax" not in sys.modules
while True:
    time.sleep(60)
"""


def _take(tmp_path, arrs):
    snap_path = str(tmp_path / "root" / "step_1")
    with knobs.override_cas(True):
        return ts.Snapshot.take(snap_path, state(arrs)), snap_path


def _two_steps(root):
    """A CAS manager root: step 1, then step 2 with ``w0`` refilled."""
    with knobs.override_cas(True):
        mgr = ts.SnapshotManager(root)
        arrs = arrays()
        mgr.save(1, state(arrs))
        arrs["w0"] = np.frombuffer(np.random.RandomState(777).bytes(1 << 20), np.uint8).copy()
        mgr.save(2, state(arrs))


def test_rollout_delta_canary_then_fleet(peer_env):
    tmp_path = peer_env
    root = str(tmp_path / "ckpts")
    _two_steps(root)
    step, _, md, prev_md = peerd_mod.resolve_rollout_target(root, None)
    assert step == 2
    delta = peerd_mod.delta_locations(md, prev_md)
    full = peerd_mod.delta_locations(md, None)
    assert 0 < len(delta) < len(full)
    delta_bytes = sum(n for _, n in delta)
    assert delta_bytes < sum(n for _, n in full)

    with knobs.override_peer_fetch(True):
        with daemon(str(tmp_path / "cacheA"), root=root), daemon(str(tmp_path / "cacheB"), root=root):
            faults.reset_read_counters()
            out = peerd_mod.rollout_fleet(root, None, canary=1)
            origin = payload_read_bytes()
    assert out["ok"], out
    assert out["step"] == 2
    assert len(out["canaries"]) == 1 and len(out["fleet"]) == 1
    assert out["canary_verify"][0]["ok"] and out["canary_verify"][0]["chunks_verified"] > 0
    canary_warm = out["canary_results"][0]["warm"]
    assert canary_warm["delta_bytes"] == delta_bytes
    assert canary_warm["cache"]["miss_bytes"] == delta_bytes and canary_warm["peer"]["hit_bytes"] == 0
    fleet_warm = out["fleet_results"][0]["warm"]
    assert fleet_warm["peer"]["hit_bytes"] == delta_bytes
    assert fleet_warm["cache"]["miss_bytes"] == 0
    assert origin == delta_bytes  # the delta left origin once


def test_rollout_aborts_before_fleet_on_canary_failure(peer_env):
    tmp_path = peer_env
    root = str(tmp_path / "ckpts")
    with knobs.override_cas(True):
        ts.SnapshotManager(root).save(1, state(arrays(leaves=1)))
    with daemon(str(tmp_path / "cacheA")), daemon(str(tmp_path / "cacheB")):  # no root: a canary cannot warm
        out = peerd_mod.rollout_fleet(root, None, canary=1)
    assert not out["ok"]
    assert out["aborted"] == "canary warm failed"
    assert "no manager root" in out["canary_results"][0]["error"]
    assert "fleet_results" not in out and "canary_verify" not in out


@contextlib.contextmanager
def _daemon_process(cache_dir):
    """A port daemon in a ``python -c`` child on this test's registry; its
    advertised address."""
    env = dict(os.environ)  # carries the test's TPUSNAP_STORE_PATH
    proc = subprocess.Popen(
        [sys.executable, "-c", _DAEMON, cache_dir],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        env=env,
        cwd=REPO_ROOT,
    )
    try:
        line = proc.stdout.readline()
        assert "listening on" in line, proc.stderr.read() if proc.poll() is not None else line
        yield proc, line.split("listening on", 1)[1].split()[0]
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=30)


def test_kill9_daemon_falls_back_to_origin(peer_env):
    """SIGKILL a serving port daemon: its row goes stale in place (no
    tombstone), the puller's dial fails, the peer is quarantined, and the
    restore completes from origin, bit-exact."""
    tmp_path = peer_env
    arrs = arrays()
    snap, snap_path = _take(tmp_path, arrs)
    warm_into(snap_path, snap.metadata, str(tmp_path / "cacheA"))
    with _daemon_process(str(tmp_path / "cacheA")) as (proc, addr):
        assert [p.addr for p in peer_mod.live_peers(peer_mod.resolve_kv_store())] == [addr]
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        with knobs.override_cache_dir(str(tmp_path / "cacheB")), knobs.override_peer_fetch(
            True
        ), knobs.override_peer_timeout_s(1.0), knobs.override_peer_retries(0):
            faults.reset_read_counters()
            dst = zeros(arrs)
            snap.restore(dst)
            origin = payload_read_bytes()
    assert_equal(dst, arrs)
    stats = peer_mod.process_stats()
    assert origin > 0 and origin == stats["miss_bytes"] and stats["hit_bytes"] == 0
    row = peer_mod.peer_scoreboard()[addr]
    # Dials fail only until the first failure quarantines the peer: at most
    # one per fetch already in flight, never one per later chunk.
    assert 1 <= row["errors"] <= stats["misses"] and row["rejects"] == 0
    assert row["quarantined_until"] > 0


def test_stdlib_consumer_pulls_from_port_daemon(peer_env):
    """``examples/http_range_pull.py``, run with no package on its path,
    pulls one entry from a port daemon by ranged GETs and verifies its
    xxh64 itself."""
    tmp_path = peer_env
    arrs = arrays(leaves=2)
    snap, snap_path = _take(tmp_path, arrs)
    warm_into(snap_path, snap.metadata, str(tmp_path / "cacheA"))
    out_file = str(tmp_path / "w0.bin")
    with daemon(str(tmp_path / "cacheA")) as d:
        consumer = subprocess.run(
            [
                sys.executable,
                os.path.join(REPO_ROOT, "examples", "http_range_pull.py"),
                snap_path,
                f"http://{d.addr}",
                "0/m/w0",
                out_file,
            ],
            capture_output=True,
            text=True,
            timeout=120,
            env={"PATH": os.environ.get("PATH", "")},
        )
    assert consumer.returncode == 0, consumer.stderr or consumer.stdout
    assert "verified xxh64:" in consumer.stdout
    with open(out_file, "rb") as f:
        assert f.read() == arrs["w0"].tobytes()


_PULLER = r"""
import hashlib
import json
import sys

import torch

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu_torch import faults, peer

snap = ts.Snapshot(sys.argv[1])
dst = {"m": ts.StateDict({f"w{i}": torch.zeros(int(sys.argv[2]), dtype=torch.uint8) for i in range(int(sys.argv[3]))})}
snap.restore(dst)
origin = sum(n for p, n in faults.read_counters().items() if not p.rsplit("/", 1)[-1].startswith(".") and not p.startswith("telemetry/"))
assert "jax" not in sys.modules
digests = {k: hashlib.sha1(v.numpy().tobytes()).hexdigest() for k, v in dst["m"].items()}
print(json.dumps({"origin": origin, "digests": digests, **peer.process_stats()}))
"""


@pytest.mark.slow
def test_multi_peer_soak(peer_env):
    """Three seeded daemons and a rogue; four fresh hosts (``python -c``
    children, each with its own cache) restore at once, each bit-exact
    with no origin payload byte."""
    import hashlib
    import json

    from test_torch_peer import _RogueServer

    tmp_path = peer_env
    leaf = 1 << 21
    arrs = arrays(nbytes_per_leaf=leaf)
    snap, snap_path = _take(tmp_path, arrs)
    rogue = _RogueServer()
    rogue_reg = peer_mod.PeerRegistration(peer_mod.resolve_kv_store(), rogue.addr)
    seeded = [str(tmp_path / f"cache_seed{i}") for i in range(3)]
    for cdir in seeded:
        warm_into(snap_path, snap.metadata, cdir)
    docs = []
    try:
        with contextlib.ExitStack() as stack:
            for cdir in seeded:
                stack.enter_context(daemon(cdir))
            procs = []
            for i in range(4):
                env = dict(os.environ)  # the test's TPUSNAP_STORE_PATH and TPUSNAP_FAULTS=none
                env["TPUSNAP_CACHE_DIR"] = str(tmp_path / f"cache_pull{i}")
                env["TPUSNAP_PEER_FETCH"] = "1"
                procs.append(
                    subprocess.Popen(
                        [sys.executable, "-c", _PULLER, snap_path, str(leaf), str(len(arrs))],
                        stdout=subprocess.PIPE,
                        stderr=subprocess.PIPE,
                        text=True,
                        env=env,
                        cwd=REPO_ROOT,
                    )
                )
            for proc in procs:
                out, err = proc.communicate(timeout=600)
                assert proc.returncode == 0, err[-2000:]
                docs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        rogue_reg.close()
        rogue.close()
    want = {k: hashlib.sha1(v.tobytes()).hexdigest() for k, v in arrs.items()}
    for doc in docs:
        assert doc["digests"] == want
        assert doc["origin"] == 0 and doc["hit_bytes"] > 0
