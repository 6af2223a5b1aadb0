"""One registry, two packages: torchsnapshot_tpu and torchsnapshot_tpu_torch
run each other's peer daemons and clients.

On one FileStore registry (``TPUSNAP_STORE_PATH``): a daemon of one
package serves a peer-first restore by the other with no origin payload
byte, bit-exact, for a content-addressed root and a CDC (``casx://``) root,
both ways; both packages list the same live peers in the same rendezvous
order, and a tombstone or a stale stamp written by one drops the row in
the other; the two daemons answer one ``/chunk`` request (whole and
ranged) with the same status, body and ``Content-Range``, and give
``/healthz`` and ``/inventory`` the same keys; each package's
``rollout_fleet`` rolls a delta out over the other's daemons; and both
parse the ``peer`` fault rules alike.  Inputs are numpy arrays from a
seed."""

import json
import time

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jax_pkg
import torchsnapshot_tpu_torch as port_pkg
from torchsnapshot_tpu import cache as jax_cache
from torchsnapshot_tpu import faults as jax_faults
from torchsnapshot_tpu import peer as jax_peer
from torchsnapshot_tpu import peerd as jax_peerd
from torchsnapshot_tpu_torch import cache as port_cache
from torchsnapshot_tpu_torch import faults as port_faults
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch import peer as port_peer
from torchsnapshot_tpu_torch import peerd as port_peerd

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures
from torch_peer_env import arrays, daemon, payload_read_bytes, peer_env, warm_into  # noqa: F401  peer_env is a fixture

PKGS = {
    "jax": (jax_pkg, jax_cache, jax_faults, jax_peer, jax_peerd),
    "port": (port_pkg, port_cache, port_faults, port_peer, port_peerd),
}
ORDERS = [("jax", "port"), ("port", "jax")]
CDC_PARAMS = (16384, 65536, 262144)


@pytest.fixture(autouse=True)
def both_packages_reset(peer_env):
    jax_peer.reset_process_stats()
    jax_faults.reset_read_counters()
    yield
    jax_peer.reset_process_stats()


def _state(pkg, arrs):
    if pkg == "port":
        return {"m": port_pkg.StateDict({k: torch.from_numpy(v.copy()) for k, v in arrs.items()})}
    return {"m": jax_pkg.StateDict({k: v.copy() for k, v in arrs.items()})}


def _zeros(pkg, arrs):
    return _state(pkg, {k: np.zeros_like(v) for k, v in arrs.items()})


def _assert_equal(dst, arrs):
    for k, v in arrs.items():
        got = dst["m"][k]
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        assert got.tobytes() == v.tobytes(), k


def _take(pkg, tmp_path, arrs, cdc=False):
    path = str(tmp_path / "root" / "step_1")
    with knobs.override_cas(True), knobs.override_cdc(cdc), knobs.override_cdc_params(*CDC_PARAMS):
        PKGS[pkg][0].Snapshot.take(path, _state(pkg, arrs))
    return path


@pytest.mark.parametrize("root_kind", ["cas", "casx"])
@pytest.mark.parametrize("server,client", ORDERS)
def test_daemon_of_one_package_serves_restore_of_the_other(peer_env, server, client, root_kind):
    tmp_path = peer_env
    arrs = arrays()
    path = _take(server, tmp_path, arrs, cdc=root_kind == "casx")
    s_pkg, s_cache, _, _, s_peerd = PKGS[server]
    md = s_pkg.Snapshot(path).metadata
    # With the peer tier on (and no daemon yet), a casx warm lands its parts
    # under servable cas/ keys.
    with knobs.override_peer_fetch(root_kind == "casx"):
        warm_into(path, md, str(tmp_path / "cacheA"), peerd=s_peerd, cache=s_cache)
    c_pkg, _, c_faults, c_peer, _ = PKGS[client]
    with daemon(str(tmp_path / "cacheA"), peerd=s_peerd):
        with knobs.override_cache_dir(str(tmp_path / "cacheB")), knobs.override_peer_fetch(True):
            c_faults.reset_read_counters()
            dst = _zeros(client, arrs)
            c_pkg.Snapshot(path).restore(dst)
            origin = payload_read_bytes(c_faults)
    _assert_equal(dst, arrs)
    assert origin == 0
    stats = c_peer.process_stats()
    assert stats["hit_bytes"] > 0 and stats["misses"] == 0 and stats["rejects"] == 0


def test_both_packages_rank_one_fleet_alike(peer_env):
    """A JAX daemon and a port daemon on one registry: each package's
    ``live_peers`` lists both, and ``rendezvous_order`` agrees per chunk."""
    tmp_path = peer_env
    with daemon(str(tmp_path / "cacheJ"), peerd=jax_peerd) as dj, daemon(str(tmp_path / "cacheP")) as dp:
        jax_list = jax_peer.live_peers(jax_peer.resolve_kv_store())
        port_list = port_peer.live_peers(port_peer.resolve_kv_store())
        assert [(p.slot, p.addr, p.pid) for p in jax_list] == [(p.slot, p.addr, p.pid) for p in port_list]
        assert sorted(p.addr for p in port_list) == sorted([dj.addr, dp.addr])
        for i in range(16):
            key = f"xxh64/{i:016x}"
            assert [p.addr for p in jax_peer.rendezvous_order(key, jax_list)] == [
                p.addr for p in port_peer.rendezvous_order(key, port_list)
            ]


@pytest.mark.parametrize("writer,reader", ORDERS)
def test_tombstone_and_stale_stamp_cross_packages(peer_env, writer, reader):
    w_peer, r_peer = PKGS[writer][3], PKGS[reader][3]
    w_kv, r_kv = w_peer.resolve_kv_store(), r_peer.resolve_kv_store()
    gone, stale = w_peer.PeerRegistration(w_kv, "10.0.0.1:1"), w_peer.PeerRegistration(w_kv, "10.0.0.2:1")
    keep = r_peer.PeerRegistration(r_kv, "10.0.0.3:1")
    try:
        assert {p.addr for p in r_peer.live_peers(r_kv)} == {"10.0.0.1:1", "10.0.0.2:1", "10.0.0.3:1"}
        gone.close()  # the tombstone
        stale._stop.set()
        stale._thread.join()
        record = {"addr": "10.0.0.2:1", "host": "h", "pid": 1, "stamp": time.time() - 9999.0, "done": False}
        w_kv.set(f"{w_peer.PEERD_PREFIX}/{stale.slot}", json.dumps(record).encode("utf-8"))
        assert [p.addr for p in r_peer.live_peers(r_kv)] == ["10.0.0.3:1"]
        assert [p.addr for p in w_peer.live_peers(w_kv)] == ["10.0.0.3:1"]
    finally:
        stale.close()
        keep.close()


def test_daemons_answer_alike(peer_env):
    """One warmed cache, served by a JAX daemon and a port daemon: the same
    status, body and ``Content-Range`` for whole, ranged, suffix,
    unsatisfiable and unknown chunks; the same ``/healthz`` and
    ``/inventory`` keys (and the same inventory)."""
    tmp_path = peer_env
    arrs = arrays(leaves=2)
    path = _take("port", tmp_path, arrs)
    warm_into(path, port_pkg.Snapshot(path).metadata, str(tmp_path / "cacheA"))
    cache_dir = str(tmp_path / "cacheA")
    with daemon(cache_dir, peerd=jax_peerd, register=False) as dj, daemon(cache_dir, register=False) as dp:
        inv = {}
        for name, d in (("jax", dj), ("port", dp)):
            status, _, body = port_peer.http_request(d.addr, "GET", "/inventory", 10.0)
            inv[name] = json.loads(body)
        assert inv["jax"] == inv["port"] and inv["port"]["chunks"]
        _, algo, hexd = inv["port"]["chunks"][0]["key"].split("/")
        total = inv["port"]["chunks"][0]["nbytes"]
        cases = [None, "bytes=10-41", "bytes=-16", "bytes=100-", f"bytes={total}-"]
        for chunk in (f"{algo}/{hexd}", f"{algo}/{'0' * 16}"):
            for rng in cases:
                answers = []
                for d in (dj, dp):
                    headers = {"Range": rng} if rng else {}
                    status, hdrs, body = port_peer.http_request(d.addr, "GET", f"/chunk/{chunk}", 10.0, headers)
                    if status != 200 and status != 206:
                        body = b""  # error documents may word themselves differently
                    answers.append((status, hdrs.get("content-range"), hdrs.get("cache-control"), body))
                assert answers[0] == answers[1], (chunk, rng)
        keys = []
        for d in (dj, dp):
            status, _, body = port_peer.http_request(d.addr, "GET", "/healthz", 10.0)
            assert status == 200
            keys.append(sorted(json.loads(body)))
        assert keys[0] == keys[1]


@pytest.mark.parametrize("caller,daemons", ORDERS)
def test_rollout_fleet_over_the_other_packages_daemons(peer_env, caller, daemons):
    """The caller's package saves a CAS manager root (step 1, then step 2
    with one leaf refilled) and rolls step 2 out over two daemons of the
    other package: the canary from origin, the fleet host from the canary."""
    tmp_path = peer_env
    c_pkg, _, _, _, c_peerd = PKGS[caller]
    root = str(tmp_path / "ckpts")
    arrs = arrays()
    with knobs.override_cas(True):
        mgr = c_pkg.SnapshotManager(root)
        mgr.save(1, _state(caller, arrs))
        arrs["w0"] = np.frombuffer(np.random.RandomState(777).bytes(1 << 20), np.uint8).copy()
        mgr.save(2, _state(caller, arrs))
    _, md, prev_md = c_peerd.resolve_rollout_target(root, None)[1:]
    delta_bytes = sum(n for _, n in c_peerd.delta_locations(md, prev_md))
    d_peerd = PKGS[daemons][4]
    with knobs.override_peer_fetch(True):
        with daemon(str(tmp_path / "cacheA"), root=root, peerd=d_peerd), daemon(
            str(tmp_path / "cacheB"), root=root, peerd=d_peerd
        ):
            out = c_peerd.rollout_fleet(root, None, canary=1)
    assert out["ok"], out
    assert out["step"] == 2 and out["canary_verify"][0]["chunks_verified"] > 0
    canary, fleet = out["canary_results"][0]["warm"], out["fleet_results"][0]["warm"]
    assert canary["delta_bytes"] == fleet["delta_bytes"] == delta_bytes > 0
    assert canary["cache"]["miss_bytes"] == delta_bytes
    assert fleet["peer"]["hit_bytes"] == delta_bytes and fleet["cache"]["miss_bytes"] == 0


PEER_SPECS = [
    "peer:1:peer_unreachable",
    "peer:2+:peer_slow:0.5",
    "peer:*:peer_truncated@/chunk/xxh64/*",
    "peer:3:peer_slow;read:1:transient",
    "read:1:peer_unreachable",
    "peer:1:latency:0.1",
    "peer:1:peer_unreachable:3",
    "peer:1:peer_slow:-1",
]


def test_both_packages_parse_peer_rules_alike():
    def parse(faults_mod, spec):
        try:
            rules = faults_mod.parse_fault_spec(spec)
        except ValueError:
            return "ValueError"
        return [(r.op, r.first, r.open_ended, r.kind, r.param, r.path_glob) for r in rules]

    paths = [f"/chunk/xxh64/{i:016x}" for i in range(4)]
    for spec in PEER_SPECS:
        assert parse(jax_faults, spec) == parse(port_faults, spec), spec
        fired = []
        for faults_mod in (jax_faults, port_faults):
            injector = faults_mod.maybe_peer_injector(spec)
            fired.append(None if injector is None else [rule and rule.kind for rule in map(injector.fire, paths)])
        assert fired[0] == fired[1], spec
