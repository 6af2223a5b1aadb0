"""The port's peer tier: daemon HTTP serving, peer-first restores,
verification on receipt, the registry and the peer fault kinds.

Mirrors the cases of ``tests/test_peer.py`` that run in one process: a
restore by a fresh host from two registered daemons (one seeded, one
empty) with no origin payload byte; the daemon's ``/chunk`` (whole,
ranged, suffix, unsatisfiable, unknown), ``/healthz`` and ``/inventory``;
registry stamps, staleness and tombstones; the rendezvous order; a rogue
peer rejected and quarantined, alone and beside a good daemon; the
quarantine's expiry; the three peer fault kinds; and a CDC (``casx://``)
snapshot fetched part by part.  Origin traffic is metered by the fault
wrapper (``TPUSNAP_FAULTS=none``)."""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu_torch import cache as cache_mod
from torchsnapshot_tpu_torch import cas as cas_mod
from torchsnapshot_tpu_torch import faults, knobs
from torchsnapshot_tpu_torch import peer as peer_mod

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


def _take(tmp_path, arrs):
    snap_path = str(tmp_path / "root" / "step_1")
    with knobs.override_cas(True):
        return ts.Snapshot.take(snap_path, state(arrs)), snap_path


class _RogueServer:
    """Answers every request with 200 and bytes that hash to no chunk: the
    corrupt or compromised peer the digest gate must reject."""

    def __init__(self):
        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self):  # noqa: N802
                body = b"\x00garbage\x00" * 400
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._srv.daemon_threads = True
        self.addr = f"127.0.0.1:{self._srv.server_address[1]}"
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join()


def test_two_daemon_peer_first_restore(peer_env):
    """A fresh host, with one seeded and one empty daemon registered,
    restores with no origin payload byte, bit-exact, the split recorded."""
    tmp_path = peer_env
    arrs = arrays()
    snap, snap_path = _take(tmp_path, arrs)
    warm_into(snap_path, snap.metadata, str(tmp_path / "cacheA"))
    with daemon(str(tmp_path / "cacheA")), daemon(str(tmp_path / "cacheB")):  # B empty: its 404s route onward
        with knobs.override_cache_dir(str(tmp_path / "cacheC")), knobs.override_peer_fetch(True):
            faults.reset_read_counters()
            dst = zeros(arrs)
            snap.restore(dst)
            origin = payload_read_bytes()
    assert_equal(dst, arrs)
    assert origin == 0, f"peer-first restore read {origin} origin bytes"
    stats = peer_mod.process_stats()
    assert stats["hits"] > 0 and stats["hit_bytes"] > 0
    assert stats["rejects"] == 0 and stats["misses"] == 0


def test_daemon_http_surface(peer_env):
    tmp_path = peer_env
    arrs = arrays(leaves=2)
    snap, snap_path = _take(tmp_path, arrs)
    warm_into(snap_path, snap.metadata, str(tmp_path / "cacheA"))
    with daemon(str(tmp_path / "cacheA")) as d:
        base = f"http://{d.addr}"
        health = json.loads(urllib.request.urlopen(f"{base}/healthz").read())
        assert health["ok"] and health["addr"] == d.addr

        inv = json.loads(urllib.request.urlopen(f"{base}/inventory").read())
        assert inv["entries"] >= 1 and not inv["truncated"]
        key = inv["chunks"][0]["key"]
        _, algo, hexdigest = key.split("/")

        resp = urllib.request.urlopen(f"{base}/chunk/{algo}/{hexdigest}")
        full = resp.read()
        assert len(full) == inv["chunks"][0]["nbytes"]
        assert "immutable" in resp.headers["Cache-Control"]

        req = urllib.request.Request(f"{base}/chunk/{algo}/{hexdigest}", headers={"Range": "bytes=10-41"})
        resp = urllib.request.urlopen(req)
        assert resp.status == 206
        assert resp.headers["Content-Range"] == f"bytes 10-41/{len(full)}"
        assert resp.read() == full[10:42]

        req = urllib.request.Request(f"{base}/chunk/{algo}/{hexdigest}", headers={"Range": "bytes=-16"})
        assert urllib.request.urlopen(req).read() == full[-16:]

        req = urllib.request.Request(f"{base}/chunk/{algo}/{hexdigest}", headers={"Range": f"bytes={len(full)}-"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req)
        assert err.value.code == 416
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/chunk/{algo}/{'0' * 16}")
        assert err.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/nonsense")
        assert err.value.code == 404
        # The metrics registry in the Prometheus text format (empty with
        # TPUSNAP_METRICS off).
        resp = urllib.request.urlopen(f"{base}/metrics")
        assert resp.status == 200 and resp.headers["Content-Type"].startswith("text/plain")


def test_registry_lease_staleness_and_tombstone(peer_env):
    kv = peer_mod.resolve_kv_store()
    assert kv is not None
    reg_a = peer_mod.PeerRegistration(kv, "10.0.0.1:8997")
    reg_b = peer_mod.PeerRegistration(kv, "10.0.0.2:8997")
    assert {p.addr for p in peer_mod.live_peers(kv)} == {"10.0.0.1:8997", "10.0.0.2:8997"}
    assert {p.addr for p in peer_mod.live_peers(kv, exclude_addr="10.0.0.1:8997")} == {"10.0.0.2:8997"}
    # A stale stamp drops the peer; B's refresh thread is stopped first so
    # that it cannot freshen the row again.
    reg_b._stop.set()
    reg_b._thread.join()
    stale = {"addr": "10.0.0.2:8997", "host": "h", "pid": 1, "stamp": time.time() - 9999.0, "done": False}
    kv.set(f"{peer_mod.PEERD_PREFIX}/{reg_b.slot}", json.dumps(stale).encode("utf-8"))
    assert {p.addr for p in peer_mod.live_peers(kv)} == {"10.0.0.1:8997"}
    reg_a.close()
    reg_b.close()
    assert peer_mod.live_peers(kv) == []


def test_rendezvous_order_deterministic_and_balanced(peer_env):
    kv = peer_mod.resolve_kv_store()
    regs = [peer_mod.PeerRegistration(kv, f"10.0.0.{i}:9000") for i in range(4)]
    try:
        peers = peer_mod.live_peers(kv)
        order1 = [p.addr for p in peer_mod.rendezvous_order("chunk/x", peers)]
        order2 = [p.addr for p in peer_mod.rendezvous_order("chunk/x", list(reversed(peers)))]
        assert order1 == order2
        firsts = {peer_mod.rendezvous_order(f"chunk/{i}", peers)[0].addr for i in range(64)}
        assert len(firsts) > 1
    finally:
        for reg in regs:
            reg.close()


def test_corrupt_peer_rejected_quarantined_refetched(peer_env):
    """Only a rogue registered: every chunk it serves is rejected and the
    restore reads origin, bit-exact."""
    tmp_path = peer_env
    arrs = arrays()
    snap, _ = _take(tmp_path, arrs)
    rogue = _RogueServer()
    rogue_reg = peer_mod.PeerRegistration(peer_mod.resolve_kv_store(), rogue.addr)
    try:
        with knobs.override_cache_dir(str(tmp_path / "cacheB")), knobs.override_peer_fetch(True):
            faults.reset_read_counters()
            dst = zeros(arrs)
            snap.restore(dst)
            origin = payload_read_bytes()
    finally:
        rogue_reg.close()
        rogue.close()
    assert_equal(dst, arrs)
    stats = peer_mod.process_stats()
    assert stats["rejects"] > 0
    assert stats["hit_bytes"] == 0
    assert origin > 0
    assert peer_mod.peer_scoreboard()[rogue.addr]["quarantined_until"] > time.time()


def test_corrupt_peer_skipped_in_favor_of_good_peer(peer_env):
    tmp_path = peer_env
    arrs = arrays()
    snap, snap_path = _take(tmp_path, arrs)
    warm_into(snap_path, snap.metadata, str(tmp_path / "cacheA"))
    rogue = _RogueServer()
    rogue_reg = peer_mod.PeerRegistration(peer_mod.resolve_kv_store(), rogue.addr)
    try:
        with daemon(str(tmp_path / "cacheA")):
            with knobs.override_cache_dir(str(tmp_path / "cacheB")), knobs.override_peer_fetch(True):
                faults.reset_read_counters()
                dst = zeros(arrs)
                snap.restore(dst)
                origin = payload_read_bytes()
    finally:
        rogue_reg.close()
        rogue.close()
    assert_equal(dst, arrs)
    assert origin == 0
    assert peer_mod.process_stats()["hit_bytes"] > 0


def test_quarantine_expires_after_bad_ttl(peer_env):
    kv = peer_mod.resolve_kv_store()
    reg = peer_mod.PeerRegistration(kv, "127.0.0.1:1")  # nothing listens there
    try:
        with knobs.override_peer_bad_ttl_s(0.2), knobs.override_peer_timeout_s(0.1), knobs.override_peer_retries(0):
            client = peer_mod.PeerClient(kv)
            assert client.fetch_chunk("xxh64", "0" * 16) is None
            assert client.candidates("k") == []  # quarantined
            time.sleep(0.25)
            assert len(client.candidates("k")) == 1  # the TTL ran out
    finally:
        reg.close()


@pytest.mark.parametrize("spec", ["peer:1:peer_unreachable", "peer:1:peer_slow:0.05", "peer:1:peer_truncated"])
def test_peer_fault_kinds_fall_back_cleanly(peer_env, spec):
    """A dead, slow or truncating peer never changes a restore's bytes: a
    truncated body is a digest reject, counted, and its chunk is read from
    origin; every other chunk still comes from the peer."""
    tmp_path = peer_env
    arrs = arrays(leaves=2)
    snap, snap_path = _take(tmp_path, arrs)
    warm_into(snap_path, snap.metadata, str(tmp_path / "cacheA"))
    with daemon(str(tmp_path / "cacheA")):
        with knobs.override_cache_dir(str(tmp_path / "cacheB")), knobs.override_peer_fetch(True), knobs.override_faults(
            spec
        ), knobs.override_peer_timeout_s(2.0):
            faults.reset_read_counters()
            dst = zeros(arrs)
            snap.restore(dst)
            origin = payload_read_bytes()
    assert_equal(dst, arrs)
    stats = peer_mod.process_stats()
    assert origin == stats["miss_bytes"]
    if spec.endswith("peer_truncated"):
        assert stats["rejects"] == 1 and origin > 0
    else:  # an unreachable peer is retried once (TPUSNAP_PEER_RETRIES=1)
        assert stats["rejects"] == 0 and origin == 0 and stats["hit_bytes"] > 0


def test_peer_fault_spec_validation():
    with pytest.raises(ValueError):
        faults.parse_fault_spec("read:1:peer_unreachable")
    with pytest.raises(ValueError):
        faults.parse_fault_spec("peer:1:latency:0.1")
    with pytest.raises(ValueError):
        faults.parse_fault_spec("peer:1:peer_unreachable:3")
    with pytest.raises(ValueError):
        faults.parse_fault_spec("peer:1:peer_slow:-1")
    rules = faults.parse_fault_spec("peer:1:peer_slow:0.5")
    assert rules[0].op == "peer" and rules[0].param == 0.5
    injector = faults.maybe_peer_injector("peer:2:peer_truncated;read:1:transient")
    assert len(injector) == 1
    assert injector.fire("/chunk/xxh64/0") is None and injector.fire("/chunk/xxh64/1").kind == "peer_truncated"


def test_casx_parts_fetch_peer_first(peer_env):
    """A CDC snapshot restores peer-first part by part, bit-exact: the seed
    host warmed with the peer tier on, so its cache holds the parts."""
    tmp_path = peer_env
    arrs = arrays()
    snap_path = str(tmp_path / "root" / "step_1")
    with knobs.override_cas(True), knobs.override_cdc(True), knobs.override_cdc_params(16384, 65536, 262144):
        snap = ts.Snapshot.take(snap_path, state(arrs))
    assert any(cas_mod.is_casx_location(loc) for loc, _ in cache_mod.payload_locations(snap.metadata))
    with knobs.override_peer_fetch(True):
        warm_into(snap_path, snap.metadata, str(tmp_path / "cacheA"))
    with daemon(str(tmp_path / "cacheA")):
        with knobs.override_cache_dir(str(tmp_path / "cacheB")), knobs.override_peer_fetch(True):
            faults.reset_read_counters()
            dst = zeros(arrs)
            snap.restore(dst)
            origin = payload_read_bytes()
    assert_equal(dst, arrs)
    assert origin == 0
    assert peer_mod.process_stats()["hits"] > 0
