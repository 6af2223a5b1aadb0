"""The port's peer scoreboard and the daemon inventory's cap.

Mirrors the cases of ``tests/test_peer_trace.py`` that read no trace,
metric or fleet spool: demotion of a persistently slow peer (and factor 0
turning it off), of a flaky one on its error EWMA, a demoted peer ranked
last among the candidates, an inventory that reports its total past the
cap, and the scoreboard half of the calibrated costs (the span half waits
for the tracer).  Plus the events and phase of real fetches: a run of
failed dials emits one ``peer.demoted``; a corrupt body one
``peer.reject``; a served chunk adds to ``peer_read``.  No wall-clock
bound: outcomes are fed as rates and counts."""

import json
import urllib.request

import pytest

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu_torch import knobs, phase_stats
from torchsnapshot_tpu_torch import peer as peer_mod
from torchsnapshot_tpu_torch import peerd as peerd_mod
from torchsnapshot_tpu_torch.event_handlers import register_event_handler, unregister_event_handler

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures
from torch_peer_env import arrays, daemon, peer_env, state, warm_into  # noqa: F401  peer_env is a fixture


@pytest.fixture
def events():
    got = []
    register_event_handler(got.append)
    yield got
    unregister_event_handler(got.append)


def test_scoreboard_demotes_persistently_slow_peer(peer_env):
    peer_mod.reset_peer_scoreboard()
    with knobs.override_peer_demote_factor(3.0):
        for _ in range(8):
            peer_mod.record_fetch_outcome("10.0.0.1:1", 0.01, "hit", 100)
            peer_mod.record_fetch_outcome("10.0.0.2:1", 0.012, "hit", 100)
        demoted = False
        for _ in range(8):
            demoted = peer_mod.record_fetch_outcome("10.0.0.3:1", 0.5, "hit", 100) or demoted
        assert demoted
        board = peer_mod.peer_scoreboard()
        assert board["10.0.0.3:1"]["demoted"]
        assert not board["10.0.0.1:1"]["demoted"]
        assert board["10.0.0.3:1"]["p99_s"] >= board["10.0.0.1:1"]["p99_s"]
        assert board["10.0.0.1:1"]["hits"] == 8 and board["10.0.0.1:1"]["bytes"] == 800
        assert peer_mod._demoted_addrs() == {"10.0.0.3:1"}

    peer_mod.reset_peer_scoreboard()
    with knobs.override_peer_demote_factor(0.0):
        for _ in range(8):
            peer_mod.record_fetch_outcome("a:1", 0.01, "hit")
            peer_mod.record_fetch_outcome("b:1", 0.01, "hit")
            assert not peer_mod.record_fetch_outcome("c:1", 5.0, "hit")
    assert peer_mod._demoted_addrs() == set()


def test_scoreboard_demotes_flaky_peer_on_error_ewma(peer_env):
    peer_mod.reset_peer_scoreboard()
    demoted = False
    for _ in range(12):
        demoted = peer_mod.record_fetch_outcome("bad:1", 0.01, "error") or demoted
    assert demoted
    board = peer_mod.peer_scoreboard()
    assert board["bad:1"]["ewma_error"] > 0.5
    assert board["bad:1"]["errors"] == 12


def test_demoted_peer_ranked_last_in_candidates(peer_env):
    kv = peer_mod.resolve_kv_store()
    regs = [peer_mod.PeerRegistration(kv, f"10.9.0.{i}:9000") for i in range(3)]
    try:
        client = peer_mod.PeerClient(kv)
        baseline = [p.addr for p in client.candidates("chunk/z")]
        front = baseline[0]
        for _ in range(12):
            peer_mod.record_fetch_outcome(front, 0.01, "error")
        reordered = [p.addr for p in client.candidates("chunk/z")]
        assert reordered[-1] == front
        assert set(reordered) == set(baseline)
    finally:
        for reg in regs:
            reg.close()


def test_inventory_reports_total_past_cap(peer_env, monkeypatch):
    tmp_path = peer_env
    # Four snapshots of distinct bytes: four CAS entries in the cache (one
    # snapshot would pack its leaves into one slab, one entry).
    for seed in range(4):
        snap_path = str(tmp_path / "root" / f"step_{seed + 1}")
        with knobs.override_cas(True):
            snap = ts.Snapshot.take(snap_path, state(arrays(nbytes_per_leaf=1 << 16, leaves=1, seed=seed)))
        warm_into(snap_path, snap.metadata, str(tmp_path / "cacheA"))
    monkeypatch.setattr(peerd_mod, "_INVENTORY_CAP", 2)
    with daemon(str(tmp_path / "cacheA")) as d:
        inv = json.loads(urllib.request.urlopen(f"http://{d.addr}/inventory").read())
    assert inv["truncated"]
    assert len(inv["chunks"]) == 2
    assert inv["chunks_total"] > len(inv["chunks"])
    assert inv["chunks_total"] == inv["entries"] == 4


def test_calibrated_scoreboard_cost(peer_env):
    for _ in range(3):
        peer_mod.record_fetch_outcome("10.0.0.1:1", 0.01, "hit", 1)
    cost = peer_mod.calibrated_scoreboard_cost_s(samples=50)
    assert cost["per_update_s"] >= 0.0
    assert cost["updates"] == 3  # the probe's own updates are not counted
    assert cost["estimated_s"] == pytest.approx(cost["per_update_s"] * 3)
    # The probe leaves neither its synthetic peer nor its updates behind.
    assert "calibration.invalid:0" not in peer_mod.peer_scoreboard()
    assert peer_mod.calibrated_scoreboard_cost_s(samples=5)["updates"] == 3


def test_failed_dials_demote_a_peer_once(peer_env, events):
    """Every dial of a dead peer fails: its error EWMA passes 0.5 on the
    4th failure (1 - 0.8^4), which demotes it, with one ``peer.demoted``."""
    kv = peer_mod.resolve_kv_store()
    reg = peer_mod.PeerRegistration(kv, "127.0.0.1:1")  # nothing listens there
    try:
        with knobs.override_peer_bad_ttl_s(0.0), knobs.override_peer_timeout_s(0.5), knobs.override_peer_retries(0):
            client = peer_mod.PeerClient(kv)
            for i in range(6):
                assert client.fetch_chunk("xxh64", f"{i:016x}") is None
    finally:
        reg.close()
    row = peer_mod.peer_scoreboard()["127.0.0.1:1"]
    assert row["errors"] == 6 and row["demoted"]
    demoted = [e for e in events if e.name == "peer.demoted"]
    assert len(demoted) == 1 and demoted[0].metadata == {"peer": "127.0.0.1:1", "status": "error"}


def test_served_and_rejected_fetches_are_recorded(peer_env, events):
    """A chunk a daemon serves adds its bytes to ``peer_read`` and a hit to
    the scoreboard; the same chunk cut in half by ``peer_truncated`` is one
    ``peer.reject`` and one reject."""
    tmp_path = peer_env
    snap_path = str(tmp_path / "root" / "step_1")
    with knobs.override_cas(True):
        snap = ts.Snapshot.take(snap_path, state(arrays(leaves=1)))
    warm_into(snap_path, snap.metadata, str(tmp_path / "cacheA"))
    (location, nbytes), = peerd_mod.delta_locations(snap.metadata, None)
    algo, hexdigest = location[len("cas://") :].split("/")
    kv = peer_mod.resolve_kv_store()
    with daemon(str(tmp_path / "cacheA")) as d:
        phase_stats.reset()
        client = peer_mod.PeerClient(kv)
        assert len(client.fetch_chunk(algo, hexdigest)) == nbytes
        read = phase_stats.snapshot()["peer_read"]
        assert read["n"] == 1 and read["bytes"] == nbytes
        with knobs.override_faults("peer:1:peer_truncated"):
            truncating = peer_mod.PeerClient(kv)
        assert truncating.fetch_chunk(algo, hexdigest) is None
        assert truncating.rejects == 1 and truncating.candidates(f"{algo}/{hexdigest}") == []
    row = peer_mod.peer_scoreboard()[d.addr]
    assert (row["hits"], row["rejects"], row["bytes"]) == (1, 1, nbytes)
    rejects = [e for e in events if e.name == "peer.reject"]
    assert [e.metadata for e in rejects] == [{"peer": d.addr, "reason": "digest_mismatch"}]
