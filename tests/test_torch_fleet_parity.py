"""Fleet telemetry across the two packages: torchsnapshot_tpu and
torchsnapshot_tpu_torch publish into one spool and read it alike.

- An entry built by either package for one OpMonitor-shaped object has the
  same keys, nested ones included (``op``, ``proc``, ``cache``, ``peer``,
  ``peer_scoreboard``, ``metrics``, ``extra``), and the same values apart
  from the host, pid, time stamp and the registry each package dumps.
- A spool written by the port, by the JAX package, or by both, is
  collected and aggregated into equal views by either package.
- ``render_prometheus`` merges a port registry and a JAX one into the same
  exposition under either package.
- Both packages' ``trace.host_skew_from_spool`` estimate the same per-host
  skew from a spool the port wrote.
- The three fleet knobs read the same in both packages.

Ages and stamps are never compared."""

import json
import os

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jax_pkg
import torchsnapshot_tpu_torch as port_pkg
from torchsnapshot_tpu import cache as jax_cache
from torchsnapshot_tpu import knobs as jax_knobs
from torchsnapshot_tpu import peer as jax_peer
from torchsnapshot_tpu.telemetry import fleet as jax_fleet
from torchsnapshot_tpu.telemetry import metrics as jax_metrics
from torchsnapshot_tpu.telemetry import monitor as jax_monitor
from torchsnapshot_tpu.telemetry import trace as jax_trace
from torchsnapshot_tpu_torch import cache as port_cache
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch import peer as port_peer
from torchsnapshot_tpu_torch.telemetry import fleet as port_fleet
from torchsnapshot_tpu_torch.telemetry import metrics as port_metrics
from torchsnapshot_tpu_torch.telemetry import monitor as port_monitor
from torchsnapshot_tpu_torch.telemetry import trace as port_trace

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

FLEET = {"jax": jax_fleet, "port": port_fleet}
# Keys whose values differ between two publishes of one op by design.
_STAMPS = ("host", "pid", "publish_time")


@pytest.fixture(autouse=True)
def clean_state():
    for mod in (jax_metrics, port_metrics):
        mod.uninstall_event_bridge()
        mod.reset()
    for mod in (jax_fleet, port_fleet):
        mod.reset_process_totals()
    for mod in (jax_cache, port_cache, jax_peer, port_peer):
        mod.reset_process_stats()
    yield
    for mod in (jax_metrics, port_metrics):
        mod.uninstall_event_bridge()
        mod.reset()
    for mod in (jax_fleet, port_fleet):
        mod.reset_process_totals()
    for mod in (jax_cache, port_cache, jax_peer, port_peer):
        mod.reset_process_stats()
    assert jax_monitor._ACTIVE == [] and port_monitor._ACTIVE == []


class _Duck:
    """An OpMonitor-shaped object with a fixed progress document."""

    kind = "rollout"
    op_id = "ab" * 16
    rank = 3

    def __init__(self):
        self.fleet_extra = {"rollout": {"root": "/r", "step": 2, "wave": "fleet", "completed": 1, "total": 2,
                                        "peer_bytes": 64, "origin_bytes": 0, "eta_s": 1.5}}

    @staticmethod
    def progress():
        return {
            "action": "rollout",
            "op_id": "ab" * 16,
            "rank": 3,
            "elapsed_s": 1.25,
            "requests": {"total": 4, "staged": 3, "written": 2},
            "bytes": {"staged": 300, "written": 200},
            "eta_s": 1.25,
            "pipelines": [],
            "rss_high_water_bytes": 0,
            "stalls": 0,
            "stall_bundle": None,
            "done": False,
            "success": None,
        }


class _Kind(_Duck):
    """The duck under another op kind, with no extension document."""

    def __init__(self, kind):
        self.kind = kind
        self.fleet_extra = None


def _deep_keys(doc, prefix=""):
    out = set()
    if isinstance(doc, dict):
        for k, v in doc.items():
            out.add(prefix + k)
            out |= _deep_keys(v, prefix + k + ".")
    elif isinstance(doc, list):
        for v in doc:
            out |= _deep_keys(v, prefix + "[].")
    return out


def _without_ages(obj):
    """A view or entry less what depends on when it was read."""
    if isinstance(obj, dict):
        return {k: _without_ages(v) for k, v in obj.items() if k not in ("time", "_age_s", "age_s", "last_seen_s")}
    if isinstance(obj, list):
        return [_without_ages(v) for v in obj]
    return obj


def test_entries_of_one_monitor_have_the_same_keys_and_values():
    docs = {}
    with knobs.override_metrics(True):
        for pkg, metrics_mod, peer_mod in (("jax", jax_metrics, jax_peer), ("port", port_metrics, port_peer)):
            metrics_mod.counter("tpusnap_test_total", "t").inc(2, backend="fs")
            peer_mod.record_fetch_outcome("10.0.0.1:8997", 0.01, "hit", 4096)
            docs[pkg] = FLEET[pkg].build_entry(_Duck())
    jax_doc, port_doc = docs["jax"], docs["port"]
    assert _deep_keys(port_doc) == _deep_keys(jax_doc)
    assert {"op", "proc", "cache", "peer", "peer_scoreboard", "metrics", "extra"} <= set(port_doc)
    assert port_doc["pid"] == jax_doc["pid"] == os.getpid()
    for key in set(port_doc) - set(_STAMPS) - {"metrics"}:
        assert port_doc[key] == jax_doc[key], key
    names = {pkg: {fam["name"] for fam in doc["metrics"]} for pkg, doc in docs.items()}
    assert "tpusnap_test_total" in names["port"] & names["jax"]


def _np_state():
    return {"m": jax_pkg.StateDict({"w0": np.arange(4096, dtype=np.float32)})}


def _torch_state():
    return {"m": port_pkg.StateDict({"w0": torch.arange(4096, dtype=torch.float32)})}


@pytest.mark.parametrize("writer", ["port", "jax", "mixed"])
def test_spools_read_alike_by_both_packages(tmp_path, writer):
    """Real ops publish the spool: the port's take and restore, the JAX
    package's, or a port take beside a JAX restore.  Both collectors read
    the same entries, and both aggregations of either's entries agree."""
    spool = str(tmp_path / "live")
    jax_snap = jax_pkg.Snapshot.take(str(tmp_path / "jax_base"), _np_state()) if writer != "port" else None
    with knobs.override_fleet_telemetry(spool):
        if writer in ("port", "mixed"):
            port_snap = port_pkg.Snapshot.take(str(tmp_path / "port"), _torch_state())
        if writer == "port":
            port_snap.restore({"m": port_pkg.StateDict({"w0": torch.zeros(4096)})})
        if writer == "jax":
            jax_pkg.Snapshot.take(str(tmp_path / "jax"), _np_state())
        if writer != "port":
            jax_snap.restore({"m": jax_pkg.StateDict({"w0": np.zeros(4096, np.float32)})})
    entries = {pkg: mod.collect(spool, stale_s=1e9, sweep=False) for pkg, mod in FLEET.items()}
    assert _without_ages(entries["port"]) == _without_ages(entries["jax"])
    assert sorted(d["kind"] for d in entries["port"]) == ["restore", "take"]
    assert all(d["op"]["done"] is True and d["op"]["success"] is True for d in entries["port"])
    views = [_without_ages(FLEET[agg].aggregate(entries[src])) for agg in FLEET for src in FLEET]
    assert all(v == views[0] for v in views[1:])
    view = views[0]
    assert view["n_entries"] == 2 and view["n_live"] == 0
    assert view["op_totals"]["bytes_written"] >= 2 * 4096 * 4
    assert FLEET["port"].render(FLEET["port"].aggregate(entries["jax"]), spool).splitlines()[1:] == FLEET[
        "jax"
    ].render(FLEET["jax"].aggregate(entries["port"]), spool).splitlines()[1:]


def test_render_prometheus_merges_a_port_and_a_jax_registry(tmp_path):
    spool = str(tmp_path / "live")
    with knobs.override_metrics(True), knobs.override_fleet_telemetry(spool):
        port_metrics.counter("tpusnap_port_test_total", "p").inc(3, backend="fs")
        jax_metrics.counter("tpusnap_jax_test_total", "j").inc(5, backend="fs")
        port_monitor.op_finished(port_monitor.op_started("take", "ab" * 16, 0, watchdog=False))
        jax_monitor.op_finished(jax_monitor.op_started("restore", "cd" * 16, 1, watchdog=False))
    entries = port_fleet.collect(spool, stale_s=1e9, sweep=False)
    out = port_fleet.render_prometheus(entries)
    assert out == jax_fleet.render_prometheus(entries)
    worker = f'worker="{entries[0]["host"]}:{os.getpid()}"'
    assert f'tpusnap_port_test_total{{backend="fs",{worker}}} 3' in out
    assert f'tpusnap_jax_test_total{{backend="fs",{worker}}} 5' in out
    assert "tpusnap_fleet_workers 2" in out and "tpusnap_fleet_stale_peers 0" in out
    assert sum(line.startswith("# TYPE ") for line in out.splitlines()) == len(
        {line.split()[2] for line in out.splitlines() if line.startswith("# TYPE ")}
    )


def test_both_trace_modules_estimate_the_same_skew_from_a_port_spool(tmp_path, monkeypatch):
    """Entries of two hosts published by the port, their files' mtimes
    2 s and 0 s past their stamps: both packages' estimates agree."""
    spool = str(tmp_path / "live")
    with knobs.override_fleet_telemetry(spool):
        for host, lag_s in (("host-a", 2.0), ("host-b", 0.0)):
            monkeypatch.setattr(port_fleet, "_HOSTNAME", host)
            for kind in ("take", "restore"):
                path = port_fleet.publish(_Kind(kind))
                with open(path, encoding="utf-8") as f:
                    stamp = json.load(f)["publish_time"]
                os.utime(path, (stamp + lag_s, stamp + lag_s))
    skew = port_trace.host_skew_from_spool(spool)
    assert skew == jax_trace.host_skew_from_spool(spool)
    assert skew["host-b"] == 0.0 and abs(skew["host-a"] - 2.0) < 0.01



def test_fleet_knobs_read_as_in_the_jax_package():
    getters = ("get_fleet_telemetry_dir", "get_fleet_telemetry_interval_s", "get_fleet_telemetry_stale_s")
    cases = [
        (None, None, None),
        ("/tmp/live", "0.25", "60"),
        (" off ", "0.001", "0.2"),  # off, and both clamps
        ("none", "2", "1"),
    ]
    for spool, interval, stale in cases:
        with knobs.override_fleet_telemetry(spool), knobs.override_env(
            knobs.FLEET_TELEMETRY_INTERVAL_S_ENV_VAR, interval
        ), knobs.override_env(knobs.FLEET_TELEMETRY_STALE_S_ENV_VAR, stale):
            for getter in getters:
                assert getattr(knobs, getter)() == getattr(jax_knobs, getter)(), (getter, spool, interval, stale)
            assert port_fleet.enabled() == jax_fleet.enabled() == (knobs.get_fleet_telemetry_dir() is not None)
    assert knobs.get_fleet_telemetry_interval_s() == 1.0 and knobs.get_fleet_telemetry_stale_s() == 30.0
    assert (port_fleet.SCHEMA_VERSION, port_fleet.ENTRY_SUFFIX, port_fleet.SPOOL_DIRNAME) == (
        jax_fleet.SCHEMA_VERSION,
        jax_fleet.ENTRY_SUFFIX,
        jax_fleet.SPOOL_DIRNAME,
    )
    assert port_fleet.entry_name("serve", 2, pid=7) == jax_fleet.entry_name("serve", 2, pid=7)
    assert port_fleet.OVERHEAD_BUDGET_FRAC == jax_fleet.OVERHEAD_BUDGET_FRAC
