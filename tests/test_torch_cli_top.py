"""``python -m torchsnapshot_tpu_torch top``, mirroring the CLI cases of
tests/test_fleet.py (``--json`` one shot, the ``--once`` table and a missing
spool, the merged Prometheus exposition, ``--json`` over two serving worker
processes) and tests/test_peer_trace.py's rollout banner, plus the shared
store's usage under ``TPUSNAP_STORE``:

- ``--json`` prints ``fleet.aggregate(fleet.collect(spool, sweep=False))``
  (ages and the view's own time read at call time), with ``store`` when a
  store is set; ``--prometheus`` prints ``render_prometheus``; ``--once``
  prints ``render`` and the store's lines; no spool exits 2;
- two spawned port workers restoring one snapshot through one cache
  publish into one spool, and ``top --json`` holds both processes with
  the cache totals the workers report, as tests/test_torch_fleet_serve.py
  starts them.

No case asserts an entry's age or a publish count under a clock."""

import json
import os
import subprocess
import sys

import pytest

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch import store as store_mod
from torchsnapshot_tpu_torch.__main__ import _human, main as cli_main
from torchsnapshot_tpu_torch.telemetry import fleet, metrics
from torchsnapshot_tpu_torch.telemetry import monitor as tmonitor

from test_torch_fleet import _publish_one
from test_torch_fleet_serve import _WORKER, clean_telemetry  # noqa: F401  autouse fixture
from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures
from torch_peer_env import arrays, state

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Read at call time: an entry's age, the view's time, a suspect's last beacon.
CALL_TIME_KEYS = ("age_s", "time", "last_seen_s")


def _run(argv, capsys):
    capsys.readouterr()
    rc = cli_main(argv)
    return rc, capsys.readouterr().out


def without_call_time(obj):
    if isinstance(obj, dict):
        return {k: without_call_time(v) for k, v in obj.items() if k not in CALL_TIME_KEYS}
    if isinstance(obj, list):
        return [without_call_time(v) for v in obj]
    return obj


def test_top_json_one_shot(tmp_path, capsys):
    spool = str(tmp_path / "live")
    _publish_one(spool)
    rc, out = _run(["top", spool, "--json"], capsys)
    assert rc == 0
    view = json.loads(out)
    assert view["n_entries"] == 1
    assert view["workers"][0]["kind"] == "restore"
    assert "store" not in view
    want = fleet.aggregate(fleet.collect(spool, sweep=False))
    assert without_call_time(view) == without_call_time(json.loads(json.dumps(want)))
    # The spool named by the knob, and a root holding telemetry/live.
    with knobs.override_fleet_telemetry(spool):
        assert json.loads(_run(["top", "--json"], capsys)[1])["n_entries"] == 1
    root = tmp_path / "root"
    os.makedirs(root / fleet.SPOOL_DIRNAME)
    _publish_one(str(root / fleet.SPOOL_DIRNAME), kind="take")
    assert json.loads(_run(["top", str(root), "--json"], capsys)[1])["workers"][0]["kind"] == "take"


def test_top_table_once_and_missing_spool(tmp_path, capsys):
    spool = str(tmp_path / "live")
    _publish_one(spool, kind="take")
    rc, out = _run(["top", spool, "--once", "--stale", "600"], capsys)
    assert rc == 0
    assert "tpusnap top" in out and "take" in out
    view = fleet.aggregate(fleet.collect(spool, stale_s=600, sweep=False))
    assert out.splitlines()[1:] == fleet.render(view, spool).splitlines()[1:]  # the first line holds the time
    rc, out = _run(["top", str(tmp_path / "nope")], capsys)
    assert rc == 2 and out.startswith("no fleet telemetry spool found")
    assert _run(["top"], capsys)[0] == 2  # no knob set either


def test_top_prometheus_merges_worker_registries(tmp_path, capsys):
    """Entries embedding metrics dumps render as one exposition with
    per-worker labels plus the fleet gauges."""
    spool = str(tmp_path / "live")
    with knobs.override_metrics(True):
        metrics.reset()
        metrics.counter("tpusnap_test_total", "t").inc(3, backend="fs")
        _publish_one(spool)
        metrics.reset()
    rc, out = _run(["top", spool, "--prometheus"], capsys)
    assert rc == 0
    assert "tpusnap_fleet_workers 1" in out
    assert "tpusnap_test_total" in out
    assert 'worker="' in out
    assert "tpusnap_fleet_origin_bytes" in out
    assert out == fleet.render_prometheus(fleet.collect(spool, sweep=False))


def test_rollout_banner_through_top_once(tmp_path, capsys):
    """An in-flight rollout's wave document renders as the table's banner;
    the terminal fold clears it."""
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
            rc, out = _run(["top", spool, "--once", "--stale", "1e9"], capsys)
            assert rc == 0
            assert "ROLLOUT in flight" in out and "wave fleet" in out and "2/4 hosts" in out
            rc, out = _run(["top", spool, "--json", "--stale", "1e9"], capsys)
            assert json.loads(out)["rollout"]["wave"] == "fleet"
        finally:
            tmonitor.op_finished(mon, success=True)
        rc, out = _run(["top", spool, "--once", "--stale", "1e9"], capsys)
        assert rc == 0 and "ROLLOUT in flight" not in out


def test_top_reports_the_shared_store(tmp_path, capsys):
    """Under ``TPUSNAP_STORE`` the table is followed by the store's line and
    one line per tenant, and ``--json`` carries ``tenant_usage``."""
    S = str(tmp_path / "store")
    ts.SnapshotManager(str(tmp_path / "tenant"), store=S).save(0, state(arrays(leaves=2)))
    spool = str(tmp_path / "live")
    _publish_one(spool, kind="take")
    usage = store_mod.tenant_usage(S)
    (tid,) = usage["tenants"]
    with knobs.override_store(S):
        rc, out = _run(["top", spool, "--once", "--stale", "600"], capsys)
        assert rc == 0
        ratio = usage.get("dedup_ratio")
        tenant = usage["tenants"][tid]
        assert out.splitlines()[-2:] == [
            f"store {S}: {_human(usage['physical_bytes'])} physical / {_human(usage['logical_bytes'])} logical"
            + (f" (dedup {ratio}x)" if ratio else ""),
            f"  tenant {tid}: {_human(tenant['logical_bytes'])} logical, "
            f"{_human(tenant['exclusive_bytes'])} exclusive",
        ]
        rc, out = _run(["top", spool, "--json"], capsys)
        assert rc == 0 and json.loads(out)["store"] == json.loads(json.dumps(usage))
    assert "store" not in json.loads(_run(["top", spool, "--json"], capsys)[1])


def test_top_json_over_two_serving_workers(tmp_path, capsys):
    """Two port workers restore one snapshot through one cache and publish
    into one spool: ``top --json`` holds both processes, done, with the
    cache totals the workers report."""
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
    rc, out = _run(["top", snap_path, "--json", "--stale", "600"], capsys)
    assert rc == 0
    view = json.loads(out)
    assert view["n_processes"] == n, view
    assert {w["worker"].split(":")[1] for w in view["workers"]} == {str(p.pid) for p in procs}
    assert all(w["kind"] == "restore" and w["done"] for w in view["workers"])
    assert view["cache"]["hit_bytes"] == sum(d["hit_bytes"] for d in docs)
    assert view["cache"]["miss_bytes"] == sum(d["miss_bytes"] for d in docs)
    logical = sum(v.nbytes for v in arrs.values())
    assert view["cache"]["origin_bytes"] <= 1.25 * logical
    want = fleet.aggregate(fleet.collect(spool, stale_s=600, sweep=False))
    assert without_call_time(view) == without_call_time(json.loads(json.dumps(want)))
    rc, out = _run(["top", snap_path, "--once", "--stale", "600"], capsys)
    assert rc == 0 and all(str(p.pid) in out for p in procs)
