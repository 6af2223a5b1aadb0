"""The telemetry verbs of the two CLIs as one contract: over the same files,
``python -m torchsnapshot_tpu_torch`` ``trace``, ``analyze``, ``profile
diff`` and ``top`` print what ``python -m torchsnapshot_tpu`` prints and
return the same exit codes, whichever package wrote the files.

Each package writes a traced and profiled take and restore that publish
into a fleet spool, and a two-rank async take whose sidecars carry the
commit barrier's arrival table (the port's ranks are gloo processes of
tests/test_torch_monitor_dist.py, the JAX package's forks of its
test_utils).  Both CLIs then read each writer's files: ``trace`` (plain,
``--out`` and ``--fleet``), ``analyze`` (text, ``--json`` with the
sidecars, ``--peer``, ``--profile``, ``--barrier``), ``profile diff``
(file against file, directory against itself) and ``top`` (``--json``,
``--prometheus``, ``--once``, last since its table sweeps).  The one
difference allowed is what is read at call time: an entry's ``age_s``, the
view's ``time``, a suspect's ``last_seen_s`` and the table's clock.  Over
the port's files the JAX CLI classifies phases with the port's table: the
phases only the port records (``pg_wait`` before the commit barrier) sit
in ``other`` in the JAX table, as tests/test_torch_analyze_parity.py
holds."""

import glob
import os
import re

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jax_pkg
import torchsnapshot_tpu_torch as port_pkg
from torchsnapshot_tpu.__main__ import main as jax_main
from torchsnapshot_tpu.telemetry import analyze as jax_analyze
from torchsnapshot_tpu.telemetry import fleet as jax_fleet
from torchsnapshot_tpu.test_utils import make_test_pg as jax_make_test_pg
from torchsnapshot_tpu.test_utils import run_with_procs as jax_run_with_procs
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.__main__ import main as port_main
from torchsnapshot_tpu_torch.telemetry import analyze as port_analyze
from torchsnapshot_tpu_torch.telemetry import fleet as port_fleet
from torchsnapshot_tpu_torch.telemetry import monitor as port_monitor
from torchsnapshot_tpu_torch.telemetry import profiler as port_profiler

from test_torch_monitor_dist import barrier_snapshot_2
from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

_CALL_TIME_JSON = re.compile(r'("(?:age_s|time|last_seen_s)": )-?[0-9.e+-]+')
_TABLE_CLOCK = re.compile(r" — \d\d:\d\d:\d\d — ")
_LAST_SEEN = re.compile(r"last seen \d+s ago")


@pytest.fixture(autouse=True)
def _clean():
    for mod in (jax_fleet, port_fleet):
        mod.reset_process_totals()
    yield
    assert port_monitor._ACTIVE == [] and port_profiler._OPS == [] and port_profiler._SAMPLER is None


def _arrays():
    rng = np.random.default_rng(25)
    return {f"w{i}": rng.standard_normal(1 << 14).astype(np.float32) for i in range(3)}


@jax_run_with_procs(nproc=2)
def _jax_barrier_snapshot_2():
    pg = jax_make_test_pg()
    state = {"m": jax_pkg.StateDict({"w": np.full((8,), float(pg.get_rank()), np.float32)})}
    jax_pkg.Snapshot.async_take(os.environ["TPUSNAP_TEST_SNAPSHOT"], state, pg=pg).wait()


def _write_all(writer, base, monkeypatch):
    """The files both CLIs read, written by ``writer``; returns their paths."""
    p = {k: os.path.join(base, k) for k in ("traces", "prof", "spool", "snap", "barrier")}
    arrs = _arrays()
    with knobs.override_trace_dir(p["traces"]), knobs.override_profile_dir(p["prof"]), knobs.override_profile_hz(
        499
    ), knobs.override_fleet_telemetry(p["spool"]):
        if writer == "port":
            snap = port_pkg.Snapshot.take(p["snap"], {"m": port_pkg.StateDict(
                {k: torch.from_numpy(v.copy()) for k, v in arrs.items()})})
            dst = {"m": port_pkg.StateDict({k: torch.zeros(v.shape) for k, v in arrs.items()})}
            snap.restore(dst)
            got = {k: v.numpy() for k, v in dst["m"].items()}
        else:
            snap = jax_pkg.Snapshot.take(p["snap"], {"m": jax_pkg.StateDict(dict(arrs))})
            dst = {"m": jax_pkg.StateDict({k: np.zeros_like(v) for k, v in arrs.items()})}
            snap.restore(dst)
            got = {k: np.asarray(v) for k, v in dst["m"].items()}
    assert all(got[k].tobytes() == v.tobytes() for k, v in arrs.items())
    monkeypatch.setenv("TPUSNAP_TEST_SNAPSHOT", p["barrier"])
    (barrier_snapshot_2 if writer == "port" else _jax_barrier_snapshot_2)()
    return p


def _commands(p, out_json):
    (take_prof,) = glob.glob(os.path.join(p["prof"], "take-*.profile.json"))
    (restore_prof,) = glob.glob(os.path.join(p["prof"], "restore-*.profile.json"))
    return [
        ["trace", p["traces"]],
        ["trace", p["traces"], "--out", out_json],
        ["trace", p["traces"], "--fleet", "--spool", p["spool"]],
        ["analyze", p["traces"]],
        ["analyze", p["traces"], "--snapshot", p["snap"], "--json"],
        ["analyze", p["traces"], "--peer"],
        ["analyze", p["traces"], "--peer", "--json"],
        ["analyze", p["prof"], "--profile"],
        ["analyze", p["prof"], "--profile", "--json"],
        ["analyze", p["barrier"], "--barrier"],
        ["analyze", p["barrier"], "--barrier", "--json"],
        ["profile", "diff", take_prof, restore_prof],
        ["profile", "diff", take_prof, restore_prof, "--json", "--top", "3"],
        ["profile", "diff", p["prof"], p["prof"]],
        ["top", p["spool"], "--json", "--stale", "1e9"],
        ["top", p["spool"], "--prometheus", "--stale", "1e9"],
        ["top", p["spool"], "--once", "--stale", "1e9"],
    ]


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr().out
    out = _CALL_TIME_JSON.sub(r"\1_", out)
    out = _TABLE_CLOCK.sub(" — _ — ", out)
    return rc, _LAST_SEEN.sub("last seen _ ago", out)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_both_clis_print_the_telemetry_alike(tmp_path, capsys, monkeypatch, writer):
    p = _write_all(writer, str(tmp_path), monkeypatch)
    if writer == "port":
        # Phases only the port records (its process-group wait ``pg_wait``
        # before the commit barrier, among others) sit in ``other`` in the
        # JAX table (tests/test_torch_analyze_parity.py): the JAX CLI reads
        # the port's files with the port's table.
        assert (jax_analyze.classify_phase("pg_wait"), port_analyze.classify_phase("pg_wait")) == ("other", "barrier")
        monkeypatch.setattr(jax_analyze, "classify_phase", port_analyze.classify_phase)
    differ, codes = [], {}
    for argv in _commands(p, str(tmp_path / "merged.json")):
        jax_res = _run(jax_main, argv, capsys)
        port_res = _run(port_main, argv, capsys)
        codes[" ".join(argv[:1] + [a for a in argv[1:] if a.startswith("--")])] = port_res[0]
        if jax_res != port_res:
            differ.append((argv, jax_res, port_res))
    assert differ == []
    # The reads covered what they should: both ops, both barrier ranks, no
    # peer spans, every entry of the spool.
    assert codes["analyze --peer"] == 2
    assert all(rc == 0 for cmd, rc in codes.items() if not cmd.startswith("analyze --peer"))
    rc, out = _run(port_main, ["trace", p["traces"]], capsys)
    assert "merged 2 trace file(s): 1x restore, 1x take" in out
    assert "rank 1" in _run(port_main, ["analyze", p["barrier"], "--barrier"], capsys)[1]
    assert '"n_entries": 2' in _run(port_main, ["top", p["spool"], "--json", "--stale", "1e9"], capsys)[1]


@pytest.mark.parametrize(
    "argv, rc",
    [
        (["trace", "{empty}"], 2),
        (["trace", "{bad}"], 1),
        (["trace", "{bad}", "--fleet"], 1),
        (["analyze", "{empty}"], 2),
        (["analyze", "{empty}", "--profile"], 2),
        (["analyze", "{bad}"], 1),
        (["analyze", "{bad}", "--profile"], 1),
        (["analyze", "{empty}", "--barrier"], 2),
        (["profile", "diff", "{empty}", "{empty}"], 2),
        (["profile", "diff", "{bad}/x.profile.json", "{bad}/x.profile.json"], 1),
        (["top", "{empty}/absent"], 2),
    ],
)
def test_both_clis_refuse_alike(tmp_path, capsys, argv, rc):
    empty, bad = tmp_path / "empty", tmp_path / "bad"
    empty.mkdir()
    bad.mkdir()
    (bad / "x.trace.json").write_text('{"traceEvents": "nope"}')
    (bad / "x.profile.json").write_text("]]]")
    argv = [a.format(empty=empty, bad=bad) for a in argv]
    assert _run(port_main, argv, capsys) == _run(jax_main, argv, capsys)
    assert _run(port_main, argv, capsys)[0] == rc
