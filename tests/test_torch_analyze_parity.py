"""The bottleneck analyzer across the two packages: each package's analyzer
reads the trace directory, the profile directory and the sidecars of a CPU
take and restore made by either package.

- Over the JAX package's files the two reports are equal outright.
- Over the port's files they are equal except where the port records a
  phase the JAX package does not have: its wall lies in its group in the
  port's report and in ``other`` in the JAX package's, and the group sums,
  verdicts and dominant phases follow from that.  One case asserts exactly
  that difference on a take whose native write batches
  (``native_write_batch``, ``native_write_batched``) only the port
  records.

Knobs are set through ``knobs.override_*``; each package reads the same
``TPUSNAP_*`` variables."""

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jax_pkg
import torchsnapshot_tpu_torch as port_pkg
from torchsnapshot_tpu.telemetry import analyze as jax_analyze
from torchsnapshot_tpu.telemetry import monitor as jax_monitor
from torchsnapshot_tpu.telemetry import profiler as jax_profiler
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.telemetry import analyze as port_analyze
from torchsnapshot_tpu_torch.telemetry import monitor as port_monitor
from torchsnapshot_tpu_torch.telemetry import profiler as port_profiler

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

ANALYZE = {"jax": jax_analyze, "port": port_analyze}


@pytest.fixture(autouse=True)
def _no_leaks():
    yield
    for mod in (jax_profiler, port_profiler):
        assert mod._OPS == [] and mod._SAMPLER is None
    assert jax_monitor._ACTIVE == [] and port_monitor._ACTIVE == []


def _arrays():
    return {f"w{i}": np.random.RandomState(i).rand(1 << 14).astype(np.float32) for i in range(4)}


def _take_and_restore(writer, tmp_path):
    """A traced, profiled take and restore by ``writer``: returns the
    trace directory, the profile directory and the snapshot's path.  The
    port writes through its native batches (``native_write_batch``)."""
    arrs = _arrays()
    trace_dir, prof_dir, snap_path = (str(tmp_path / n) for n in ("traces", "prof", "snap"))
    with knobs.override_trace_dir(trace_dir), knobs.override_profile_dir(prof_dir), knobs.override_profile_hz(499):
        if writer == "jax":
            snap = jax_pkg.Snapshot.take(snap_path, {"m": jax_pkg.StateDict(dict(arrs))})
            dst = {"m": jax_pkg.StateDict({k: np.zeros_like(v) for k, v in arrs.items()})}
            snap.restore(dst)
            got = {k: np.asarray(v) for k, v in dst["m"].items()}
        else:
            with knobs.override_batching_disabled(True), knobs.override_native_batch(8):
                state = {"m": port_pkg.StateDict({k: torch.from_numpy(v.copy()) for k, v in arrs.items()})}
                snap = port_pkg.Snapshot.take(snap_path, state)
            dst = {"m": port_pkg.StateDict({k: torch.zeros(v.shape) for k, v in arrs.items()})}
            snap.restore(dst)
            got = {k: v.numpy() for k, v in dst["m"].items()}
    for k, v in arrs.items():
        assert got[k].tobytes() == v.tobytes(), k
    return trace_dir, prof_dir, snap_path


def _reports(mod, trace_dir, prof_dir, snap_path):
    sidecars = mod.load_sidecars(snap_path)
    traces = mod.analyze_traces(mod.load_trace_dir(trace_dir), sidecars)
    profiles = mod.profile_report(mod.load_profile_dir(prof_dir))
    return {"traces": traces, "profiles": profiles, "barrier": mod.barrier_blame(sidecars), "sidecars": sidecars}


def _as_the_jax_package_classifies(reports):
    """The port's reports with each phase put in the JAX package's group
    and everything that follows from the groups recomputed the JAX
    package's way (the sums run in the same order, so they are equal)."""
    traces = reports["traces"]
    for op in traces["ops"]:
        group_walls = {}
        for name, info in op["phases"].items():
            info["group"] = jax_analyze.classify_phase(name)
            group_walls[info["group"]] = group_walls.get(info["group"], 0.0) + info["wall_s"]
        durations = sorted(op["duration_s"]["by_rank"].values())
        op["groups"] = {g: round(w, 6) for g, w in sorted(group_walls.items())}
        op["limiting_resource"] = jax_analyze._classify_limiting(group_walls, sum(durations) / len(durations))
        work = {n: i for n, i in op["phases"].items() if i["group"] not in jax_analyze.WAIT_GROUPS}
        op["dominant_phase"] = max(work, key=lambda n: work[n]["wall_s"]) if work else None
    for prof in reports["profiles"]["profiles"]:
        group_cpu = {}
        for name, info in prof["phases"].items():
            info["group"] = jax_analyze.classify_phase(name)
            group_cpu[info["group"]] = group_cpu.get(info["group"], 0.0) + info["cpu_s"]
        prof["groups_cpu_s"] = {g: round(s, 4) for g, s in sorted(group_cpu.items())}
    return reports


def _reclassified(port_reports):
    """(phase, the port's group) of each phase the JAX package classifies
    otherwise, in the trace and the profile reports."""
    found = set()
    for op in port_reports["traces"]["ops"]:
        found |= {(n, i["group"]) for n, i in op["phases"].items() if jax_analyze.classify_phase(n) != i["group"]}
    for prof in port_reports["profiles"]["profiles"]:
        found |= {(n, i["group"]) for n, i in prof["phases"].items() if jax_analyze.classify_phase(n) != i["group"]}
    return found


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_both_analyzers_read_each_packages_files_alike(tmp_path, writer):
    dirs = _take_and_restore(writer, tmp_path)
    reports = {pkg: _reports(mod, *dirs) for pkg, mod in ANALYZE.items()}
    ops = reports["port"]["traces"]["ops"]
    assert sorted(op["kind"] for op in ops) == ["restore", "take"]
    assert all(op["sidecars"] for op in ops), "the sidecars did not join their ops"
    assert sorted(p["kind"] for p in reports["port"]["profiles"]["profiles"]) == ["restore", "take"]
    assert reports["port"]["sidecars"] == reports["jax"]["sidecars"]
    assert reports["port"]["barrier"] == reports["jax"]["barrier"] == []  # one rank: no barrier table
    if writer == "jax":
        assert _reclassified(reports["port"]) == set()
        assert reports["port"] == reports["jax"]
    else:
        assert reports["jax"] == _as_the_jax_package_classifies(reports["port"])
    for pkg, mod in ANALYZE.items():
        assert mod.render(reports[pkg]["traces"]).count(" rank(s), p50 ") == 2


def test_a_port_only_phase_lies_in_its_group_here_and_in_other_there(tmp_path):
    dirs = _take_and_restore("port", tmp_path)
    reports = {pkg: _reports(mod, *dirs) for pkg, mod in ANALYZE.items()}
    take = {pkg: next(op for op in r["traces"]["ops"] if op["kind"] == "take") for pkg, r in reports.items()}
    # Exactly the native batch phases differ (the batch call and its
    # members' waits), and only in their group.
    batch = {"native_write_batch", "native_write_batched"}
    moved = {n for n, i in take["port"]["phases"].items() if i["group"] != take["jax"]["phases"][n]["group"]}
    assert moved == batch
    for name in batch:
        assert take["port"]["phases"][name]["group"] == "storage_io"
        assert take["jax"]["phases"][name]["group"] == "other"
    for name in take["port"]["phases"]:
        port_info, jax_info = take["port"]["phases"][name], take["jax"]["phases"][name]
        assert {k: v for k, v in port_info.items() if k != "group"} == {
            k: v for k, v in jax_info.items() if k != "group"
        }
    walls = [take["port"]["phases"][name]["wall_s"] for name in sorted(batch)]
    assert min(walls) > 0
    assert take["jax"]["groups"]["other"] == round(sum(walls), 6)
    assert "other" not in take["port"]["groups"]
    assert take["port"]["groups"]["storage_io"] == pytest.approx(
        take["jax"]["groups"]["storage_io"] + sum(walls), abs=3e-6
    )
    # Everything outside the phase table and its group sums is equal.
    skip = ("phases", "groups", "limiting_resource", "dominant_phase")
    assert {k: v for k, v in take["port"].items() if k not in skip} == {
        k: v for k, v in take["jax"].items() if k not in skip
    }
    # The restore records no port-only phase: equal outright.
    restores = [next(op for op in r["traces"]["ops"] if op["kind"] == "restore") for r in reports.values()]
    assert restores[0] == restores[1]
    assert _reclassified(reports["port"]) <= {(n, port_analyze.classify_phase(n)) for n in port_only_phases()}


def port_only_phases():
    """The phases the port classifies and the JAX package leaves in
    ``other``."""
    return {
        name
        for members in port_analyze.PHASE_GROUPS.values()
        for name in members
        if jax_analyze.classify_phase(name) == "other"
    }


def test_the_port_only_phases_are_the_ports_own():
    only = port_only_phases()
    assert {"pinned_alloc", "stage_alloc", "native_write_batch", "native_write_batched", "pg_wait"} <= only
    for name in only:
        assert port_analyze.classify_phase(name) != "other"
    # Every other name classifies the same in both packages.
    for members in jax_analyze.PHASE_GROUPS.values():
        for name in members:
            assert port_analyze.classify_phase(name) == jax_analyze.classify_phase(name)
