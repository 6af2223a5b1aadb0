"""The sampling profiler across the two packages: what crosses between
torchsnapshot_tpu and torchsnapshot_tpu_torch is the same.

- One synthetic sampler state through both packages' ``_meta_from_state``,
  ``build_document``, ``collapsed_lines``, ``diff_profiles`` and
  ``render_diff`` gives equal output (the calibrated per-tick cost, a
  measured time, is pinned to one value in both).
- A profile file that one package's profiled take writes validates and
  merges under the other package's ``validate_profile`` and
  ``merge_profile_files``, and both packages merge it the same way.
- ``thread_phases()``, ``current_phase()`` and ``attributed_wall_s()`` agree
  for the same nesting of ``timed``, ``tagged`` and driver scopes.

Knobs are set through ``knobs.override_*``."""

import threading

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jax_pkg
import torchsnapshot_tpu_torch as port_pkg
from torchsnapshot_tpu import phase_stats as jax_phase_stats
from torchsnapshot_tpu.telemetry import monitor as jax_monitor
from torchsnapshot_tpu.telemetry import profiler as jax_profiler
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch import phase_stats as port_phase_stats
from torchsnapshot_tpu_torch.telemetry import monitor as port_monitor
from torchsnapshot_tpu_torch.telemetry import profiler as port_profiler

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

PROFILER = {"jax": jax_profiler, "port": port_profiler}
PHASE_STATS = {"jax": jax_phase_stats, "port": port_phase_stats}
PKG = {"jax": jax_pkg, "port": port_pkg}

# A sampler's counters after a few ticks (Sampler.snapshot_state's shape,
# with the delta's duration).
STATE_A = {
    "stacks": {
        ("checksum", "on"): {"snapshot.take;scheduler.stage;integrity.digest": 7, "snapshot.take;x.loop": 2},
        ("checksum", "off"): {"snapshot.take;threading.wait": 3},
        ("fs_write", "off"): {"threading._bootstrap;fs._blocking_write": 5},
        ("<untagged>", "on"): {"threading._bootstrap;thread._worker": 1},
        ("take_drive", "on"): {"snapshot.take;base_events.run_until_complete": 4},
    },
    "ticks": 9,
    "samples_total": 22,
    "oncpu_samples": 14,
    "untagged_oncpu": 1,
    "duration_s": 0.123456789,
}
STATE_B = {
    "stacks": {
        ("checksum", "on"): {"snapshot.take;scheduler.stage;integrity.digest": 21},
        ("compress", "on"): {"snapshot.take;compression.encode": 6},
        ("fs_write", "off"): {"threading._bootstrap;fs._blocking_write": 5},
    },
    "ticks": 12,
    "samples_total": 32,
    "oncpu_samples": 27,
    "untagged_oncpu": 0,
    "duration_s": 0.2,
}


@pytest.fixture(autouse=True)
def _no_leaks():
    yield
    for pkg in ("jax", "port"):
        assert PROFILER[pkg]._OPS == [] and PROFILER[pkg]._SAMPLER is None, pkg
    assert jax_monitor._ACTIVE == [] and port_monitor._ACTIVE == []


@pytest.fixture
def pinned_tick_cost(monkeypatch):
    for mod in PROFILER.values():
        monkeypatch.setattr(mod, "_CAL_PER_TICK_S", 2.5e-5)


def _metas(pkg):
    mod = PROFILER[pkg]
    return (
        mod._meta_from_state("take", "ab" * 16, 0, 99.0, STATE_A, True),
        mod._meta_from_state("restore", "cd" * 16, 1, 99.0, STATE_B, False),
    )


_OUTPUTS = {
    "meta": lambda mod, a, b: (a, b),
    "build_document": lambda mod, a, b: (mod.build_document(a), mod.build_document(b)),
    "collapsed_lines": lambda mod, a, b: (mod.collapsed_lines(a), mod.collapsed_lines(b)),
    "diff": lambda mod, a, b: (mod.diff_profiles(a, b), mod.render_diff(mod.diff_profiles(a, b, top=2))),
}


@pytest.mark.parametrize("output", sorted(_OUTPUTS))
def test_documents_from_one_sampler_state_are_equal(pinned_tick_cost, output):
    got = {pkg: _OUTPUTS[output](PROFILER[pkg], *_metas(pkg)) for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    meta_a, _ = _metas("port")
    assert meta_a["calibration"] == {"per_tick_s": 2.5e-5, "ticks": 9, "estimated_s": 0.000225}
    assert meta_a["stacks"]["checksum"]["on"] == {
        "snapshot.take;scheduler.stage;integrity.digest": 7,
        "snapshot.take;x.loop": 2,
    }


def _state(pkg):
    if pkg == "port":
        return {"m": port_pkg.StateDict({"w": torch.ones(128, 128)})}
    return {"m": jax_pkg.StateDict({"w": np.ones((128, 128), np.float32)})}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_profile_file_of_one_package_validates_and_merges_under_the_other(tmp_path, pinned_tick_cost, writer):
    reader = "port" if writer == "jax" else "jax"
    prof = tmp_path / "prof"
    with knobs.override_profile_dir(str(prof)), knobs.override_profile_hz(499):
        PKG[writer].Snapshot.take(str(tmp_path / "snap"), _state(writer))
    (written,) = prof.glob("*" + PROFILER[writer].PROFILE_FILE_SUFFIX)
    assert written.name.startswith("take-")
    doc = PROFILER[reader].load_profile_file(str(written))
    assert PROFILER[reader].validate_profile(doc) == []
    assert doc["tpusnap"]["kind"] == "take" and doc["tpusnap"]["rank"] == 0
    # A file of the reader's own, merged with the writer's.
    own = PROFILER[reader].write_profile_files(
        PROFILER[reader]._meta_from_state("take", "ef" * 16, 1, 499.0, STATE_A, True), str(tmp_path / "own")
    )
    merged = {pkg: PROFILER[pkg].merge_profile_files([str(written), own]) for pkg in ("jax", "port")}
    assert merged["port"] == merged["jax"]
    assert PROFILER[reader].validate_profile(merged[reader]) == []
    meta = merged[reader]["tpusnap"]
    assert meta["samples_total"] == doc["tpusnap"]["samples_total"] + STATE_A["samples_total"]
    assert [m["rank"] for m in meta["merged_from"]] == [0, 1]


def _nesting_trace(ps):
    """Walk one nesting of driver, timed and tagged scopes, from this thread
    and a worker; returns (thread_phases of both threads, current_phase)
    at each step, threads named rather than by ident."""
    me = threading.get_ident()
    names = {me: "main"}
    steps = []

    def snap():
        phases = ps.thread_phases()
        steps.append(({names[i]: p for i, p in phases.items() if i in names}, ps.current_phase()))

    snap()
    ps.register_driver(me, "take_drive")
    snap()
    with ps.timed("d2h"):
        snap()
        with ps.tagged("checksum"):
            snap()
            inside, release = threading.Event(), threading.Event()

            def worker():
                names[threading.get_ident()] = "worker"
                with ps.tagged("compress"):
                    inside.set()
                    release.wait()

            t = threading.Thread(target=worker)
            t.start()
            inside.wait(5.0)
            snap()
            release.set()
            t.join(5.0)
        snap()
    ps.register_driver(me, "restore_drive")
    snap()
    remover = threading.Thread(target=ps.unregister_driver, args=(me, "take_drive"))
    remover.start()
    remover.join(5.0)
    snap()
    ps.unregister_driver(me, "restore_drive")
    ps.unregister_driver(me, "restore_drive")  # a second removal is a no-op
    snap()
    return steps


def _attributed_wall(ps, monkeypatch):
    """attributed_wall_s over intervals laid down at set stamps, in
    private tables (the process-wide ones are left as they are)."""
    for table in ("_stats", "_intervals", "_wall_base", "_retired_hwm"):
        monkeypatch.setattr(ps, table, {})
    ps.add("d2h", 1.0, 64, end=100.0)
    ps.add("checksum", 1.0, 64, end=100.5)
    ps.add("fs_write", 0.25, 64, end=103.0)
    with ps.tagged("serialize"):
        pass
    return ps.attributed_wall_s(), sorted(ps._stats)


@pytest.mark.parametrize("scope", ["nesting", "attributed_wall"])
def test_attribution_scope_agrees(monkeypatch, scope):
    if scope == "nesting":
        got = {pkg: _nesting_trace(PHASE_STATS[pkg]) for pkg in ("jax", "port")}
        assert got["port"][3] == ({"main": "checksum"}, "checksum")
        assert got["port"][4] == ({"main": "checksum", "worker": "compress"}, "checksum")
        assert got["port"][-1] == ({}, None)
    else:
        got = {pkg: _attributed_wall(PHASE_STATS[pkg], monkeypatch) for pkg in ("jax", "port")}
        assert got["port"] == (pytest.approx(1.75), ["checksum", "d2h", "fs_write"])
    assert got["port"] == got["jax"]
