"""The port's analyzer over profiles and the serving plane, mirroring the
library halves of tests/test_profiler.py's profile gate and its
traces-and-profiles-in-one-directory case, and tests/test_peer_trace.py's
slowest-peer report through ``peer_report`` and ``render_peer``.

The sampler's tick count depends on the host's scheduler (C.4 in
ROADMAP.md), so no case asserts a sample count under a clock: a profiled
take and restore give the files whose validity and report keys are checked,
and the report's numbers are checked on a profile written from a sampler
state made by hand.  The one duration checked is an injected peer delay's
lower bound."""

import json
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu.telemetry import analyze as jax_analyze
from torchsnapshot_tpu_torch import Snapshot, StateDict, knobs
from torchsnapshot_tpu_torch.telemetry import analyze, monitor, profiler

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures
from torch_peer_env import arrays, assert_equal, daemon, peer_env, state, warm_into, zeros  # noqa: F401


@pytest.fixture(autouse=True)
def _no_leaks(no_leaked_threads):  # noqa: F811
    yield
    assert monitor._ACTIVE == [], "leaked op monitors"
    assert profiler._OPS == [], "leaked profiler ops"
    assert profiler._SAMPLER is None, "leaked shared sampler"


def _state(mb=4):
    rng = np.random.RandomState(0)
    return {
        "m": StateDict({f"w{i}": torch.from_numpy(rng.rand((mb << 20) // 2 // 4).astype(np.float32)) for i in range(2)})
    }


def test_profile_gate_folds_a_profiled_take_into_the_report(tmp_path):
    prof_dir = tmp_path / "prof"
    with knobs.override_profile_dir(str(prof_dir)), knobs.override_profile_hz(499):
        Snapshot.take(str(tmp_path / "snap"), _state())
    docs = analyze.load_profile_dir(str(prof_dir))
    assert docs, "profiled take wrote no profile files"
    for doc in docs:
        assert profiler.validate_profile(doc) == []
    report = analyze.profile_report(docs)
    (prof,) = report["profiles"]
    assert prof["kind"] == "take" and prof["ranks"] == [0] and prof["hz"] == 499.0
    for info in prof["phases"].values():
        assert "group" in info and "cpu_s" in info
    # The calibrated self-overhead rides every profile.
    assert prof["overhead"]["per_tick_s"] is not None
    assert "CPU:" in analyze.render_profile(report)
    assert report == jax_analyze.profile_report(docs)
    # A directory holding no profile gives an empty report.
    assert analyze.profile_report(analyze.load_profile_dir(str(tmp_path))) == {"profiles": []}
    assert "no profiles found" in analyze.render_profile({"profiles": []})
    (prof_dir / "bad.profile.json").write_text("]]]")
    with pytest.raises(ValueError, match="unreadable profile"):
        analyze.load_profile_dir(str(prof_dir))


def test_profile_report_numbers_from_a_hand_made_sampler_state(tmp_path, monkeypatch):
    monkeypatch.setattr(profiler, "_CAL_PER_TICK_S", 2.5e-5)
    state_by_rank = {
        0: {
            ("checksum", "on"): {"snapshot.take;scheduler.stage;integrity.digest": 40, "snapshot.take;x.loop": 10},
            ("pinned_alloc", "on"): {"snapshot.take;staging.pinned_empty": 20},
            ("native_write_hash", "off"): {"threading._bootstrap;fs._blocking_write": 25},
            ("<untagged>", "on"): {"threading._bootstrap;thread._worker": 5},
            ("take_drive", "on"): {"snapshot.take;base_events.run_until_complete": 5},
        },
        1: {
            ("checksum", "on"): {"snapshot.take;scheduler.stage;integrity.digest": 30},
            ("native_write_hash", "off"): {"threading._bootstrap;fs._blocking_write": 10},
        },
    }
    for rank, stacks in state_by_rank.items():
        samples = sum(sum(b.values()) for b in stacks.values())
        oncpu = sum(sum(b.values()) for (_, st), b in stacks.items() if st == "on")
        untagged = sum(sum(b.values()) for (p, st), b in stacks.items() if p == "<untagged>" and st == "on")
        sampler_state = {
            "stacks": stacks,
            "ticks": 50,
            "samples_total": samples,
            "oncpu_samples": oncpu,
            "untagged_oncpu": untagged,
            "duration_s": 0.5,
        }
        meta = profiler._meta_from_state("take", "ab" * 16, rank, 100.0, sampler_state, True)
        profiler.write_profile_files(meta, str(tmp_path))
    docs = analyze.load_profile_dir(str(tmp_path))
    report = analyze.profile_report(docs)
    (prof,) = report["profiles"]
    assert prof["ranks"] == [0, 1] and prof["samples_total"] == 145
    assert prof["oncpu_s"] == pytest.approx(1.1) and prof["offcpu_s"] == pytest.approx(0.35)
    assert prof["untagged_oncpu_share"] == pytest.approx(5 / 110, abs=1e-4)
    assert prof["dominant_cpu_sink"] == {"phase": "checksum", "frame": "integrity.digest", "cpu_s": 0.8}
    assert prof["phases"]["checksum"]["hottest"][0] == {"frame": "integrity.digest", "cpu_s": 0.7}
    assert prof["groups_cpu_s"] == {"d2h": 0.2, "driver": 0.05, "other": 0.05, "serialize": 0.8, "storage_io": 0.0}
    assert prof["overhead"] == {"per_tick_s": 2.5e-5, "estimated_s": 0.0025}
    out = analyze.render_profile(report)
    assert "dominant CPU sink: checksum / integrity.digest (0.80s)" in out
    # The JAX table puts the port's pinned_alloc in "other"; all else agrees.
    jax_report = jax_analyze.profile_report(docs)
    (jax_prof,) = jax_report["profiles"]
    assert jax_prof["phases"]["pinned_alloc"]["group"] == "other"
    assert jax_prof["groups_cpu_s"] == {"driver": 0.05, "other": 0.25, "serialize": 0.8, "storage_io": 0.0}
    jax_prof["phases"]["pinned_alloc"]["group"] = "d2h"
    jax_prof["groups_cpu_s"] = prof["groups_cpu_s"]
    assert jax_report == report


def test_profiles_and_traces_fold_into_one_report(tmp_path):
    """The profile and trace directories pointed at one directory: the
    trace report and the profile report each read their own files."""
    shared = tmp_path / "telemetry"
    with knobs.override_trace_dir(str(shared)), knobs.override_profile_dir(str(shared)), knobs.override_profile_hz(
        499
    ):
        snap = Snapshot.take(str(tmp_path / "snap"), _state(mb=1))
        dst = {"m": StateDict({k: torch.zeros_like(v) for k, v in _state(mb=1)["m"].items()})}
        snap.restore(dst)
    assert all(torch.equal(dst["m"][k], v) for k, v in _state(mb=1)["m"].items())
    analysis = analyze.analyze_traces(analyze.load_trace_dir(str(shared)))
    assert sorted(op["kind"] for op in analysis["ops"]) == ["restore", "take"]
    report = analyze.profile_report(analyze.load_profile_dir(str(shared)))
    assert sorted(p["kind"] for p in report["profiles"]) == ["restore", "take"]
    by_kind = {op["kind"]: op for op in analysis["ops"]}
    assert by_kind["take"]["groups"].get("storage_io", 0) > 0
    text = analyze.render(analysis)
    assert "take " in text and "restore " in text
    assert sorted(os.listdir(shared)) == sorted(
        [d["_file"] for d in analyze.load_trace_dir(str(shared))]
        + [d["_file"] for d in analyze.load_profile_dir(str(shared))]
        + [
            d["_file"].replace(profiler.PROFILE_FILE_SUFFIX, profiler.COLLAPSED_FILE_SUFFIX)
            for d in analyze.load_profile_dir(str(shared))
        ]
    )


def test_peer_report_names_slowest_peer(peer_env):
    tmp_path = peer_env
    arrs = arrays(leaves=2)
    snap_path = str(tmp_path / "root" / "step_1")
    with knobs.override_cas(True):
        snap = Snapshot.take(snap_path, state(arrs))
    warm_into(snap_path, snap.metadata, str(tmp_path / "cacheA"))
    trace_dir = str(tmp_path / "traces")
    with daemon(str(tmp_path / "cacheA")) as d:
        slow_addr = d.addr
        with knobs.override_trace_dir(trace_dir), knobs.override_cache_dir(
            str(tmp_path / "cacheB")
        ), knobs.override_peer_fetch(True), knobs.override_faults("peer:1:peer_slow:0.1"), knobs.override_peer_timeout_s(
            5.0
        ):
            dst = zeros(arrs)
            snap.restore(dst)
    assert_equal(dst, arrs)
    docs = analyze.load_trace_dir(trace_dir)
    report = analyze.peer_report(docs)
    assert report["slowest_peer"] == slow_addr
    row = report["peers"][slow_addr]
    assert row["fetches"] > 0
    assert row["p99_s"] >= 0.09  # the injected delay dominates
    assert row["hit_rate"] > 0
    assert row["ttfb_mean_s"] + row["transfer_mean_s"] > 0
    rendered = analyze.render_peer(report)
    assert slow_addr in rendered and "slowest peer" in rendered
    assert report == jax_analyze.peer_report(docs)
    assert rendered == jax_analyze.render_peer(report)
    assert "no peer_fetch spans" in analyze.render_peer(analyze.peer_report([]))
    json.dumps(report)  # the report is plain JSON
