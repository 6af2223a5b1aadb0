"""``python -m torchsnapshot_tpu_torch profile diff`` and ``analyze
--profile``, mirroring the CLI cases of tests/test_profiler.py: the golden
diff (a frame that triples, a frame that appears), invalid and empty input
for ``profile diff`` and ``analyze --profile``, and the CLI halves of the
profile gate and of traces and profiles in one directory (their library
halves are in tests/test_torch_analyze_profile.py).

No case asserts a sample count or a share under a clock (C.4 in
ROADMAP.md): the numbers checked come from profiles written from hand-made
metas, and the profiled take's files are checked for the report's keys."""

import json

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, knobs
from torchsnapshot_tpu_torch.__main__ import main as cli_main
from torchsnapshot_tpu_torch.telemetry import analyze, monitor, profiler

from test_torch_profiler import _synthetic_meta
from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures


@pytest.fixture(autouse=True)
def _no_leaks(no_leaked_threads):  # noqa: F811
    yield
    assert monitor._ACTIVE == [], "leaked op monitors"
    assert profiler._OPS == [], "leaked profiler ops"
    assert profiler._SAMPLER is None, "leaked shared sampler"


def _run(argv, capsys):
    capsys.readouterr()
    rc = cli_main(argv)
    return rc, capsys.readouterr().out


def _write(path, meta):
    path.write_text(json.dumps(profiler.build_document(meta)))
    return str(path)


def _golden(tmp_path):
    a = _write(tmp_path / "a.profile.json", _synthetic_meta(0, {"checksum": {"on": {"a;b;digest": 100}}}))
    b = _write(
        tmp_path / "b.profile.json",
        _synthetic_meta(0, {"checksum": {"on": {"a;b;digest": 300}}, "serialize": {"on": {"a;b;decode": 80}}}),
    )
    return a, b


def test_cli_profile_diff_golden(tmp_path, capsys):
    """The digest frame triples and a decode frame appears: the diff names
    digest as the top regression."""
    a, b = _golden(tmp_path)
    rc, out = _run(["profile", "diff", a, b], capsys)
    assert rc == 0
    assert out.startswith(f"profile diff: A={a}  B={b}\n")
    assert "top regressed" in out
    assert "digest" in out and "decode" in out
    rc, out = _run(["profile", "diff", a, b, "--json"], capsys)
    doc = json.loads(out)
    assert rc == 0
    # digest moved +2.0 s (200 samples at 10 ms): the largest regression.
    assert doc["top_regressed"][0]["frame"] == "digest"
    assert doc["top_regressed"][0]["delta_s"] == pytest.approx(2.0)
    assert doc["delta_oncpu_s"] == pytest.approx(2.8)
    assert not doc["top_improved"]
    metas = [profiler.load_profile_file(p)["tpusnap"] for p in (a, b)]
    assert doc == profiler.diff_profiles(*metas, top=10)
    rc, out = _run(["profile", "diff", a, b, "--json", "--top", "1"], capsys)
    assert rc == 0 and json.loads(out) == profiler.diff_profiles(*metas, top=1)
    assert len(json.loads(out)["top_regressed"]) == 1


def test_cli_profile_diff_garbage_exits_nonzero(tmp_path, capsys):
    good = _write(tmp_path / "good.profile.json", _synthetic_meta(0, {"d2h": {"on": {"x": 1}}}))
    garbage = tmp_path / "bad.profile.json"
    garbage.write_text("{not json")
    rc, out = _run(["profile", "diff", good, str(garbage)], capsys)
    assert rc == 1 and "invalid profile" in out
    empty = tmp_path / "empty"
    empty.mkdir()
    assert _run(["profile", "diff", str(empty), good], capsys) == (
        2,
        f"no *{profiler.PROFILE_FILE_SUFFIX} files under {empty}\n",
    )


def test_cli_profile_diff_merges_directories(tmp_path, capsys):
    """A directory argument merges its per-rank files first; a directory
    diffed with itself names no frame as gained or lost."""
    d = tmp_path / "prof"
    d.mkdir()
    metas = [
        _synthetic_meta(0, {"checksum": {"on": {"a;b;digest": 100}, "off": {"a;b;wait": 10}}}),
        _synthetic_meta(1, {"checksum": {"on": {"a;b;digest": 50}}, "fs_write": {"off": {"a;io": 7}}}),
    ]
    for meta in metas:
        _write(d / f"{meta['kind']}-{meta['op'][:8]}-rank{meta['rank']}{profiler.PROFILE_FILE_SUFFIX}", meta)
    a, _ = _golden(tmp_path)
    rc, out = _run(["profile", "diff", a, str(d), "--json"], capsys)
    assert rc == 0
    merged = profiler.merge_metas([doc["tpusnap"] for doc in profiler.load_profile_dir(str(d))])
    assert json.loads(out) == profiler.diff_profiles(profiler.load_profile_file(a)["tpusnap"], merged, top=10)
    rc, out = _run(["profile", "diff", str(d), str(d), "--json"], capsys)
    doc = json.loads(out)
    assert rc == 0 and doc["top_regressed"] == [] and doc["top_improved"] == []
    assert doc["delta_oncpu_s"] == 0


def test_cli_analyze_profile_garbage_exits_nonzero(tmp_path, capsys):
    (tmp_path / "x.profile.json").write_text("]]]")
    rc, out = _run(["analyze", str(tmp_path), "--profile"], capsys)
    assert rc == 1 and "invalid profile" in out
    empty = tmp_path / "empty"
    empty.mkdir()
    assert _run(["analyze", str(empty), "--profile"], capsys) == (
        2,
        f"no *.trace.json / *{profiler.PROFILE_FILE_SUFFIX} files under {empty}\n",
    )


def _state(mb=1):
    rng = np.random.RandomState(0)
    return {
        "m": StateDict({f"w{i}": torch.from_numpy(rng.rand((mb << 20) // 2 // 4).astype(np.float32)) for i in range(2)})
    }


def test_profile_gate_through_analyze(tmp_path, capsys):
    """A profiled take's directory holds only profiles: ``analyze
    --profile`` folds them into the report and exits 0."""
    prof_dir = tmp_path / "prof"
    with knobs.override_profile_dir(str(prof_dir)), knobs.override_profile_hz(499):
        Snapshot.take(str(tmp_path / "snap"), _state())
    docs = profiler.load_profile_dir(str(prof_dir))
    assert docs and all(profiler.validate_profile(doc) == [] for doc in docs)
    rc, out = _run(["analyze", str(prof_dir), "--profile"], capsys)
    assert rc == 0
    assert "dominant CPU sink" in out or "CPU:" in out
    assert out == analyze.render_profile(analyze.profile_report(docs)) + "\n"
    rc, out = _run(["analyze", str(prof_dir), "--profile", "--json"], capsys)
    report = json.loads(out)
    assert rc == 0
    assert report == {"ops": [], "profiles": analyze.profile_report(docs)["profiles"]}
    (prof,) = report["profiles"]
    assert prof["kind"] == "take"
    for info in prof["phases"].values():
        assert "group" in info and "cpu_s" in info
    assert prof["overhead"]["per_tick_s"] is not None


def test_profiles_and_traces_fold_into_one_report(tmp_path, capsys):
    shared = tmp_path / "telemetry"
    with knobs.override_trace_dir(str(shared)), knobs.override_profile_dir(str(shared)), knobs.override_profile_hz(
        499
    ):
        Snapshot.take(str(tmp_path / "snap"), _state())
    rc, out = _run(["analyze", str(shared), "--profile", "--json"], capsys)
    report = json.loads(out)
    assert rc == 0
    assert report["ops"] and report["ops"][0]["kind"] == "take"
    assert report["profiles"] and report["profiles"][0]["kind"] == "take"
    rc, out = _run(["analyze", str(shared), "--profile"], capsys)
    assert rc == 0
    trace_text = analyze.render(analyze.analyze_traces(analyze.load_trace_dir(str(shared))))
    profile_text = analyze.render_profile(analyze.profile_report(analyze.load_profile_dir(str(shared))))
    assert out == f"{trace_text}\n\n{profile_text}\n"
