"""The port CLI over the storage tiers: the CLI halves of the JAX package's
storage tests, driven through ``main(argv)``.

- ``cp`` (tests/test_replication.py::test_cli_cp), ``verify`` of a zlib
  snapshot and ``info``'s compression line (test_integrity.py,
  test_compression.py), ``verify`` and ``info`` of casx sub-chunk
  references (test_cdc.py), ``verify`` naming a missing shared slab chunk
  once with both referrers, and ``stats``/``history`` rendering dedup
  (test_cas.py).
- ``stats`` of sidecars (test_telemetry.py), ``history`` of a regression
  and of an empty root (test_analyze.py).
- The shared store's lines: ``info``'s and ``steps``' ``store:`` line,
  ``stats``' tenant lines from ``store.tenant_usage``, and the dry-run
  ``gc``'s counts from ``store.chunk_classification``."""

import json
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, cas, knobs
from torchsnapshot_tpu_torch import store as store_mod
from torchsnapshot_tpu_torch.__main__ import _human, main
from torchsnapshot_tpu_torch.manager import SnapshotManager
from torchsnapshot_tpu_torch.manifest import CDC_MANIFEST_VERSION
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
from torchsnapshot_tpu_torch.telemetry import history, metrics

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

FROZEN = np.random.RandomState(0).rand(65536).astype(np.float32)


def _app(step=11):
    rng = np.random.default_rng(7)
    return {
        "m": StateDict(
            {
                "w": torch.from_numpy(rng.standard_normal((500, 200)).astype(np.float32)),
                "b": torch.from_numpy(rng.standard_normal(64).astype(np.float32)),
                "step": step,
            }
        )
    }


def _cas_state(v):
    return {"m": StateDict({"frozen": torch.from_numpy(FROZEN.copy()), "opt": torch.full((4096,), float(v))})}


def _restore_equal(path, app):
    dst = {"m": StateDict({k: torch.zeros_like(v) if torch.is_tensor(v) else 0 for k, v in app["m"].items()})}
    Snapshot(path).restore(dst)
    for k, v in app["m"].items():
        assert torch.equal(dst["m"][k], v) if torch.is_tensor(v) else dst["m"][k] == v, k


def test_cli_cp(tmp_path, capsys):
    app = _app()
    src = str(tmp_path / "src")
    Snapshot.take(src, app)
    dst = str(tmp_path / "cli_dst")
    assert main(["cp", src, dst, "--verify"]) == 0
    assert capsys.readouterr().out == f"copied {src} -> {dst} (verified)\n"
    _restore_equal(dst, app)
    # and the copied snapshot passes the CLI's own audit
    assert main(["verify", dst]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "verified 2 payloads, 0 corrupt, 0 unreadable"


def test_cli_cp_onto_a_committed_snapshot_needs_overwrite(tmp_path, capsys):
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    Snapshot.take(src, _app(11))
    Snapshot.take(dst, _app(12))
    with pytest.raises(RuntimeError, match="already holds a committed snapshot"):
        main(["cp", src, dst])
    _restore_equal(dst, _app(12))  # the refused copy left the destination as it was
    assert main(["cp", src, dst, "--overwrite", "--concurrency", "1"]) == 0
    assert capsys.readouterr().out == f"copied {src} -> {dst}\n"
    _restore_equal(dst, _app(11))


def test_verify_cli_audits_compressed_payloads(tmp_path, capsys):
    """``verify`` audits compressed frames without decompressing (digests
    cover stored bytes) and reports the codec and ratio."""
    with knobs.override_compression("zlib"), knobs.override_compression_min_bytes(0):
        Snapshot.take(str(tmp_path / "snap"), {"m": StateDict({"w": torch.zeros((128, 128))})})
    assert main(["verify", str(tmp_path / "snap")]) == 0
    out = capsys.readouterr().out
    assert "0 corrupt" in out
    assert "compression: zlib" in out


def test_cli_info_reports_compression(tmp_path, capsys):
    with knobs.override_compression("zlib"), knobs.override_compression_min_bytes(0):
        Snapshot.take(str(tmp_path / "snap"), {"m": StateDict({"w": torch.zeros((256, 256))})})
    assert main(["info", str(tmp_path / "snap")]) == 0
    out = capsys.readouterr().out
    assert "compression: zlib" in out
    assert "ratio" in out
    assert "array bytes: 256.0KB" in out

    Snapshot.take(str(tmp_path / "raw_snap"), {"m": StateDict({"w": torch.zeros(64)})})
    assert main(["info", str(tmp_path / "raw_snap")]) == 0
    assert "compression: none" in capsys.readouterr().out


def test_take_restore_verify_casx(tmp_path, capsys):
    """Slab-packed small leaves and one big leaf under CDC produce casx
    references (manifest 0.6.0); ``verify`` and ``info`` resolve the
    sub-chunk form."""
    rs = np.random.RandomState(9)
    leaves = {f"l{i}": torch.from_numpy(np.frombuffer(rs.bytes(48 * 1024), np.uint8).copy()) for i in range(8)}
    leaves["big"] = torch.from_numpy(np.frombuffer(rs.bytes(256 * 1024), np.uint8).copy())
    path = str(tmp_path / "root" / "step_1")
    with knobs.override_cas(True), knobs.override_cdc(True), knobs.override_cdc_params(
        2048, 8192, 32768
    ), knobs.override_slab_size_threshold_bytes(1 << 20):
        md = Snapshot.take(path, {"m": StateDict(dict(leaves))}).metadata
    assert md.version == CDC_MANIFEST_VERSION
    assert any(cas.is_casx_location(getattr(e, "location", None)) for e in md.manifest.values())
    _restore_equal(path, {"m": leaves})
    assert main(["verify", path]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "verified 9 payloads, 0 corrupt, 0 unreadable"
    assert out[-2].startswith("cas:         ") and "within-step" in out[-2]
    assert main(["info", path]) == 0
    out = capsys.readouterr().out
    assert f"version:     {CDC_MANIFEST_VERSION}" in out and "cas:         " in out


def test_verify_reports_missing_shared_chunk_once_naming_referrers(tmp_path, capsys):
    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root)
    # Batching on, so several small payloads share one slab chunk.
    state = {
        "m": StateDict({"a": torch.arange(4096, dtype=torch.float32), "b": torch.arange(4096, dtype=torch.float32) + 1})
    }
    with knobs.override_cas(True):
        mgr.save(1, state)
    md = mgr.snapshot(1).metadata
    loc_a = md.manifest["0/m/a"].location
    assert cas.is_cas_location(loc_a)
    assert md.manifest["0/m/b"].location == loc_a, "expected a shared slab"
    os.unlink(os.path.join(root, cas.relpath_for_location(loc_a)))
    rc = main(["verify", f"{root}/step_1"])
    out = capsys.readouterr().out
    assert rc == 1
    assert out.count(f"UNREADABLE {loc_a}") == 1, out
    assert "0/m/a" in out and "0/m/b" in out


def test_history_and_stats_render_dedup(tmp_path, capsys):
    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root)
    with knobs.override_cas(True), knobs.override_batching_disabled(True):
        mgr.save(1, _cas_state(1))
        mgr.save(2, _cas_state(2))
    assert main(["stats", f"{root}/step_2"]) == 0
    out = capsys.readouterr().out
    assert "dedup=" in out
    assert main(["history", root]) == 0
    out = capsys.readouterr().out
    assert "dedup=" in out
    assert out.splitlines()[-1] == "2 entries total, 0 regression(s)"


def test_stats_cli_renders_sidecars(tmp_path, capsys):
    state = {"m": StateDict({"w": torch.ones((64, 64))})}
    Snapshot.take(str(tmp_path / "snap"), state)
    assert main(["stats", str(tmp_path / "snap")]) == 0
    out = capsys.readouterr().out
    assert "take" in out and "1 operation(s) recorded" in out
    assert main(["stats", str(tmp_path / "snap"), "--json"]) == 0
    docs = json.loads(capsys.readouterr().out)
    assert docs and docs[0]["action"] == "take"
    with knobs.override_sidecar(False):
        Snapshot.take(str(tmp_path / "bare"), state)
    assert main(["stats", str(tmp_path / "bare")]) == 0
    assert capsys.readouterr().out.startswith("no telemetry sidecars")


def test_stats_metrics_prints_the_registry(tmp_path, capsys):
    """``--metrics`` appends this process's Prometheus exposition: after a
    metrics-enabled take here, its families are in it."""
    metrics.reset()
    try:
        with knobs.override_metrics(True):
            Snapshot.take(str(tmp_path / "snap"), {"m": StateDict({"w": torch.ones(256)})})
        assert main(["stats", str(tmp_path / "snap"), "--metrics"]) == 0
        out = capsys.readouterr().out
        assert out.index("1 operation(s) recorded") < out.index("# TYPE tpusnap_")
        assert "tpusnap_storage_bytes_written_total" in out
    finally:
        metrics.uninstall_event_bridge()
        metrics.reset()


def _entry(duration_s, step, action="take"):
    return {
        "timestamp": 1700000000.0 + step,
        "step": step,
        "action": action,
        "op_id": f"{step:08x}",
        "rank": 0,
        "duration_s": duration_s,
        "bytes": 1 << 28,
        "throughput_gbps": 1.0,
        "top_phases": {"fs_write": duration_s * 0.8},
    }


def test_history_cli_flags_a_regression(tmp_path, capsys):
    storage = url_to_storage_plugin(str(tmp_path / "root"))
    try:
        with knobs.override_regression_factor(2.0), knobs.override_regression_window(10):
            for step in range(1, 7):
                assert history.append(storage, _entry(1.0, step)) is None
            # 6 baseline entries at 1.0 s; a 5 s save is a 5x regression.
            assert history.append(storage, _entry(5.0, 7)) is not None
    finally:
        storage.sync_close()
    assert main(["history", str(tmp_path / "root")]) == 0
    out = capsys.readouterr().out
    assert "REGRESSION" in out and "7 entries total, 1 regression(s)" in out
    assert main(["history", str(tmp_path / "root"), "--json"]) == 0
    assert len(json.loads(capsys.readouterr().out)) == 7
    assert main(["history", str(tmp_path / "root"), "--limit", "2"]) == 0
    assert capsys.readouterr().out.count("    take  ") <= 2


def test_history_render_empty(tmp_path, capsys):
    assert main(["history", str(tmp_path / "nothing")]) == 0
    assert "no step history" in capsys.readouterr().out


def _two_tenants(tmp_path):
    """Tenants A and B of one shared store, each with step 1 of one state."""
    store, ra, rb = (str(tmp_path / n) for n in ("store", "ra", "rb"))
    for root in (ra, rb):
        SnapshotManager(root, store=store).save(1, {"m": StateDict({"w": torch.full((512,), 1.0), "step": 1})})
    return store, ra, rb


def test_info_and_steps_name_the_store(tmp_path, capsys):
    store, ra, _ = _two_tenants(tmp_path)
    assert main(["info", f"{ra}/step_1"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == f"store:       shared CAS at {store}"
    assert main(["steps", ra]) == 0
    assert capsys.readouterr().out.splitlines()[-2:] == ["latest: 1", f"store: shared CAS at {store}"]
    # A snapshot outside any store has no store line, unless the knob names one.
    plain = str(tmp_path / "plain")
    Snapshot.take(plain, {"m": StateDict({"w": torch.ones(4)})})
    assert main(["info", plain]) == 0
    assert "store:" not in capsys.readouterr().out
    with knobs.override_store(store):
        assert main(["info", plain]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == f"store:       shared CAS at {store}"


def test_stats_and_gc_report_the_store(tmp_path, capsys):
    store, ra, _ = _two_tenants(tmp_path)
    usage = store_mod.tenant_usage(store)
    assert main(["stats", f"{ra}/step_1"]) == 0
    out = capsys.readouterr().out.splitlines()
    tenant_lines = [
        f"  tenant {tid} ({t['root']}): {_human(t['logical_bytes'])} logical, "
        f"{_human(t['exclusive_bytes'])} exclusive, {t['chunks']} chunk(s)"
        for tid, t in sorted(usage["tenants"].items())
    ]
    assert len(tenant_lines) == 2 and out[-2:] == tenant_lines
    assert out[-3].startswith(f"shared store {store}: {_human(usage['physical_bytes'])} physical across ")
    metrics.reset()  # stats published the per-tenant gauges into this process's registry

    cls = store_mod.chunk_classification(store)
    assert main(["gc", ra]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == (
        f"shared store {store}: {len(cls['referenced'])} referenced, {len(cls['orphan'])} orphan, "
        f"{len(cls['condemned'])} condemned chunk(s) store-wide"
    )
    assert cls["referenced"] and not cls["orphan"] and not cls["condemned"]
