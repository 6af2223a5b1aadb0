"""Telemetry sidecars and step history in torchsnapshot_tpu_torch, held
against the JAX package.

- Sidecars (telemetry/sidecar.py) share the JAX package's schema: the same
  keys, read by either package; the JAX manager's ``restore_point_times``,
  ``step_as_of`` and ``restore_as_of`` resolve every point of a root the
  port wrote, and the reverse.
- The step history (telemetry/history.py) summarizes and flags
  regressions as the JAX package does on the same entries.
- Deadline mode frames raw and sheds sidecars (the mirror of
  tests/test_preemption.py:33).
- The JAX package's host data plane knobs the port does not implement
  warn once, naming themselves.
"""

import time
import warnings

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, event_handlers, knobs, preemption
from torchsnapshot_tpu_torch.manager import SnapshotManager
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
from torchsnapshot_tpu_torch.telemetry import history, sidecar

from torch_env import default_knob_env  # noqa: F401  autouse fixture


def _state(v):
    return {"m": StateDict({"w": torch.full((256,), float(v)), "step": v})}


def _jax_state(v):
    from torchsnapshot_tpu import StateDict as JaxStateDict

    return {"m": JaxStateDict({"w": np.full((256,), float(v), np.float32), "step": v})}


def _read_sidecars(path):
    storage = url_to_storage_plugin(path)
    try:
        return sidecar.read_all(storage)
    finally:
        storage.sync_close()


@pytest.fixture(autouse=True)
def _reset_deadline_mode():
    yield
    preemption.deactivate()


def test_take_async_take_and_restore_write_sidecars_of_the_jax_schema(tmp_path):
    """A port take, async take and restore each write one sidecar per rank
    with the keys of the JAX package's take sidecar, and the JAX package's
    reader returns them."""
    from torchsnapshot_tpu import Snapshot as JaxSnapshot
    from torchsnapshot_tpu.storage_plugin import url_to_storage_plugin as jax_plugin
    from torchsnapshot_tpu.telemetry import sidecar as jax_sidecar

    Snapshot.take(str(tmp_path / "port"), _state(1))
    Snapshot(str(tmp_path / "port")).restore(_state(0))
    Snapshot.async_take(str(tmp_path / "port_async"), _state(2)).wait()
    JaxSnapshot.take(str(tmp_path / "jax"), _jax_state(1))
    docs = {d["action"]: d for d in _read_sidecars(str(tmp_path / "port")) + _read_sidecars(str(tmp_path / "port_async"))}
    assert sorted(docs) == ["async_take", "restore", "take"]
    (jax_doc,) = _read_sidecars(str(tmp_path / "jax"))
    assert set(docs["take"]) == set(jax_doc)
    assert set(docs["take"]["knobs"]) == set(jax_doc["knobs"])
    assert docs["take"]["schema_version"] == jax_doc["schema_version"] == "1.0"
    assert docs["async_take"]["staging_mode"] == "host" and "stall_s" in docs["async_take"]
    assert docs["take"]["bytes"] > 0 and docs["take"]["rss_high_water_bytes"] > 0
    storage = jax_plugin(str(tmp_path / "port"))
    try:
        assert sorted(d["action"] for d in jax_sidecar.read_all(storage)) == ["restore", "take"]
    finally:
        storage.sync_close()
    assert sidecar.summarize(docs["take"]).split()[0] == "take"


def test_sidecar_opt_out_and_failed_write_never_fail_the_take(tmp_path):
    with knobs.override_sidecar(False):
        Snapshot.take(str(tmp_path / "off"), _state(1))
    assert not (tmp_path / "off" / "telemetry").exists()
    with knobs.override_faults("write:1+:terminal@telemetry/*"):
        Snapshot.take(str(tmp_path / "failing"), _state(1))
    assert not (tmp_path / "failing" / "telemetry").exists()
    dst = _state(0)
    Snapshot(str(tmp_path / "failing")).restore(dst)
    assert dst["m"]["step"] == 1


@pytest.mark.parametrize("journal", [False, True])
def test_jax_manager_resolves_every_point_of_a_port_root(tmp_path, journal):
    """The JAX manager's restore_point_times gives a time for every restore
    point the port's manager wrote, step_as_of picks each point at its own
    time, and restore_as_of restores it bit-exact."""
    from torchsnapshot_tpu.manager import SnapshotManager as JaxManager

    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root, journal=journal)
    stamps = {}
    for step in (1, 2, 3):
        mgr.save(step, _state(step))
        stamps[step] = time.time()
        time.sleep(0.01)
    jax_mgr = JaxManager(root, journal=journal)
    points = jax_mgr.restore_point_times()
    kinds = ["full", "seg", "seg"] if journal else ["full"] * 3
    assert [(s, k) for s, k, _ in points] == list(zip((1, 2, 3), kinds))
    assert all(ts is not None for _, _, ts in points)
    assert points == mgr.restore_point_times()
    for step in (1, 2, 3):
        assert jax_mgr.step_as_of(stamps[step]) == step
        dst = _jax_state(0)
        assert jax_mgr.restore_as_of(stamps[step], dst) == step
        np.testing.assert_array_equal(dst["m"]["w"], np.full((256,), float(step), np.float32))
    with pytest.raises(ValueError, match="existed at"):
        jax_mgr.step_as_of(points[0][2] - 60)


def test_port_manager_resolves_a_jax_root(tmp_path):
    """The reverse: the port's restore_as_of resolves the JAX package's
    sidecars and history."""
    from torchsnapshot_tpu.manager import SnapshotManager as JaxManager

    root = str(tmp_path / "ckpts")
    jax_mgr = JaxManager(root, journal=True)
    stamps = {}
    for step in (1, 2):
        jax_mgr.save(step, _jax_state(step))
        stamps[step] = time.time()
        time.sleep(0.01)
    mgr = SnapshotManager(root, journal=True)
    assert mgr.restore_point_times() == jax_mgr.restore_point_times()
    for step in (1, 2):
        dst = _state(0)
        assert mgr.restore_as_of(stamps[step], dst) == step
        assert torch.equal(dst["m"]["w"], torch.full((256,), float(step)))


def test_history_appends_and_flags_regressions_as_the_jax_package(tmp_path):
    """The manager appends one line per committed save; summaries, the
    regression verdict and the rendering match the JAX package's."""
    from torchsnapshot_tpu.telemetry import history as jax_history

    root = str(tmp_path / "ckpts")
    mgr = SnapshotManager(root)
    for step in (1, 2):
        mgr.save(step, _state(step))
    storage = url_to_storage_plugin(root)
    try:
        entries = history.read(storage)
    finally:
        storage.sync_close()
    assert [(e["step"], e["action"]) for e in entries] == [(1, "take"), (2, "take")]
    doc = _read_sidecars(f"{root}/step_2")[-1]
    assert history.summarize_sidecar(doc, step=2) == jax_history.summarize_sidecar(doc, step=2)

    rng = np.random.RandomState(0)
    base = [{"action": "take", "duration_s": float(d), "step": i} for i, d in enumerate(rng.uniform(1, 2, 8))]
    seen = []
    event_handlers.register_event_handler(seen.append)
    try:
        with knobs.override_regression_window(6):
            for duration in (1.5, 9.0):
                new = {"action": "take", "duration_s": duration, "step": 99}
                assert history.detect_regression(base, new) == jax_history.detect_regression(base, new)
            memory = url_to_storage_plugin(str(tmp_path / "hist"))
            try:
                for e in base:
                    history.append(memory, dict(e))
                regression = history.append(memory, {"action": "take", "duration_s": 9.0, "step": 99})
                lines = history.read(memory)
            finally:
                memory.sync_close()
    finally:
        event_handlers.unregister_event_handler(seen.append)
    assert regression is not None and regression["window"] == 6
    assert [e.metadata["step"] for e in seen if e.name == "telemetry.regression"] == [99]
    assert history.render(lines) == jax_history.render(lines)
    assert "REGRESSION" in history.render(lines)


def test_deadline_mode_drops_compression_and_sheds_sidecar(tmp_path):
    """Mirror of tests/test_preemption.py:33: deadline mode frames payloads
    raw whatever the codec and disables sidecar writes; deactivate
    restores both."""
    from torchsnapshot_tpu_torch import compression

    data = bytes(range(256)) * 64
    with knobs.override_compression("zlib"):
        frame, codec = compression.encode(data, "zlib")
        assert codec == "zlib"
        assert sidecar.enabled()
        preemption.activate(budget_s=60.0, reason="test")
        frame, codec = compression.encode(data, "zlib")
        assert codec == "raw"
        assert bytes(compression.decode(frame)) == data
        assert not sidecar.enabled()
        Snapshot.take(str(tmp_path / "deadline"), _state(1))
        preemption.deactivate()
        assert sidecar.enabled()
    assert not (tmp_path / "deadline" / "telemetry").exists()


@pytest.mark.parametrize("name", knobs.UNIMPLEMENTED_KNOBS)
def test_unimplemented_knobs_warn_once_naming_themselves(tmp_path, monkeypatch, name):
    """Each host data plane knob the port does not implement yet warns once
    per process when set, naming itself."""
    monkeypatch.setattr(knobs, "_warned_knobs", set())
    with knobs.override_env(name, "1"):
        with pytest.warns(RuntimeWarning, match=f"{name} is set but has no effect in torchsnapshot_tpu_torch"):
            Snapshot.take(str(tmp_path / "a"), _state(1))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            Snapshot(str(tmp_path / "a")).restore(_state(0))
