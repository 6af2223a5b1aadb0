"""The port's step history (torchsnapshot_tpu_torch/telemetry/history.py),
mirroring tests/test_analyze.py's step-history cases: the append/read
round trip with the regression verdict, its event and its counter, and the
rendered trend; no verdict before a baseline; factor 0 disabling
detection; the file's bound; torn lines skipped; the empty rendering.  The
CLI halves (``history`` and ``history --json``) come with the port's CLI;
here the rendering is also held equal to the JAX package's."""

import json

import pytest

from torchsnapshot_tpu.telemetry import history as jax_history
from torchsnapshot_tpu_torch import event_handlers, knobs
from torchsnapshot_tpu_torch.io_types import WriteIO
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
from torchsnapshot_tpu_torch.telemetry import history, metrics

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


@pytest.fixture(autouse=True)
def _clean_metrics():
    metrics.uninstall_event_bridge()
    metrics.reset()
    yield
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


def test_history_append_read_roundtrip_and_regression(tmp_path):
    events = []
    event_handlers.register_event_handler(events.append)
    storage = url_to_storage_plugin(str(tmp_path / "root"))
    try:
        with knobs.override_metrics(True), knobs.override_regression_factor(2.0), knobs.override_regression_window(
            10
        ):
            metrics.install_event_bridge()
            for step in range(1, 7):
                assert history.append(storage, _entry(1.0, step)) is None
            # 6 baseline entries at 1.0 s; a 5 s save is a 5x regression.
            reg = history.append(storage, _entry(5.0, 7))
            assert reg is not None
            assert reg["ratio"] == pytest.approx(5.0)
            entries = history.read(storage)
    finally:
        event_handlers.unregister_event_handler(events.append)
        storage.sync_close()
    assert len(entries) == 7
    assert "regression" in entries[-1]
    regs = [e for e in events if e.name == "telemetry.regression"]
    assert len(regs) == 1
    assert regs[0].metadata["step"] == 7
    assert metrics.counter("tpusnap_save_regressions_total").get(action="take") == 1
    out = history.render(entries)
    assert "REGRESSION" in out and "7 entries total, 1 regression(s)" in out
    assert out == jax_history.render(entries)
    # What `history --json` prints: the entries, one object each.
    assert len(json.loads(json.dumps(entries))) == 7


def test_history_regression_needs_baseline(tmp_path):
    """Below MIN_BASELINE_ENTRIES same-action entries no verdict fires:
    two noisy first steps must not alarm."""
    storage = url_to_storage_plugin(str(tmp_path / "root"))
    try:
        with knobs.override_regression_factor(2.0):
            for step in range(1, history.MIN_BASELINE_ENTRIES):
                assert history.append(storage, _entry(1.0, step)) is None
            assert history.append(storage, _entry(99.0, 98)) is None
            # The baseline is complete now (median over [1, 1, 1, 1, 99]
            # is 1): the next slow save fires.
            assert history.append(storage, _entry(9.0, 99)) is not None
    finally:
        storage.sync_close()
    assert history.MIN_BASELINE_ENTRIES == jax_history.MIN_BASELINE_ENTRIES


def test_history_factor_zero_disables(tmp_path):
    storage = url_to_storage_plugin(str(tmp_path / "root"))
    try:
        with knobs.override_regression_factor(0):
            for step in range(1, 8):
                assert history.append(storage, _entry(1.0, step)) is None
            assert history.append(storage, _entry(50.0, 8)) is None
    finally:
        storage.sync_close()


def test_history_file_stays_bounded(tmp_path, monkeypatch):
    monkeypatch.setattr(history, "MAX_HISTORY_ENTRIES", 10)
    storage = url_to_storage_plugin(str(tmp_path / "root"))
    try:
        with knobs.override_regression_factor(0):
            for step in range(1, 25):
                history.append(storage, _entry(1.0, step))
        entries = history.read(storage)
    finally:
        storage.sync_close()
    assert len(entries) == 10
    assert [e["step"] for e in entries] == list(range(15, 25))


def test_history_render_empty(tmp_path):
    storage = url_to_storage_plugin(str(tmp_path / "nothing"))
    try:
        entries = history.read(storage)
    finally:
        storage.sync_close()
    assert entries == []
    assert "no step history" in history.render(entries)
    assert history.render(entries) == jax_history.render(entries)


def test_history_skips_torn_lines(tmp_path):
    storage = url_to_storage_plugin(str(tmp_path / "root"))
    try:
        good = json.dumps(_entry(1.0, 1))
        storage.sync_write(WriteIO(path=history.HISTORY_PATH, buf=(good + "\n{torn garba").encode()))
        entries = history.read(storage)
    finally:
        storage.sync_close()
    assert len(entries) == 1 and entries[0]["step"] == 1
