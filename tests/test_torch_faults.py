"""Fault injection in torchsnapshot_tpu_torch (``faults.py``) and the
crash-consistent take it drives.

Mirror of tests/test_faults.py's storage-level cases: the spec grammar
(held against the JAX package's parser rule for rule), the wrapper's
semantics, the byte meters, and the pipeline's bounded retry and
cleanup-on-abort under injected faults.  The JAX package's metrics
counters have no counterpart yet (telemetry is a later slice), so retries
are observed through their log lines; the ``gc`` CLI cases wait for the
CLI.
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, faults, knobs
from torchsnapshot_tpu_torch.dist_store import FileStore, LinearBarrier, StorePeerError
from torchsnapshot_tpu_torch.faults import (
    FaultInjectionError,
    FaultyStoragePlugin,
    InjectedTransientError,
    parse_fault_spec,
)
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.snapshot import SNAPSHOT_METADATA_FNAME
from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin


def _state(v=1):
    return {"m": StateDict({"w": torch.full((256,), float(v)), "step": v})}


# ----------------------------------------------------------- spec grammar

GOOD_SPECS = [
    "write:2:transient; read:1+:latency:0.01 ;write:1:torn:0.25@*.data",
    "none",
    "",
    "any:*:terminal",
    "write:3:crash@cas/*",
    "ledger:1:transient@ledger/*; ledger:2:crash",
    "delete:2+:terminal@cas/*",
    "peer:1:peer_slow:0.5",
]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_matches_the_jax_package(spec):
    from torchsnapshot_tpu.faults import parse_fault_spec as jparse

    assert [vars(r) for r in parse_fault_spec(spec)] == [vars(r) for r in jparse(spec)]


def test_parse_rules():
    rules = parse_fault_spec("write:2:transient; read:1+:latency:0.01 ;write:1:torn:0.25@*.data")
    assert [r.op for r in rules] == ["write", "read", "write"]
    assert rules[0].first == 2 and not rules[0].open_ended
    assert rules[1].open_ended and rules[1].param == 0.01
    assert rules[2].kind == "torn" and rules[2].path_glob == "*.data"
    assert parse_fault_spec("none") == []
    crash = parse_fault_spec("write:3:crash@cas/*")[0]
    assert crash.kind == "crash" and crash.first == 3 and crash.path_glob == "cas/*"


@pytest.mark.parametrize(
    "bad",
    [
        "write:transient",
        "frobnicate:1:transient",
        "write:1:explode",
        "read:1:torn",
        "write:0:transient",
        "write:1:torn:1.5",
        "write:1:latency:-1",
        "write:1:transient:0:extra",
        "write:1:crash:1",
        "ledger:1:torn",
    ],
)
def test_parse_rejects(bad):
    from torchsnapshot_tpu.faults import parse_fault_spec as jparse

    with pytest.raises(ValueError):
        parse_fault_spec(bad)
    with pytest.raises(ValueError):
        jparse(bad)


# ------------------------------------------------------- wrapper semantics


def _mem(spec, root="faultmem"):
    MemoryStoragePlugin.reset(root)
    return FaultyStoragePlugin(MemoryStoragePlugin(root), parse_fault_spec(spec))


def test_nth_write_fails_once():
    plugin = _mem("write:2:transient")
    plugin.sync_write(WriteIO(path="a", buf=b"1"))
    with pytest.raises(InjectedTransientError):
        plugin.sync_write(WriteIO(path="b", buf=b"2"))
    plugin.sync_write(WriteIO(path="c", buf=b"3"))


def test_open_ended_and_terminal():
    plugin = _mem("write:2+:terminal")
    plugin.sync_write(WriteIO(path="a", buf=b"1"))
    for _ in range(3):
        with pytest.raises(FaultInjectionError):
            plugin.sync_write(WriteIO(path="b", buf=b"2"))


def test_path_glob_scopes_counter():
    plugin = _mem("write:1:transient@special/*")
    plugin.sync_write(WriteIO(path="normal", buf=b"1"))
    with pytest.raises(InjectedTransientError):
        plugin.sync_write(WriteIO(path="special/x", buf=b"2"))


def test_ledger_op_matches_control_paths_not_data():
    plugin = _mem("ledger:1:transient")
    plugin.sync_write(WriteIO(path="cas/xxh64/ab/abcd", buf=b"1"))
    with pytest.raises(InjectedTransientError):
        plugin.sync_write(WriteIO(path="tenants/t1.json", buf=b"{}"))
    plugin.sync_write(WriteIO(path="sweep/epoch.json", buf=b"{}"))


def test_ledger_op_counts_every_verb():
    plugin = _mem("ledger:2:terminal@ledger/*")
    plugin.sync_write(WriteIO(path="ledger/t1/refs_1.json", buf=b"{}"))
    with pytest.raises(FaultInjectionError):
        plugin.sync_read(ReadIO(path="ledger/t1/refs_1.json"))


def test_delete_fault_scoped_by_glob():
    plugin = _mem("delete:1:transient@cas/*")
    plugin.sync_write(WriteIO(path="cas/xxh64/ab/abcd", buf=b"x"))
    plugin.sync_write(WriteIO(path="leases/writer_t1_1.json", buf=b"{}"))
    plugin.sync_delete("leases/writer_t1_1.json")
    with pytest.raises(InjectedTransientError):
        plugin.sync_delete("cas/xxh64/ab/abcd")
    assert plugin.sync_exists("cas/xxh64/ab/abcd")
    plugin.sync_delete("cas/xxh64/ab/abcd")
    assert not plugin.sync_exists("cas/xxh64/ab/abcd")


def test_torn_write_persists_prefix():
    plugin = _mem("write:1:torn:0.5")
    with pytest.raises(InjectedTransientError, match="torn"):
        plugin.sync_write(WriteIO(path="t", buf=b"0123456789"))
    read_io = ReadIO(path="t")
    plugin.sync_read(read_io)
    assert bytes(read_io.buf) == b"01234"


def test_crash_kind_exits_the_process():
    """``crash`` is process death: the faulted call never returns and no
    teardown runs (proved in a forkserver child)."""
    from torchsnapshot_tpu_torch.test_utils import _context

    ctx = _context()
    p = ctx.Process(target=_crash_victim, args=("crashmem",))
    p.start()
    p.join(timeout=60)
    assert p.exitcode == 1


def _crash_victim(root):
    import os

    plugin = FaultyStoragePlugin(MemoryStoragePlugin(root), parse_fault_spec("write:2:crash"))
    plugin.sync_write(WriteIO(path="a", buf=b"1"))
    plugin.sync_write(WriteIO(path="b", buf=b"2"))  # the crash fires here
    os._exit(7)  # never reached


def test_write_counters_meter_backend_bytes():
    faults.reset_write_counters()
    plugin = _mem("write:2:torn:0.5")
    plugin.sync_write(WriteIO(path="a", buf=b"0123456789"))
    with pytest.raises(InjectedTransientError):
        plugin.sync_write(WriteIO(path="t", buf=b"0123456789"))
    counters = faults.write_counters()
    assert counters["a"] == 10
    assert counters["t"] == 5
    assert faults.total_write_bytes() == 15
    faults.reset_write_counters()
    assert faults.total_write_bytes() == 0


def test_read_counters_meter_ranges():
    faults.reset_read_counters()
    plugin = _mem("none")
    plugin.sync_write(WriteIO(path="a", buf=b"0123456789"))
    plugin.sync_read(ReadIO(path="a"))
    plugin.sync_read(ReadIO(path="a", byte_range=[2, 5]))
    assert faults.read_counters() == {"a": 13}


def test_latency_passes_through():
    plugin = _mem("read:1:latency:0.05")
    plugin.sync_write(WriteIO(path="a", buf=b"payload"))
    t0 = time.monotonic()
    read_io = ReadIO(path="a")
    plugin.sync_read(read_io)
    assert bytes(read_io.buf) == b"payload"
    assert time.monotonic() - t0 >= 0.04


def test_wrapper_keeps_the_plugin_capabilities(tmp_path):
    """Injection must not change planning: the scatter and fused
    write+hash capabilities of the wrapped plugin show through."""
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    with knobs.override_faults("none"):
        plugin = url_to_storage_plugin(str(tmp_path))
    assert isinstance(plugin, FaultyStoragePlugin)
    assert plugin.supports_scatter and plugin.supports_write_hash
    plugin.sync_close()


# ------------------------------------- pipeline retry and lifecycle (fs)


def _retried(caplog, what):
    return [r for r in caplog.records if f"transient {what} failure" in r.getMessage()]


def test_transient_write_fault_retried_take_commits(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv(knobs.RETRY_BASE_S_ENV_VAR, "0.001")
    with caplog.at_level(logging.WARNING), knobs.override_faults("write:1:transient"):
        snap = Snapshot.take(str(tmp_path / "snap"), _state(7))
    assert (tmp_path / "snap" / SNAPSHOT_METADATA_FNAME).exists()
    assert len(_retried(caplog, "write")) == 1
    dst = _state(0)
    snap.restore(dst)
    assert dst["m"]["step"] == 7
    assert torch.equal(dst["m"]["w"], torch.full((256,), 7.0))


def test_transient_read_fault_retried_restore_succeeds(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv(knobs.RETRY_BASE_S_ENV_VAR, "0.001")
    Snapshot.take(str(tmp_path / "snap"), _state(9))
    with caplog.at_level(logging.WARNING), knobs.override_faults(
        "read:1:transient@0/*"
    ), knobs.override_batching_disabled(True):
        dst = _state(0)
        Snapshot(str(tmp_path / "snap")).restore(dst)
    assert dst["m"]["step"] == 9
    assert torch.equal(dst["m"]["w"], torch.full((256,), 9.0))
    assert len(_retried(caplog, "read")) == 1


def test_read_retry_budget_zero_propagates(tmp_path, monkeypatch):
    monkeypatch.setenv(knobs.RETRY_BASE_S_ENV_VAR, "0.001")
    monkeypatch.setenv(knobs.IO_RETRIES_ENV_VAR, "0")
    Snapshot.take(str(tmp_path / "snap"), _state(3))
    with knobs.override_faults("read:1:transient@0/*"), knobs.override_batching_disabled(True):
        with pytest.raises(InjectedTransientError):
            Snapshot(str(tmp_path / "snap")).restore(_state(0))


def test_exhausted_retries_abort_cleanup_no_metadata(tmp_path, monkeypatch):
    monkeypatch.setenv(knobs.RETRY_BASE_S_ENV_VAR, "0.001")
    with knobs.override_faults("write:1+:transient"):
        with pytest.raises(InjectedTransientError):
            Snapshot.take(str(tmp_path / "snap"), _state())
    assert not (tmp_path / "snap" / SNAPSHOT_METADATA_FNAME).exists()
    assert not (tmp_path / "snap").exists()


def test_terminal_fault_not_retried(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv(knobs.RETRY_BASE_S_ENV_VAR, "0.001")
    with caplog.at_level(logging.WARNING), knobs.override_faults("write:1:terminal"):
        with pytest.raises(FaultInjectionError):
            Snapshot.take(str(tmp_path / "snap"), _state())
    assert not _retried(caplog, "write")
    assert not (tmp_path / "snap").exists()


def test_async_take_fault_cleanup(tmp_path, monkeypatch):
    monkeypatch.setenv(knobs.RETRY_BASE_S_ENV_VAR, "0.001")
    with knobs.override_faults("write:1+:transient"):
        pending = Snapshot.async_take(str(tmp_path / "snap"), _state())
        with pytest.raises(InjectedTransientError):
            pending.wait()
    assert not (tmp_path / "snap" / SNAPSHOT_METADATA_FNAME).exists()
    assert not (tmp_path / "snap").exists()


def test_take_cleanup_never_deletes_committed(tmp_path, monkeypatch):
    monkeypatch.setenv(knobs.RETRY_BASE_S_ENV_VAR, "0.001")
    path = str(tmp_path / "snap")
    Snapshot.take(path, _state(1))
    with knobs.override_faults("write:1+:transient"):
        with pytest.raises(InjectedTransientError):
            Snapshot.take(path, _state(2))
    dst = _state(0)
    Snapshot(path).restore(dst)
    assert dst["m"]["step"] == 1


def test_faulted_snapshot_restores_through_the_jax_package(tmp_path, monkeypatch):
    """A take that survived injected transient faults (a retried write and
    a torn one) is a valid snapshot for the JAX package too."""
    from torchsnapshot_tpu import Snapshot as JaxSnapshot, StateDict as JaxStateDict

    monkeypatch.setenv(knobs.RETRY_BASE_S_ENV_VAR, "0.001")
    with knobs.override_faults("write:1:transient;write:2:torn:0.5"):
        Snapshot.take(str(tmp_path / "snap"), _state(5))
    dst = {"m": JaxStateDict({"w": np.zeros(256, np.float32), "step": 0})}
    JaxSnapshot(str(tmp_path / "snap")).restore(dst)
    assert dst["m"]["step"] == 5
    np.testing.assert_array_equal(dst["m"]["w"], np.full(256, 5.0, np.float32))


# ------------------------------------------------- barrier timeout knob


def test_barrier_timeout_knob(tmp_path):
    store = FileStore(str(tmp_path / "store"))
    barrier = LinearBarrier("t", store, rank=0, world_size=2)
    with knobs.override_barrier_timeout_s(0.3):
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            barrier.arrive()
        assert time.monotonic() - t0 < 5


def test_peer_error_surfaces_before_timeout(tmp_path):
    store = FileStore(str(tmp_path / "store"))
    result = {}

    def leader():
        barrier = LinearBarrier("pe", store, rank=0, world_size=2)
        t0 = time.monotonic()
        try:
            barrier.arrive()
        except Exception as e:  # noqa: BLE001
            result["error"] = e
            result["waited_s"] = time.monotonic() - t0

    with knobs.override_barrier_timeout_s(60):
        thread = threading.Thread(target=leader)
        thread.start()
        time.sleep(0.3)
        LinearBarrier("pe", store, rank=1, world_size=2).report_error("rank 1 exploded")
        thread.join(timeout=15)
    assert not thread.is_alive()
    assert isinstance(result.get("error"), StorePeerError)
    assert "rank 1 exploded" in str(result["error"])
    assert result["waited_s"] < 10
