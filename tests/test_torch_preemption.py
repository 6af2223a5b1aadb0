"""SIGTERM emergency flush in the port (mirror of tests/test_preemption.py).

Covers torchsnapshot_tpu_torch/preemption.py: the io-concurrency boost,
the installed handler, and an ``async_take`` in flight when SIGTERM
arrives: its write pipeline widens in place, it commits a snapshot that
restores bit-exact, and ``preemption.flush`` start/end events bracket the
flush.  The JAX package's other deadline-mode switches (compression
dropped, telemetry sidecars shed) have nothing to act on in the port.

The flush is shown without a wall-clock threshold: every write blocks on a
gate, the pipeline runs one write at a time, and the test waits until the
boosted width of writes is in flight at once, which only the widened
semaphore allows."""

import asyncio
import os
import signal
import threading
import time

import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, event_handlers, knobs, preemption
from torchsnapshot_tpu_torch.storage_plugins import memory as memory_mod

_WAIT_S = 60.0


@pytest.fixture(autouse=True)
def _reset_deadline_mode():
    yield
    preemption.deactivate()


def test_effective_io_cap_boost():
    assert preemption.effective_io_cap(16) == 16
    preemption.activate(budget_s=60.0, reason="test")
    assert preemption.deadline_active()
    assert preemption.effective_io_cap(16) == 64
    assert preemption.effective_io_cap(1) == 4
    assert preemption.effective_io_cap(32) == preemption.IO_BOOST_MAX
    preemption.deactivate()
    assert preemption.effective_io_cap(16) == 16


def test_install_handler_uninstall_roundtrip():
    """The handler installs over (and restores) the previous disposition;
    activation is idempotent."""
    prev = signal.getsignal(signal.SIGTERM)
    handler = Snapshot.install_preemption_handler()
    try:
        assert signal.getsignal(signal.SIGTERM) is not prev
        assert preemption.activate(budget_s=60.0, reason="test")
        assert not preemption.activate(budget_s=60.0)  # already active
    finally:
        handler.uninstall()
        handler.uninstall()  # idempotent
    assert signal.getsignal(signal.SIGTERM) is prev


def test_handler_chains_to_a_callable_previous_handler():
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda num, frame: seen.append(num))
    try:
        handler = Snapshot.install_preemption_handler(signum=signal.SIGUSR1)
        try:
            os.kill(os.getpid(), signal.SIGUSR1)
            assert preemption.deadline_active() and seen == [signal.SIGUSR1]
        finally:
            handler.uninstall()
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_pipeline_started_in_deadline_mode_starts_wide():
    """A pipeline created after activation starts at the boosted width and
    registers nothing to widen later."""
    from torchsnapshot_tpu_torch import io_preparer
    from torchsnapshot_tpu_torch.scheduler import sync_execute_write_reqs

    preemption.activate(budget_s=60.0, reason="test")
    storage = memory_mod.MemoryStoragePlugin(root="wide")
    try:
        with knobs.override_max_per_rank_io_concurrency(2):
            _, reqs = io_preparer.prepare_write(torch.ones(4), "m/x", rank=0)
            pending = sync_execute_write_reqs(reqs, storage, 1 << 20, rank=0)
            pending.sync_complete()
        assert preemption._BOOST_TARGETS == []
    finally:
        memory_mod.MemoryStoragePlugin.reset("wide")


class _CountingGate(memory_mod.MemoryStoragePlugin):
    """Payload writes wait (off the event loop) for ``gate``; ``waiting``
    counts those parked at once.  The metadata commit passes."""

    gate = threading.Event()
    waiting = 0
    lock = threading.Lock()

    async def write(self, write_io):
        cls = type(self)
        if not write_io.path.startswith("."):
            with cls.lock:
                cls.waiting += 1
            try:
                opened = await asyncio.get_running_loop().run_in_executor(None, cls.gate.wait, _WAIT_S)
            finally:
                with cls.lock:
                    cls.waiting -= 1
            if not opened:
                raise TimeoutError("the storage gate never opened")
        await super().write(write_io)


def _wait_for(predicate, what):
    deadline = time.monotonic() + _WAIT_S
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _sigterm(events):
    """This activation's bracket: watcher threads of earlier activations in
    the process may still be emitting theirs."""
    return [
        e
        for e in events
        if e.name.startswith("preemption.flush") and e.metadata.get("reason") == f"signal {int(signal.SIGTERM)}"
    ]


def test_sigterm_flush_widens_inflight_async_take(monkeypatch):
    """An async_take behind ONE io slot, every write parked on the gate:
    SIGTERM activates deadline mode, the in-flight pipeline's semaphore
    widens in place to the boosted width (4 writes parked at once), the
    take commits and restores bit-exact, and the flush bracket reports the
    save in flight and its success."""

    class Gated(_CountingGate):
        gate = threading.Event()
        waiting = 0
        lock = threading.Lock()

    monkeypatch.setattr(memory_mod, "MemoryStoragePlugin", Gated)
    events = []
    event_handlers.register_event_handler(events.append)
    handler = Snapshot.install_preemption_handler()
    state = {f"w{i}": torch.full((256,), float(i)) for i in range(8)}
    try:
        with knobs.override_max_per_rank_io_concurrency(1), knobs.override_batching_disabled(True), (
            knobs.override_save_deadline_s(_WAIT_S)
        ):
            pending = Snapshot.async_take("memory://flush", {"m": StateDict(state)})
            _wait_for(lambda: Gated.waiting == 1, "the first write")
            time.sleep(0.05)
            assert Gated.waiting == 1  # one io slot: the others queue
            os.kill(os.getpid(), signal.SIGTERM)
            assert preemption.deadline_active()
            _wait_for(lambda: Gated.waiting == preemption.effective_io_cap(1), "the widened pipeline")
            Gated.gate.set()
            snapshot = pending.wait()
        dst = {"m": StateDict({k: torch.zeros(256) for k in state})}
        snapshot.restore(dst)
        for k, v in state.items():
            assert torch.equal(dst["m"][k], v), k
        _wait_for(lambda: any(e.name == "preemption.flush.end" for e in _sigterm(events)), "preemption.flush.end")
    finally:
        Gated.gate.set()
        handler.uninstall()
        event_handlers.unregister_event_handler(events.append)
        memory_mod._REGISTRY.clear()
    flush = _sigterm(events)
    assert [e.name for e in flush] == ["preemption.flush.start", "preemption.flush.end"]
    start, end = flush
    assert start.metadata["inflight_saves"] == 1
    assert end.metadata["is_success"] is True and end.metadata["inflight_saves"] == 0
    assert end.metadata["duration_s"] <= end.metadata["budget_s"]


def test_sync_take_in_flight_counts_for_the_flush(monkeypatch):
    """A synchronous take running when deadline mode activates is one of the
    saves the flush watches (the activation here comes from the take's own
    write, so the take is certainly in flight)."""
    events = []
    activated = []

    class ActivateOnWrite(memory_mod.MemoryStoragePlugin):
        async def write(self, write_io):
            if not activated:
                activated.append(preemption.activate(budget_s=_WAIT_S, reason="sync-take-test"))
            await super().write(write_io)

    monkeypatch.setattr(memory_mod, "MemoryStoragePlugin", ActivateOnWrite)
    event_handlers.register_event_handler(events.append)
    try:
        Snapshot.take("memory://sync-flush", {"m": StateDict({"w": torch.ones(8)})})

        def ours():
            return [e for e in events if e.metadata.get("reason") == "sync-take-test"]

        _wait_for(lambda: len(ours()) == 2, "the flush bracket")
    finally:
        event_handlers.unregister_event_handler(events.append)
        memory_mod._REGISTRY.clear()
    start, end = ours()
    assert activated == [True]
    assert start.name == "preemption.flush.start" and start.metadata["inflight_saves"] == 1
    assert end.name == "preemption.flush.end" and end.metadata["is_success"] is True
