"""The port's monitor keeps its tick cadence when a tick's own work is
slow: the heartbeat's and the spool entry's writes, which an op's I/O on
the same file system can hold up for most of a second, do not push the
later ticks back, and each periodic publish is judged at its tick's
scheduled time.

The tick loop runs on a synthetic clock: the stop event's ``wait`` advances
it by the timeout asked for, and the heartbeat write by the work it
stands for, so no case depends on the host's scheduler."""

import types

import pytest

from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.telemetry import fleet
from torchsnapshot_tpu_torch.telemetry import monitor as tmonitor

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

OP = "c0ffee00" * 4


class _Clock:
    def __init__(self, t):
        self.t = t

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t


class _Stop:
    """A stop event whose ``wait`` advances the clock by its timeout and
    stops the loop after ``ticks`` waits."""

    def __init__(self, clock, ticks):
        self.clock, self.ticks, self.timeouts = clock, ticks, []

    def wait(self, timeout):
        self.timeouts.append(timeout)
        self.clock.t += timeout
        return len(self.timeouts) > self.ticks

    def set(self):
        pass


@pytest.mark.parametrize("work_s", [[0.7] * 5, [0.2, 1.5, 0.2, 0.2, 0.2], [0.2, 2.6, 0.2, 0.2, 0.2]])
def test_ticks_keep_their_cadence_behind_slow_writes(tmp_path, monkeypatch, work_s):
    tick = 1.0
    with knobs.override_progress_interval_s(tick), knobs.override_fleet_telemetry_interval_s(
        tick
    ), knobs.override_fleet_telemetry_stale_s(2.0):
        mon = tmonitor.OpMonitor("take", OP, 0, watchdog=False)
        assert mon._thread is None
        clock = _Clock(mon._begin)
        monkeypatch.setattr(tmonitor, "time", types.SimpleNamespace(monotonic=clock.monotonic, time=clock.time))
        mon._heartbeat_path = str(tmp_path / "heartbeat.json")
        mon._fleet = True
        mon._stop = _Stop(clock, len(work_s))
        beats, publishes = [], []
        pending_work = list(work_s)

        def slow_heartbeat():
            beats.append(round(clock.t - mon._begin, 9))
            if pending_work:
                clock.t += pending_work.pop(0)

        def costly_publish(m, final=False):
            # Far over the overhead budget: only the liveness floor (half
            # the stale bound, one tick here) keeps the beacons going.
            m.fleet_overhead_s = getattr(m, "fleet_overhead_s", 0.0) + 0.5
            publishes.append(round(scheduled_now[-1] - mon._begin, 9))

        scheduled_now = []
        fleet_tick = mon._fleet_tick

        def recorded_fleet_tick(now):
            scheduled_now.append(now)
            fleet_tick(now)

        monkeypatch.setattr(mon, "_write_heartbeat", slow_heartbeat)
        monkeypatch.setattr(mon, "_fleet_tick", recorded_fleet_tick)
        monkeypatch.setattr(fleet, "publish", costly_publish)
        mon._run()
        mon._fleet = False
        mon._heartbeat_path = None
        monkeypatch.undo()
        mon._stop = tmonitor.threading.Event()
        mon.finish(True)
    periodic = beats[:-1]  # the last write is the terminal heartbeat
    assert len(periodic) == len(work_s)
    # Each tick starts at its scheduled time, or right after a tick whose
    # work ran past it; a tick that woke more than a tick late restarts the
    # grid one tick after it woke.
    expected, due, now = [], tick, 0.0
    for work in work_s:
        start = max(due, now)
        expected.append(start)
        due += tick
        if due <= start:
            due = start + tick
        now = start + work
    assert periodic == pytest.approx(expected)
    if max(work_s) < tick:
        assert periodic == pytest.approx([1.0, 2.0, 3.0, 4.0, 5.0])
    # Every tick's publish is judged at its scheduled time: over the budget
    # the floor still publishes at every tick a full tick after the last.
    assert len(publishes) == len(scheduled_now) == len(work_s)
    assert all(b - a >= tick - tmonitor._DUE_SLACK_S for a, b in zip(publishes, publishes[1:]))
