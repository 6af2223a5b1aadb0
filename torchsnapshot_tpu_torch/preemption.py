"""Preemption deadline mode: SIGTERM-driven emergency snapshot flush.

Counterpart of ``torchsnapshot_tpu/preemption.py``.  Preemption is a
SIGTERM with a grace window (tens of seconds) followed by SIGKILL.
``install_handler()`` (surfaced as ``Snapshot.install_preemption_handler()``)
registers a SIGTERM handler that switches the process into **deadline
mode** for the ``TPUSNAP_SAVE_DEADLINE_S`` budget:

- **io concurrency is raised**: every registered write pipeline's
  semaphore gains extra permits (released onto its own event loop, so an
  already-draining pipeline widens at once), and pipelines created after
  activation start wide, within the unchanged memory budget;
- **compression is dropped**: payloads are framed ``raw`` whatever
  ``TPUSNAP_COMPRESSION`` asks for (compression.py); the self-describing
  frame keeps every reader correct;
- **telemetry sidecars are shed** (telemetry/sidecar.py ``enabled``): one
  write fewer between the flush and its commit.

``preemption.flush.start`` / ``preemption.flush.end`` events bracket the
flush; the end event says whether every save in flight at activation
reached a terminal state inside the budget.  The saves in flight are the
takes and async takes the health monitor (telemetry/monitor.py) is
watching at activation, as in the JAX package.  The handler itself only flips state
and spawns a watcher thread (no blocking work runs in signal context), and
by default *replaces* SIG_DFL termination, so the process survives the
SIGTERM long enough to commit (the supervisor's SIGKILL still bounds it).

Deadline mode is process-global and sticky until :func:`deactivate` (a
preempted process is going down).  Tests pair :func:`activate` /
``install_handler`` with :func:`deactivate`.
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Any, List, Optional, Tuple

from . import knobs
from .event import Event
from .event_handlers import log_event

logger = logging.getLogger(__name__)

# Deadline-mode io-concurrency boost: the write semaphore widens to
# base * factor, capped.  The memory budget still gates staging, so the
# extra slots never admit more bytes than normal mode could.
IO_BOOST_FACTOR = 4
IO_BOOST_MAX = 64

# Reentrant: the SIGTERM handler runs activate() on the main thread between
# bytecodes, and the main thread may be inside register_write_semaphore (a
# sync take drives its pipeline inline) holding this very lock.
_STATE_LOCK = threading.RLock()
_ACTIVE = False
# (loop, semaphore, base_cap, boosted_flag_list) registered by write
# pipelines; pruned when their loop closes.
_BOOST_TARGETS: List[Tuple[Any, Any, int, List[bool]]] = []
def deadline_active() -> bool:
    """Whether the process is in emergency-flush deadline mode."""
    return _ACTIVE


def effective_io_cap(base: int) -> int:
    """The io-concurrency cap a pipeline should start with: ``base``
    normally, the boosted width in deadline mode."""
    if not deadline_active():
        return base
    return max(base, min(base * IO_BOOST_FACTOR, IO_BOOST_MAX))


def register_write_semaphore(loop: Any, semaphore: Any, base_cap: int) -> None:
    """Called by the write pipeline after creating its io semaphore, so an
    activation mid-drain can widen it in place (extra ``release()`` calls
    scheduled onto the pipeline's own loop)."""
    boosted = [False]
    with _STATE_LOCK:
        _BOOST_TARGETS[:] = [t for t in _BOOST_TARGETS if not t[0].is_closed()]
        _BOOST_TARGETS.append((loop, semaphore, base_cap, boosted))
        active = _ACTIVE
    if active:
        _boost_one(loop, semaphore, base_cap, boosted)


def _boost_one(loop: Any, semaphore: Any, base_cap: int, boosted: List[bool]) -> None:
    # Check-and-set under the lock: a registration racing an activation
    # must not widen the same semaphore twice.
    with _STATE_LOCK:
        if boosted[0]:
            return
        boosted[0] = True
    extra = effective_io_cap(base_cap) - base_cap
    if extra <= 0:
        return

    def _release() -> None:
        for _ in range(extra):
            semaphore.release()

    try:
        loop.call_soon_threadsafe(_release)
    except RuntimeError:
        pass  # loop already closed: nothing left to widen


def activate(budget_s: Optional[float] = None, reason: str = "signal") -> bool:
    """Enter deadline mode; returns False when already active.  Safe to call
    from a signal handler: flips state, widens registered pipelines
    (thread-safe loop callbacks), and leaves the events and the flush
    watcher to a spawned thread."""
    global _ACTIVE
    if budget_s is None:
        budget_s = knobs.get_save_deadline_s()
    with _STATE_LOCK:
        if _ACTIVE:
            return False
        _ACTIVE = True
        activated_at = time.monotonic()
        targets = [t for t in _BOOST_TARGETS if not t[0].is_closed()]
    # Pinned at activation: saves started later belong to whatever the
    # trainer does with its remaining grace, not to this flush's verdict.
    pending = _inflight_saves()
    for loop, semaphore, base_cap, boosted in targets:
        _boost_one(loop, semaphore, base_cap, boosted)
    threading.Thread(
        target=_flush_watch,
        args=(activated_at, budget_s, reason, pending),
        name="tpusnap-torch-preemption-flush",
        daemon=True,
    ).start()
    return True


def deactivate() -> None:
    """Leave deadline mode (tests; production processes die instead)."""
    global _ACTIVE
    with _STATE_LOCK:
        _ACTIVE = False
        _BOOST_TARGETS.clear()


def _inflight_saves() -> List[Any]:
    from .telemetry import monitor as tmonitor

    return [m for m in tmonitor.active_ops() if m.kind in ("take", "async_take")]


def _flush_watch(begin: float, budget_s: float, reason: str, pending: List[Any]) -> None:
    """Emits the flush bracket events and watches the saves in flight at
    activation race the deadline.  "Success" means every one of them reached
    a terminal state inside the budget; commit or failure is the save's own
    event's business."""
    log_event(
        Event(
            name="preemption.flush.start",
            metadata={
                "action": "preemption.flush",
                "reason": reason,
                "budget_s": budget_s,
                "inflight_saves": len(pending),
            },
        )
    )
    logger.warning(
        "preemption: entering save-deadline mode (%s): %.1fs budget, %d save(s) "
        "in flight; io concurrency boosted",
        reason,
        budget_s,
        len(pending),
    )
    deadline = begin + budget_s
    while time.monotonic() < deadline:
        if all(m.done for m in pending):
            break
        time.sleep(0.05)
    leftover = [m for m in pending if not m.done]
    duration = time.monotonic() - begin
    log_event(
        Event(
            name="preemption.flush.end",
            metadata={
                "action": "preemption.flush",
                "reason": reason,
                "budget_s": budget_s,
                "duration_s": round(duration, 4),
                "is_success": not leftover,
                "inflight_saves": len(leftover),
            },
        )
    )
    if leftover:
        logger.error(
            "preemption: %d save(s) still in flight after the %.1fs deadline "
            "budget; the snapshot may be lost to the kill",
            len(leftover),
            budget_s,
        )
    else:
        logger.warning(
            "preemption: all in-flight saves reached a terminal state in %.2fs "
            "(budget %.1fs)",
            duration,
            budget_s,
        )


class PreemptionHandler:
    """Handle for an installed preemption signal handler."""

    def __init__(self, signum: int, previous: Any) -> None:
        self.signum = signum
        self._previous = previous
        self._installed = True

    def uninstall(self) -> None:
        """Restore the previous handler (idempotent)."""
        if not self._installed:
            return
        self._installed = False
        signal.signal(self.signum, self._previous)


def install_handler(signum: Optional[int] = None, chain: bool = True) -> PreemptionHandler:
    """Register the emergency-flush handler (main thread only, a CPython
    ``signal.signal`` constraint).  ``chain=True`` forwards the signal to a
    pre-existing *callable* handler after activating deadline mode; SIG_DFL
    termination is deliberately not chained: surviving the SIGTERM is the
    point of the grace window."""
    if signum is None:
        signum = signal.SIGTERM
    previous = signal.getsignal(signum)

    def _handler(num: int, frame: Any) -> None:
        activate(reason=f"signal {num}")
        if chain and callable(previous) and previous not in (signal.SIG_IGN, signal.SIG_DFL):
            previous(num, frame)

    signal.signal(signum, _handler)
    return PreemptionHandler(signum, previous)
