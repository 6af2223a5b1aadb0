"""Pipeline health monitor: live progress, stall watchdog, heartbeat.

Counterpart of ``torchsnapshot_tpu/telemetry/monitor.py`` without its
fleet-telemetry and sampling-profiler calls (the port has neither module
yet, so a stall bundle has no sampled-profile section).  Its progress
document, heartbeat document, bundle section names, ``watchdog.stall``
event and metric families are the JAX package's.

- **Live progress**: every take, async_take, restore and read_object
  registers an :class:`OpMonitor`; the scheduler's per-pipeline reporters
  attach to the innermost active one.  :meth:`OpMonitor.progress`
  aggregates them (requests and bytes staged and written, pipeline-state
  counts, budget, ETA, RSS high water), surfaced as
  ``PendingSnapshot.progress()`` and the ``tpusnap_progress_*`` gauges.
- **Stall watchdog**: with ``TPUSNAP_STALL_TIMEOUT_S`` > 0 a per-op daemon
  thread fingerprints the counters each tick; when nothing advances for
  the timeout it writes a diagnostic bundle (pipeline states, budget,
  pending asyncio tasks, ``faulthandler`` stacks of every thread) next to
  the trace directory, emits ``watchdog.stall`` (→ ``tpusnap_stalls_total``)
  and, with ``TPUSNAP_STALL_ESCALATE=1``, reports the stall through the
  commit barrier's store so peers blocked there raise ``StorePeerError``.
  It re-arms when progress resumes.
- **Heartbeat**: with ``TPUSNAP_HEARTBEAT_FILE`` set the monitor thread
  rewrites that file atomically with the progress snapshot every tick,
  for supervisors that must tell "slow" from "dead" from outside.
- **Flight recorder**: with ``TPUSNAP_BLACKBOX`` set the thread also
  spills a progress record to the ring (telemetry/blackbox.py) each tick.

With every knob unset no thread starts: one small object per operation.
"""

from __future__ import annotations

import asyncio
import faulthandler
import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .. import knobs, phase_stats, rss_profiler
from ..event import Event
from ..event_handlers import log_event
from . import blackbox

logger = logging.getLogger(__name__)

_LOCK = threading.Lock()
# Stack of active ops; scheduler reporters attach to the innermost.
_ACTIVE: List["OpMonitor"] = []

_MIN_TICK_S = 0.02
_MAX_TICK_S = 60.0
STALL_BUNDLE_PREFIX = "stall-"

# phase_stats phases that accumulate while the pipeline goes nowhere:
# counting them as progress would blind the watchdog to a budget-blocked
# pipeline behind hung storage.
_NON_PROGRESS_PHASES = frozenset({"budget_wait"})


class OpMonitor:
    """Health-monitoring state for one operation.  The object always
    exists (progress must be answerable for every op); its tick thread
    starts only when the watchdog, the heartbeat or the recorder is on."""

    def __init__(self, kind: str, op_id: str, rank: int, watchdog: bool = True) -> None:
        self.kind = kind
        self.op_id = op_id
        self.rank = rank
        self._begin = time.monotonic()
        self._reporters_lock = threading.Lock()
        # Scheduler _ProgressReporter objects (duck-typed: verb, total,
        # staged, io_done, bytes_staged, bytes_done and the pipeline-state
        # attributes maybe_report refreshes).
        self._reporters: List[Any] = []
        self.watermark = rss_profiler.RSSWatermark()
        # Escalation channel: PendingSnapshot points it at its commit
        # barrier's report_error once that barrier exists.
        self.escalate: Optional[Callable[[str], None]] = None
        self.stall_count = 0
        self.stall_bundle_path: Optional[str] = None
        self.done = False
        self.success: Optional[bool] = None
        self._stall_timeout_s = knobs.get_stall_timeout_s() if watchdog else 0.0
        # The heartbeat is a save/restore supervisor's: a read_object
        # (watchdog=False) finishing mid-save must not overwrite the save's
        # heartbeat with its own terminal document.
        self._heartbeat_path = knobs.get_heartbeat_file() if watchdog else None
        self._blackbox = blackbox.enabled()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self._stall_timeout_s > 0 or self._heartbeat_path or self._blackbox:
            self._thread = threading.Thread(target=self._run, name=f"tpusnap-torch-monitor-{kind}", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- feeding

    def attach(self, reporter: Any) -> None:
        with self._reporters_lock:
            self._reporters.append(reporter)

    def _snapshot_reporters(self) -> List[Any]:
        with self._reporters_lock:
            return list(self._reporters)

    def rss_high_water(self) -> int:
        """High-water RSS, sampled once more now, so an op that never
        ticked still reports an honest watermark."""
        self.watermark.sample()
        return self.watermark.high_water

    # ------------------------------------------------------------ progress

    def progress(self) -> Dict[str, Any]:
        """Machine-readable progress snapshot of this operation."""
        reporters = self._snapshot_reporters()
        elapsed = time.monotonic() - self._begin
        total = staged = done = bytes_staged = bytes_done = 0
        pipelines: List[Dict[str, Any]] = []
        for r in reporters:
            total += r.total
            staged += r.staged
            done += r.io_done
            bytes_staged += r.bytes_staged
            bytes_done += r.bytes_done
            budget = getattr(r, "budget", None)
            pipelines.append(
                {
                    "verb": r.verb,
                    "requests_total": r.total,
                    "requests_staged": r.staged,
                    "requests_done": r.io_done,
                    "bytes_staged": r.bytes_staged,
                    "bytes_done": r.bytes_done,
                    "pending": getattr(r, "pending", 0),
                    "staging": getattr(r, "staging", 0),
                    "inflight_io": getattr(r, "inflight_io", 0),
                    "budget_in_use_bytes": budget.in_use if budget is not None else None,
                    "budget_total_bytes": budget.total if budget is not None else None,
                }
            )
        eta_s = None
        if not self.done and done and total > done and elapsed > 0:
            # Requests-based: total bytes are not known up front.
            eta_s = round((total - done) * (elapsed / done), 3)
        return {
            "action": self.kind,
            "op_id": self.op_id,
            "rank": self.rank,
            "elapsed_s": round(elapsed, 3),
            "requests": {"total": total, "staged": staged, "written": done},
            "bytes": {"staged": bytes_staged, "written": bytes_done},
            "eta_s": eta_s,
            "pipelines": pipelines,
            "rss_high_water_bytes": self.watermark.high_water,
            "stalls": self.stall_count,
            "stall_bundle": self.stall_bundle_path,
            "done": self.done,
            "success": self.success,
        }

    # ------------------------------------------------------------ watchdog

    def _fingerprint(self) -> tuple:
        """Anything that changes while the pipeline makes progress: the
        scheduler counters, and the phase_stats occurrence counts, which
        catch progress inside one payload (a multi-chunk D2H, a retrying
        write) so a slow but advancing op never looks stalled."""
        reporters = self._snapshot_reporters()
        parts: List[Any] = [len(reporters)]
        for r in reporters:
            parts.extend(
                (
                    r.staged,
                    r.io_done,
                    r.bytes_staged,
                    r.bytes_done,
                    getattr(r, "pending", 0),
                    getattr(r, "staging", 0),
                    getattr(r, "inflight_io", 0),
                )
            )
        # phase_stats is process-global: another op's activity would keep
        # re-arming this watchdog, so it counts only when this op is the
        # sole one monitored.
        with _LOCK:
            sole = len(_ACTIVE) == 1 and _ACTIVE[0] is self
        if sole:
            stats = phase_stats.snapshot()
            parts.append(sum(int(v.get("n", 0)) for k, v in stats.items() if k not in _NON_PROGRESS_PHASES))
        return tuple(parts)

    def _tick_interval_s(self) -> float:
        candidates = []
        if self._stall_timeout_s > 0:
            candidates.append(self._stall_timeout_s / 4.0)
        if self._heartbeat_path or self._blackbox:
            candidates.append(min(knobs.get_progress_interval_s() or 5.0, 5.0))
        return max(_MIN_TICK_S, min(min(candidates), _MAX_TICK_S))

    def _run(self) -> None:
        tick = self._tick_interval_s()
        last_fp = self._fingerprint()
        last_change = time.monotonic()
        fired = False
        while not self._stop.wait(tick):
            self.watermark.sample()
            if self._heartbeat_path:
                self._write_heartbeat()
            if self._blackbox:
                self._record_blackbox_progress()
            if self._stall_timeout_s <= 0:
                continue
            fp = self._fingerprint()
            now = time.monotonic()
            if fp != last_fp:
                last_fp = fp
                last_change = now
                fired = False  # progress resumed: re-arm
                continue
            idle_s = now - last_change
            if idle_s >= self._stall_timeout_s and not fired:
                fired = True  # once per quiet period
                self._on_stall(idle_s)
        if self._heartbeat_path:
            self._write_heartbeat()  # the terminal heartbeat carries done/success

    def _on_stall(self, idle_s: float) -> None:
        self.stall_count += 1
        self.stall_bundle_path = self._dump_bundle(idle_s) or self.stall_bundle_path
        escalated = False
        if knobs.stall_escalate_enabled() and self.escalate is not None:
            try:
                self.escalate(
                    f"rank {self.rank}: {self.kind} op {self.op_id[:8]} "
                    f"stalled for {idle_s:.1f}s (watchdog escalation)"
                )
                escalated = True
            except Exception:  # noqa: BLE001 — diagnosis goes on
                logger.warning("stall escalation failed", exc_info=True)
        log_event(
            Event(
                name="watchdog.stall",
                metadata={
                    "action": self.kind,
                    "unique_id": self.op_id,
                    "rank": self.rank,
                    "idle_s": round(idle_s, 3),
                    "bundle": self.stall_bundle_path,
                    "escalated": escalated,
                },
            )
        )
        logger.error(
            "[rank %d] %s op %s appears STALLED: no pipeline progress for "
            "%.1fs (timeout %.1fs); diagnostic bundle: %s%s",
            self.rank,
            self.kind,
            self.op_id[:8],
            idle_s,
            self._stall_timeout_s,
            self.stall_bundle_path or "<bundle write failed>",
            "; escalated to peers" if escalated else "",
        )

    # ----------------------------------------------------------- artifacts

    def _bundle_dir(self) -> str:
        trace_dir = knobs.get_trace_dir()
        if trace_dir is not None:
            return trace_dir
        if self._heartbeat_path:
            return os.path.dirname(os.path.abspath(self._heartbeat_path))
        return tempfile.gettempdir()

    def _dump_bundle(self, idle_s: float) -> Optional[str]:
        bundle_dir = self._bundle_dir()
        fname = f"{STALL_BUNDLE_PREFIX}{self.kind}-{self.op_id[:8]}-rank{self.rank}-{self.stall_count}.txt"
        path = os.path.join(bundle_dir, fname)
        try:
            os.makedirs(bundle_dir, exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                f.write("=== tpusnap stall diagnostic bundle ===\n")
                f.write(
                    f"op: {self.kind} {self.op_id} rank {self.rank}\n"
                    f"idle: {idle_s:.3f}s (stall timeout {self._stall_timeout_s}s)\n"
                    f"wall clock: {time.strftime('%Y-%m-%dT%H:%M:%S%z')}\n\n"
                )
                f.write("--- progress ---\n")
                json.dump(self.progress(), f, indent=1)
                f.write("\n\n--- pipeline states ---\n")
                for line in self._pipeline_state_lines():
                    f.write(line + "\n")
                f.write("\n--- pending asyncio tasks ---\n")
                for line in self._asyncio_task_lines():
                    f.write(line + "\n")
                f.write("\n--- thread stacks (faulthandler) ---\n")
                f.flush()
                faulthandler.dump_traceback(file=f)
            return path
        except OSError:
            logger.warning("failed to write stall bundle %s", path, exc_info=True)
            return None

    def _pipeline_state_lines(self) -> List[str]:
        lines: List[str] = []
        for r in self._snapshot_reporters():
            lines.append(
                f"[{r.verb}] total={r.total} staged={r.staged} "
                f"done={r.io_done} pending={getattr(r, 'pending', 0)} "
                f"staging={getattr(r, 'staging', 0)} "
                f"inflight_io={getattr(r, 'inflight_io', 0)} "
                f"bytes_staged={r.bytes_staged} bytes_done={r.bytes_done}"
            )
            budget = getattr(r, "budget", None)
            if budget is not None:
                lines.append(
                    f"  budget: in_use={budget.in_use} "
                    f"remaining={budget.remaining} total={budget.total} "
                    f"staging_inflight={budget.inflight}"
                )
            # Which paths are parked where, snapshotted best-effort: the
            # event loop mutates these containers concurrently, and a racing
            # resize costs this section, never the pipeline.
            for label, getter in (getattr(r, "debug_refs", None) or {}).items():
                try:
                    paths = list(getter())
                except Exception:  # noqa: BLE001
                    continue
                shown = ", ".join(str(p) for p in paths[:8])
                suffix = f" (+{len(paths) - 8} more)" if len(paths) > 8 else ""
                lines.append(f"  {label} ({len(paths)}): {shown}{suffix}")
        if not lines:
            lines.append(
                "(no scheduler pipeline attached yet — the op is in "
                "planning, device staging, a collective barrier, or the "
                "metadata commit; see thread stacks below)"
            )
        return lines

    def _asyncio_task_lines(self) -> List[str]:
        lines: List[str] = []
        loops = {getattr(r, "loop", None) for r in self._snapshot_reporters()} - {None}
        for loop in loops:
            tasks = None
            for _ in range(2):
                try:
                    tasks = list(asyncio.all_tasks(loop))
                    break
                except RuntimeError:
                    # all_tasks iterates a WeakSet the loop thread mutates:
                    # one retry, then this loop's section is skipped.
                    tasks = None
            if tasks is None:
                lines.append("  <asyncio task set unreadable (loop busy)>")
                continue
            for task in tasks[:64]:
                try:
                    coro = task.get_coro()
                    where = getattr(coro, "__qualname__", repr(coro))
                    lines.append(f"  {task.get_name()}: {where} done={task.done()}")
                except Exception:  # noqa: BLE001
                    continue
        if not lines:
            lines.append("(no scheduler event loop attached)")
        return lines

    def _record_blackbox_progress(self) -> None:
        """A compact progress record in the flight recorder: the last one
        before a kill -9 says how far the op got."""
        doc = self.progress()
        blackbox.record(
            "progress",
            self.kind,
            {
                "op_id": self.op_id,
                "rank": self.rank,
                "elapsed_s": doc["elapsed_s"],
                "phase": phase_stats.last_phase(),
                "requests": doc["requests"],
                "bytes": doc["bytes"],
                "stalls": doc["stalls"],
            },
        )

    def _write_heartbeat(self) -> None:
        path = self._heartbeat_path
        if not path:
            return
        try:
            from . import trace as ttrace

            doc = self.progress()
            doc["heartbeat_time"] = time.time()
            # Correlation keys: a frozen heartbeat names the op kind, its
            # trace id and the phase it froze in.
            doc["op_kind"] = self.kind
            doc["trace_id"] = ttrace.trace_id_for(self.op_id)
            doc["phase"] = phase_stats.last_phase()
            # A tmp name per thread: concurrent ops share one heartbeat path
            # and one pid, and a shared tmp would rename torn JSON in place.
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            # A liveness beacon rewritten every tick: an fsync per tick would
            # cost real I/O to protect one missed probe interval.
            os.replace(tmp, path)  # tpusnap-lint: disable=durability-flow
        except OSError:
            logger.debug("failed to write heartbeat %s", path, exc_info=True)

    # ----------------------------------------------------------- lifecycle

    def finish(self, success: bool) -> None:
        self.done = True
        self.success = success
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        # Release the scheduler containers the debug closures (and the
        # closed event loop) pin: a caller holding a PendingSnapshot must not
        # keep every pipeline object alive through this monitor.  The plain
        # counters stay, so progress() keeps its terminal numbers.
        for reporter in self._snapshot_reporters():
            try:
                reporter.debug_refs = None
                reporter.loop = None
            except AttributeError:
                pass


# ------------------------------------------------------------- module API


def op_started(kind: str, op_id: str, rank: int, watchdog: bool = True) -> OpMonitor:
    """Register (and return) the monitor of one operation.  ``watchdog``
    False (read_object, the peer daemon's ops) keeps the progress registry
    right without a stall thread or heartbeat."""
    blackbox.maybe_install()
    mon = OpMonitor(kind, op_id, rank, watchdog=watchdog)
    with _LOCK:
        _ACTIVE.append(mon)
    blackbox.record("op", f"{kind}.start", {"op_id": op_id, "rank": rank})
    return mon


def op_finished(mon: Optional[OpMonitor], success: bool = True) -> None:
    """Stop monitoring; idempotent (error paths may finish twice).  The
    monitor stays readable: ``progress()`` after the end reports the
    terminal counters with ``done: true``."""
    if mon is None:
        return
    with _LOCK:
        try:
            _ACTIVE.remove(mon)
        except ValueError:
            return  # already finished
    mon.finish(success)
    blackbox.record("op", f"{mon.kind}.end", {"op_id": mon.op_id, "rank": mon.rank, "success": success})


def active_ops() -> List[OpMonitor]:
    """Every operation currently monitored (the preemption flush watcher
    reads it to see when the saves in flight have all ended).  Lock-free:
    the SIGTERM handler calls it between two bytecodes of a thread that
    may hold ``_LOCK``, and copying a list is atomic under the GIL."""
    return list(_ACTIVE)


def current() -> Optional[OpMonitor]:
    # Unlocked read: a racing reader attaches to (or misses) an op being
    # torn down; the except covers the list emptying between check and index.
    try:
        return _ACTIVE[-1]
    except IndexError:
        return None


def attach_reporter(reporter: Any) -> None:
    """Attach a scheduler progress reporter to the innermost active op
    (no-op when none is monitored)."""
    mon = current()
    if mon is not None:
        mon.attach(reporter)
