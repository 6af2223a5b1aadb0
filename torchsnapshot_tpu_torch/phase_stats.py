"""Per-phase time/byte attribution for the checkpoint pipeline.

Counterpart of ``torchsnapshot_tpu/phase_stats.py`` with its tracing hook,
its flight-recorder observer hook and :func:`last_phase`, and without the
profiler's thread tags.  Per phase (``d2h``,
``h2d_dispatch``, ``h2d_land``, ``checksum``, ``native_write_hash``,
``fs_read`` ...) it accumulates **thread-seconds** (``s``: summed over
concurrent workers), **bytes**, a count, and **wall-seconds** (``wall``:
the union of the phase's active intervals — the honest share of elapsed
time when several workers run one phase at once).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Generator, List, Optional, Tuple

_lock = threading.Lock()
_stats: Dict[str, Dict[str, float]] = {}
_intervals: Dict[str, List[Tuple[float, float]]] = {}
# Wall seconds of intervals retired from _intervals by compaction.  Only
# intervals ending before the earliest in-flight timed() begin of the phase
# are retired, so no running block can later add an interval overlapping
# the retired region.  Raw add() intervals are clamped at the phase's
# retired high-water mark for the same reason.
_wall_base: Dict[str, float] = {}
_retired_hwm: Dict[str, float] = {}
# begin stamps of in-flight timed() blocks, per phase.
_active_begins: Dict[str, Dict[object, float]] = {}

# Compact a phase's interval list past this length: a long-lived trainer
# adds one interval per payload per phase per snapshot.
_COMPACT_THRESHOLD = 512

# Tracer hook (telemetry/trace.py): while a traced operation collects,
# every recorded interval is forwarded as hook(phase, begin, end, nbytes)
# (time.monotonic stamps) and becomes a leaf span.  None, the default,
# costs one read per add().
_trace_hook: Optional[Callable[[str, float, float, int], None]] = None


# Flight-recorder observer (telemetry/blackbox.py): a second slot with the
# trace hook's contract, installed once for the process lifetime where the
# tracer's is installed and removed around each traced operation.
_observer_hook: Optional[Callable[[str, float, float, int], None]] = None

# The most recently recorded phase: where the pipeline was, for a heartbeat
# or a crash record.  Written without the lock (a str swap is atomic).
_last_phase: Optional[str] = None


def set_trace_hook(hook: Optional[Callable[[str, float, float, int], None]]) -> None:
    global _trace_hook
    _trace_hook = hook


def set_observer_hook(hook: Optional[Callable[[str, float, float, int], None]]) -> None:
    global _observer_hook
    _observer_hook = hook


def last_phase() -> Optional[str]:
    """Name of the most recently recorded phase (None before any)."""
    return _last_phase


def add(
    phase: str,
    seconds: float,
    nbytes: int = 0,
    end: Optional[float] = None,
    _release_token: Optional[object] = None,
) -> None:
    """Record one occurrence of ``phase`` that ended at ``end`` (a
    ``time.monotonic`` stamp, default now) and lasted ``seconds``."""
    global _last_phase
    if end is None:
        end = time.monotonic()
    begin = end - seconds
    _last_phase = phase
    with _lock:
        if _release_token is not None:
            actives = _active_begins.get(phase)
            if actives is not None:
                actives.pop(_release_token, None)
                if not actives:
                    del _active_begins[phase]
        else:
            hwm = _retired_hwm.get(phase)
            if hwm is not None and begin < hwm:
                begin = min(hwm, end)
        slot = _stats.setdefault(phase, {"s": 0.0, "bytes": 0, "n": 0})
        slot["s"] += seconds
        slot["bytes"] += nbytes
        slot["n"] += 1
        ivs = _intervals.setdefault(phase, [])
        ivs.append((begin, end))
        if len(ivs) >= _COMPACT_THRESHOLD:
            merged = _merge(ivs)
            if len(merged) >= _COMPACT_THRESHOLD // 2:
                keep = _COMPACT_THRESHOLD // 4
                low_water = min(
                    _active_begins.get(phase, {}).values(), default=float("inf")
                )
                retire_n = min(
                    len(merged) - keep,
                    sum(1 for _, e in merged if e <= low_water),
                )
                if retire_n > 0:
                    retired, merged = merged[:retire_n], merged[retire_n:]
                    _wall_base[phase] = _wall_base.get(phase, 0.0) + sum(
                        e - b for b, e in retired
                    )
                    _retired_hwm[phase] = retired[-1][1]
            _intervals[phase] = merged
    for hook in (_trace_hook, _observer_hook):
        if hook is not None:
            try:
                hook(phase, begin, end, nbytes)
            except Exception:  # noqa: BLE001 — telemetry never breaks the pipeline
                pass


@contextmanager
def timed(phase: str, nbytes: int = 0) -> Generator[None, None, None]:
    begin = time.monotonic()
    token = object()
    with _lock:
        _active_begins.setdefault(phase, {})[token] = begin
    try:
        yield
    finally:
        end = time.monotonic()
        add(phase, end - begin, nbytes, end=end, _release_token=token)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Exact union of intervals as a sorted disjoint list."""
    merged: List[Tuple[float, float]] = []
    for begin, end in sorted(intervals):
        if merged and begin <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((begin, end))
    return merged


def _union_s(intervals: List[Tuple[float, float]]) -> float:
    return sum(end - begin for begin, end in _merge(intervals))


def snapshot() -> Dict[str, Dict[str, float]]:
    with _lock:
        out = {k: dict(v) for k, v in _stats.items()}
        for phase, ivs in _intervals.items():
            out[phase]["wall"] = _wall_base.get(phase, 0.0) + _union_s(ivs)
    return out


def reset() -> None:
    with _lock:
        _stats.clear()
        _intervals.clear()
        _wall_base.clear()
        _retired_hwm.clear()


def delta(before: Dict[str, Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    """Difference between now and an earlier :func:`snapshot`."""
    out: Dict[str, Dict[str, float]] = {}
    for phase, now in snapshot().items():
        prev = before.get(phase, {})
        d = {k: now[k] - prev.get(k, 0) for k in now}
        if d["n"]:
            out[phase] = d
    return out


def format_line(stats: Dict[str, Dict[str, float]]) -> str:
    """One-line rendering: phase=1.2s(3.4s-cpu)/4.5GB(3.7GB/s), rate over
    wall seconds."""
    parts = []
    for phase in sorted(stats, key=lambda p: -stats[p]["s"]):
        s = stats[phase]["s"]
        wall = stats[phase].get("wall", s)
        b = stats[phase]["bytes"]
        head = f"{phase}={wall:.2f}s"
        if s - wall > 0.05 * max(wall, 0.01):
            head += f"({s:.2f}s-cpu)"
        if b and wall > 0:
            head += f"/{b / 1e9:.2f}GB({b / 1e9 / wall:.1f}GB/s)"
        parts.append(head)
    return " ".join(parts) if parts else "no phases recorded"
