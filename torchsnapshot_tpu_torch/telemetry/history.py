"""Step-history regression tracking under a SnapshotManager root.

Counterpart of ``torchsnapshot_tpu/telemetry/history.py``, with the same
file and line format, so either package's manager appends to and reads
the other's history.  Every committed save appends one JSON line to
``<root>/telemetry/history.jsonl``: a compact summary of that save's
telemetry sidecar (duration, bytes, GB/s, dominant phases, RSS high
water).  The file outlives the snapshots retention prunes, so "did this
step regress against the last fifty" stays answerable.

Regression detection runs at append time: a save whose duration exceeds
``TPUSNAP_REGRESSION_FACTOR`` (default 2.0, 0 disables) times the median
of the trailing ``TPUSNAP_REGRESSION_WINDOW`` same-action entries emits a
``telemetry.regression`` event and flags the line.

Appends are rank 0's, best-effort (a read-only root is a log line, never a
failed save), serialized in-process, bounded to
:data:`MAX_HISTORY_ENTRIES`, and ride the root's storage plugin.
"""

from __future__ import annotations

import json
import logging
import statistics
import threading
import time
from typing import Any, Dict, List, Optional

from .. import knobs
from ..event import Event
from ..event_handlers import log_event

logger = logging.getLogger(__name__)

HISTORY_PATH = "telemetry/history.jsonl"
# Below this many prior same-action entries the median is noise.
MIN_BASELINE_ENTRIES = 5
# The file is rewritten whole on each append (storage plugins have no
# append), so the oldest entries roll off past this count.
MAX_HISTORY_ENTRIES = 1000

# Appends are read-modify-write: an async save's completion thread racing
# the next sync save must not lose a line.
_APPEND_LOCK = threading.Lock()


def summarize_sidecar(doc: Dict[str, Any], step: Optional[int] = None) -> Dict[str, Any]:
    """One compact history entry from a telemetry sidecar document."""
    phases = doc.get("phases") or {}
    top = sorted(phases.items(), key=lambda kv: -kv[1].get("wall", kv[1].get("s", 0.0)))[:4]
    entry: Dict[str, Any] = {
        "timestamp": doc.get("timestamp", time.time()),
        "step": step,
        "action": doc.get("action", "?"),
        "op_id": str(doc.get("op_id", ""))[:8],
        "rank": doc.get("rank", 0),
        "duration_s": doc.get("duration_s", 0.0),
        "bytes": doc.get("bytes", 0),
        "throughput_gbps": doc.get("throughput_gbps"),
        "top_phases": {name: round(v.get("wall", v.get("s", 0.0)), 4) for name, v in top},
    }
    for key in ("rss_high_water_bytes", "staging_mode", "stall_s", "cas", "cache", "barrier"):
        if key in doc:
            entry[key] = doc[key]
    return entry


def read(storage) -> List[Dict[str, Any]]:
    """The root's history entries; [] when absent.  Unparseable lines (a
    torn append) are skipped."""
    from ..io_types import ReadIO

    read_io = ReadIO(path=HISTORY_PATH)
    try:
        storage.sync_read(read_io)
    except Exception:  # noqa: BLE001 — no history yet
        return []
    entries: List[Dict[str, Any]] = []
    for line in bytes(read_io.buf).decode("utf-8", errors="replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            entries.append(json.loads(line))
        except json.JSONDecodeError:
            logger.debug("skipping unparseable history line: %r", line[:120])
    return entries


def detect_regression(entries: List[Dict[str, Any]], new_entry: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The trailing-window median check of the entry about to be appended:
    the regression record (median, factor, window, ratio), or None."""
    factor = knobs.get_regression_factor()
    if factor <= 0:
        return None
    window = knobs.get_regression_window()
    same_action = [
        e
        for e in entries
        if e.get("action") == new_entry.get("action") and isinstance(e.get("duration_s"), (int, float))
    ][-window:]
    if len(same_action) < MIN_BASELINE_ENTRIES:
        return None
    median = statistics.median(e["duration_s"] for e in same_action)
    duration = new_entry.get("duration_s") or 0.0
    if median <= 0 or duration <= factor * median:
        return None
    return {
        "median_s": round(median, 4),
        "factor": factor,
        "window": len(same_action),
        "ratio": round(duration / median, 3),
    }


def append(storage, entry: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Append one entry to the root's history, checking it against the
    trailing window first.  Returns the regression record if one fired.
    Best-effort: a failure logs and returns None."""
    try:
        with _APPEND_LOCK:
            return _append_locked(storage, entry)
    except Exception:  # noqa: BLE001 — history never fails a save
        logger.warning("failed to append step history entry", exc_info=True)
        return None


def _append_locked(storage, entry: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    from ..io_types import WriteIO

    entries = read(storage)
    regression = detect_regression(entries, entry)
    if regression is not None:
        entry = dict(entry)
        entry["regression"] = regression
        log_event(
            Event(
                name="telemetry.regression",
                metadata={
                    "action": entry.get("action", "?"),
                    "step": entry.get("step"),
                    "rank": entry.get("rank", 0),
                    "duration_s": entry.get("duration_s"),
                    **regression,
                },
            )
        )
        logger.warning(
            "save regression: step %s %s took %.2fs vs trailing median %.2fs "
            "(%.1fx, threshold %.1fx over %d entries)",
            entry.get("step"),
            entry.get("action"),
            entry.get("duration_s") or 0.0,
            regression["median_s"],
            regression["ratio"],
            regression["factor"],
            regression["window"],
        )
    kept = entries[-(MAX_HISTORY_ENTRIES - 1) :] + [entry]
    payload = "".join(json.dumps(e, sort_keys=True) + "\n" for e in kept)
    storage.sync_write(WriteIO(path=HISTORY_PATH, buf=payload.encode("utf-8")))
    return regression


def render(entries: List[Dict[str, Any]], limit: int = 50) -> str:
    """A trend table, newest last, regressions flagged, with a duration
    bar so drift shows without a plot."""
    if not entries:
        return (
            "no step history (telemetry/history.jsonl absent — saves "
            "predate history tracking, sidecars are disabled, or this is "
            "not a SnapshotManager root)"
        )
    shown = entries[-limit:]
    max_dur = max((e.get("duration_s") or 0.0 for e in shown), default=0.0)
    lines = [f"{'step':>8} {'action':>10} {'duration':>9} {'size':>9} {'GB/s':>6}  trend"]
    for e in shown:
        dur = e.get("duration_s") or 0.0
        bar = "#" * int(round(20 * dur / max_dur)) if max_dur > 0 else ""
        gbps = e.get("throughput_gbps")
        flag = ""
        cas = e.get("cas")
        if isinstance(cas, dict) and cas.get("logical_bytes"):
            physical = cas.get("physical_bytes_written", 0)
            flag = f"  dedup={cas['logical_bytes'] / physical:.1f}x" if physical else "  dedup=all"
        cache = e.get("cache")
        if isinstance(cache, dict):
            hit = int(cache.get("hit_bytes", 0) or 0)
            miss = int(cache.get("miss_bytes", 0) or 0)
            if hit or miss:
                flag += f"  cache={hit / (hit + miss):.0%}"
        if "regression" in e:
            flag += f"  << REGRESSION {e['regression'].get('ratio', '?')}x median"
        lines.append(
            f"{str(e.get('step', '-')):>8} {e.get('action', '?'):>10} "
            f"{dur:>8.2f}s {(e.get('bytes') or 0) / 1e9:>8.2f}G "
            f"{gbps if gbps is not None else '-':>6}  {bar}{flag}"
        )
    n_reg = sum(1 for e in entries if "regression" in e)
    lines.append(f"{len(entries)} entr{'y' if len(entries) == 1 else 'ies'} total, {n_reg} regression(s)")
    return "\n".join(lines)
