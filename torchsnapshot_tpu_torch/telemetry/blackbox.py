"""Crash-surviving flight recorder: a bounded per-process event ring.

Counterpart of ``torchsnapshot_tpu/telemetry/blackbox.py``, byte for byte
in its file format, so a ring either package writes is read by the other
(and by the JAX package's ``postmortem``).  Sidecars, history and traces
publish at the end of an operation; a ``kill -9`` mid-take leaves only
filesystem debris.  This module spills the most recent events, phase
transitions, lease changes and progress snapshots *as they happen* into
``$TPUSNAP_BLACKBOX/<host>-<pid>.ring`` (convention:
``<root>/telemetry/blackbox``).

- **Survives any death.**  A record is ONE ``os.pwrite`` of exactly
  ``TPUSNAP_BLACKBOX_SLOT_BYTES`` bytes at a seq-derived offset: once the
  call returns the bytes are in the page cache and survive ``os._exit`` or
  SIGKILL (only a host crash loses them; there is no fsync on the hot
  path).  A reader drops at most the one slot torn mid-write.
- **Bounded.**  ``TPUSNAP_BLACKBOX_SLOTS`` slots, overwritten modulo the
  ring size: the file never grows past ``slots x slot_bytes`` (256 KiB at
  the defaults).
- **Cheap.**  One JSON encode and one pwrite per record, no lock shared
  with the pipeline, every entry point swallows its own exceptions;
  :func:`calibrated_overhead_s` measures the per-record cost.

Record format: each slot is a newline-terminated, space-padded JSON object
``{"seq", "t" (wall clock), "host", "pid", "kind", "name", "data"?}``.
The JSON holds no newline, so a reader splits on newlines, parses each
line, drops what does not parse (the torn slot) and sorts by ``seq``.

Feeds (installed by :func:`maybe_install`, which the monitor's
``op_started`` calls): the ``log_event`` fan-out, a ``phase_stats``
observer hook (phase *transitions*), and direct :func:`record` calls from
the monitor (op start and end, periodic progress), ``dist_store`` (lease
acquire and release, dead-peer verdicts), ``store.py`` (writer and sweep
leases) and ``faults.py`` (the injected crash, written just before
``os._exit``).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from .. import event_handlers, knobs, phase_stats
from . import metrics as tmetrics

_HOST = socket.gethostname()


class Ring:
    """One slotted ring file.  The module-level recorder wraps one for the
    live process; :func:`calibrated_overhead_s` and tests build their own."""

    def __init__(
        self,
        directory: str,
        slots: Optional[int] = None,
        slot_bytes: Optional[int] = None,
    ) -> None:
        self.directory = directory
        self.slots = slots or knobs.get_blackbox_slots()
        self.slot_bytes = slot_bytes or knobs.get_blackbox_slot_bytes()
        self.pid = os.getpid()
        self.path = os.path.join(directory, f"{_HOST}-{self.pid}.ring")
        os.makedirs(directory, exist_ok=True)
        # O_TRUNC: a file already here is a dead process's ring whose pid
        # the kernel recycled; this process's story starts empty.
        self._fd = os.open(self.path, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
        self._lock = threading.Lock()
        self._seq = 0
        self.records_written = 0

    def _encode(self, seq: int, kind: str, name: str, data: Optional[Dict[str, Any]]) -> Optional[bytes]:
        rec: Dict[str, Any] = {
            "seq": seq,
            "t": time.time(),
            "host": _HOST,
            "pid": self.pid,
            "kind": kind,
            "name": str(name),
        }
        if data:
            rec["data"] = data
        buf = json.dumps(rec, separators=(",", ":"), default=str).encode("utf-8", "replace")
        if len(buf) >= self.slot_bytes:
            # Oversized payload: keep the envelope (that it happened, when,
            # in which process), drop the detail.
            rec.pop("data", None)
            rec["name"] = str(name)[:80]
            rec["trunc"] = True
            buf = json.dumps(rec, separators=(",", ":")).encode("utf-8", "replace")
            if len(buf) >= self.slot_bytes:
                return None
        return buf + b" " * (self.slot_bytes - 1 - len(buf)) + b"\n"

    def record(self, kind: str, name: str, data: Optional[Dict[str, Any]] = None) -> bool:
        """Spill one record.  Returns False (never raises) on failure."""
        try:
            with self._lock:
                seq = self._seq
                self._seq += 1
                buf = self._encode(seq, kind, name, data)
                if buf is None:
                    return False
                os.pwrite(self._fd, buf, (seq % self.slots) * self.slot_bytes)
                self.records_written += 1
            return True
        except Exception:  # noqa: BLE001 — the recorder never fails its caller
            _note_spill_error()
            return False

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Process-global recorder

_LOCK = threading.Lock()
_RING: Optional[Ring] = None
_INSTALLED = False
_SPILL_ERROR_NOTED = False
# Reentrancy guard: the event feed must not loop if recording emits an event.
_IN_FEED = threading.local()


def enabled() -> bool:
    """Whether the recorder spills (``TPUSNAP_BLACKBOX`` set)."""
    return knobs.get_blackbox_dir() is not None


def _live_ring() -> Optional[Ring]:
    """The ring for the current (dir, pid): reopened after a fork or a knob
    change, closed (to None) when the knob is unset."""
    global _RING
    directory = knobs.get_blackbox_dir()
    with _LOCK:
        if directory is None:
            if _RING is not None:
                _RING.close()
                _RING = None
            return None
        if _RING is None or _RING.directory != directory or _RING.pid != os.getpid():
            if _RING is not None and _RING.pid == os.getpid():
                _RING.close()
            try:
                _RING = Ring(directory)
            except Exception:  # noqa: BLE001 — counted, never raised
                _note_spill_error()
                return None
        return _RING


def record(kind: str, name: str, data: Optional[Dict[str, Any]] = None) -> bool:
    """Spill one record to this process's ring.  No-op (False) when the
    recorder is off; never raises."""
    try:
        ring = _live_ring()
    except Exception:  # noqa: BLE001
        return False
    if ring is None:
        return False
    ok = ring.record(kind, name, data)
    if ok:
        tmetrics.record_blackbox_record()
    return ok


def ring_path() -> Optional[str]:
    """Path of this process's live ring file, or None when off."""
    ring = _live_ring()
    return ring.path if ring is not None else None


def records_written() -> int:
    """Records this process has spilled to its live ring (0 if none)."""
    with _LOCK:
        return _RING.records_written if _RING is not None else 0


def _note_spill_error() -> None:
    """Count a failed spill; the first one per process also goes out on the
    event fan-out, so a recorder that fails is seen."""
    global _SPILL_ERROR_NOTED
    tmetrics.record_blackbox_spill_error()
    if not _SPILL_ERROR_NOTED:
        _SPILL_ERROR_NOTED = True
        try:
            from ..event import Event

            event_handlers.log_event(Event(name="blackbox.spill_error", metadata={"pid": os.getpid()}))
        except Exception:  # noqa: BLE001
            pass


# ---------------------------------------------------------------------------
# Feeds

_LAST_OBS_PHASE: Optional[str] = None


def _on_event(event: Any) -> None:
    if getattr(_IN_FEED, "active", False):
        return
    _IN_FEED.active = True
    try:
        name = getattr(event, "name", None)
        if not name:
            return
        meta = getattr(event, "metadata", None)
        record("event", name, dict(meta) if isinstance(meta, dict) else None)
    except Exception:  # noqa: BLE001
        pass
    finally:
        _IN_FEED.active = False


def _on_phase(phase: str, begin: float, end: float, nbytes: int) -> None:
    # Phase *transitions*, not every payload: per-payload records would
    # churn the ring through one long phase and evict the op and lease
    # records a postmortem needs.
    global _LAST_OBS_PHASE
    if phase == _LAST_OBS_PHASE:
        return
    _LAST_OBS_PHASE = phase
    record("phase", phase, {"dur_s": round(end - begin, 6), "nbytes": nbytes})


def maybe_install() -> None:
    """Install the passive feeds (event fan-out, phase observer) once per
    process.  Idempotent and cheap; the feeds no-op while the knob is
    unset."""
    global _INSTALLED
    with _LOCK:
        if _INSTALLED:
            return
        _INSTALLED = True
    event_handlers.register_event_handler(_on_event)
    phase_stats.set_observer_hook(_on_phase)


# ---------------------------------------------------------------------------
# Reader (postmortem side)


def read_ring(path: str) -> List[Dict[str, Any]]:
    """Parse one ring file into records sorted by seq.  Torn or garbage
    slots are dropped: that is the format's crash contract."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return []
    records: List[Dict[str, Any]] = []
    for line in raw.split(b"\n"):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "seq" in rec and "kind" in rec:
            records.append(rec)
    records.sort(key=lambda r: r.get("seq", 0))
    return records


def read_all(directory: str) -> Dict[str, List[Dict[str, Any]]]:
    """Every ring under a blackbox directory: ``{path: records}``."""
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return {}
    return {os.path.join(directory, n): read_ring(os.path.join(directory, n)) for n in names if n.endswith(".ring")}


# ---------------------------------------------------------------------------
# Calibration


def calibrated_overhead_s(samples: int = 200) -> Dict[str, float]:
    """Per-record cost measured against a scratch ring, scaled by this
    process's record count (a live in-band timing would itself be the
    overhead it measures)."""
    import shutil
    import tempfile

    scratch = tempfile.mkdtemp(prefix="tpusnap-blackbox-cal-")
    try:
        ring = Ring(scratch)
        payload = {"op_id": "calibration", "rank": 0, "bytes": 123456789}
        begin = time.perf_counter()
        for _ in range(samples):
            ring.record("event", "calibration.sample", payload)
        elapsed = time.perf_counter() - begin
        ring.close()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    per_record = elapsed / max(1, samples)
    n = records_written()
    return {"per_record_s": per_record, "records": float(n), "estimated_s": per_record * n}
