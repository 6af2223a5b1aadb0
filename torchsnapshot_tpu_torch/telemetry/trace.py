"""Span tracer exporting Chrome/Perfetto trace-event JSON.

Counterpart of ``torchsnapshot_tpu/telemetry/trace.py``.  The files are a
contract between the packages: the file name
``<TPUSNAP_TRACE_DIR>/<kind>-<op8>-rank<rank>.trace.json``, the event
fields, the span ids, the W3C ``traceparent`` header a peer fetch sends
and the access log's JSON lines are the JAX package's, so each package's
``validate_trace`` accepts the other's files, either package's
``merge_trace_files`` stitches them, and a client of one package joins
its trace with a daemon of the other.

One *operation* (a take / async_take / restore / read_object) is one trace
file, loadable in Perfetto (ui.perfetto.dev) or ``chrome://tracing``.
Spans are "X" (complete) events carrying the op id, the parent span, a
category, the rank (as ``pid``), the thread (as ``tid``) and byte counts
in ``args``.

Context propagation: the *operation* is process-global (an async_take's
spans keep landing from the background commit thread and the scheduler's
executor workers after the caller returned), while *parent* links use a
contextvar, so nesting is exact within a thread or asyncio task and
degrades to "child of the op root" across thread hops.  ``phase_stats``
forwards every recorded interval through :func:`record_phase` while an op
is collecting, which makes the leaf spans (d2h, checksum, compress,
slab_pack, fs_write/read, h2d_*) without touching those sites.

Disabled (no ``TPUSNAP_TRACE_DIR``): ``begin_op`` returns None without
taking a lock, ``span()`` returns a shared no-op context manager after one
list check, and the phase_stats hook is never installed: the tracer costs
one branch per call site.
"""

from __future__ import annotations

import contextvars
import hashlib
import itertools
import json
import logging
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import knobs, phase_stats

logger = logging.getLogger(__name__)

TRACE_FILE_SUFFIX = ".trace.json"
ACCESS_LOG_SUFFIX = ".access.jsonl"

# Maps time.monotonic() stamps (what phase_stats records) onto the epoch
# clock so per-rank trace files from different processes line up when
# merged (merge_trace_files).
_EPOCH_OFFSET_S = time.time() - time.monotonic()

_ids = itertools.count(1)
_OP_LOCK = threading.Lock()
# Stack of collecting ops; spans attach to the innermost (most recent).
# Plain list; reads are a truthiness check (the disabled-path fast bail).
_ACTIVE: List["_TraceOp"] = []

_parent_span: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "tpusnap_parent_span", default=None
)

# Process-lifetime span count: the calibration meter that
# calibrated_span_cost_s multiplies by the isolated per-span cost.
_SPAN_TOTALS_LOCK = threading.Lock()
_SPANS_RECORDED = 0


def _count_span() -> None:
    global _SPANS_RECORDED
    with _SPAN_TOTALS_LOCK:
        _SPANS_RECORDED += 1


def spans_recorded() -> int:
    return _SPANS_RECORDED


def trace_id_for(op_id: str) -> str:
    """Deterministic 32-hex W3C trace id for an operation: every rank of a
    fleet-wide op derives the same id from the shared op id, so cross-host
    stitching needs no extra coordination."""
    return hashlib.sha256(op_id.encode("utf-8")).hexdigest()[:32]


def enabled() -> bool:
    return knobs.get_trace_dir() is not None


def _now_us() -> float:
    return (time.monotonic() + _EPOCH_OFFSET_S) * 1e6


class _TraceOp:
    """Collection state for one traced operation."""

    def __init__(self, kind: str, op_id: str, rank: int, trace_dir: str) -> None:
        self.kind = kind
        self.op_id = op_id
        self.rank = rank
        self.trace_dir = trace_dir
        self.trace_id = trace_id_for(op_id)
        # Reserved up front: spans with no in-context parent (and outbound
        # traceparent headers sent outside any span) hang off the op root.
        self.root_span_id = next(_ids)
        self.begin_us = _now_us()
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._tids: Dict[int, int] = {}

    def _tid(self) -> int:
        """Small stable per-thread id (+ a thread_name metadata event the
        first time a thread records)."""
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = len(self._tids)
            self._tids[ident] = tid
            self._events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": self.rank,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name},
                }
            )
        return tid

    def add_complete(
        self,
        name: str,
        begin_us: float,
        dur_us: float,
        cat: str,
        args: Dict[str, Any],
    ) -> int:
        span_id = next(_ids)
        args = dict(args)
        args["op"] = self.op_id
        args["span_id"] = span_id
        _count_span()
        with self._lock:
            self._events.append(
                {
                    "name": name,
                    "cat": cat,
                    "ph": "X",
                    "ts": begin_us,
                    "dur": max(dur_us, 0.0),
                    "pid": self.rank,
                    "tid": self._tid(),
                    "args": args,
                }
            )
        return span_id

    def add_instant(self, name: str, args: Dict[str, Any]) -> None:
        args = dict(args)
        args["op"] = self.op_id
        with self._lock:
            self._events.append(
                {
                    "name": name,
                    "cat": "event",
                    "ph": "i",
                    "s": "p",
                    "ts": _now_us(),
                    "pid": self.rank,
                    "tid": self._tid(),
                    "args": args,
                }
            )

    def finish(self, success: bool, extra: Dict[str, Any]) -> Optional[str]:
        end_us = _now_us()
        args = {
            "op": self.op_id,
            "success": success,
            "span_id": self.root_span_id,
            "trace": self.trace_id,
            **extra,
        }
        with self._lock:
            self._events.append(
                {
                    "name": self.kind,
                    "cat": "op",
                    "ph": "X",
                    "ts": self.begin_us,
                    "dur": end_us - self.begin_us,
                    "pid": self.rank,
                    "tid": 0,
                    "args": args,
                }
            )
            self._events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": self.rank,
                    "tid": 0,
                    "args": {"name": f"rank {self.rank}"},
                }
            )
            events = list(self._events)
        payload = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "op": self.op_id,
                "kind": self.kind,
                "rank": self.rank,
                "success": success,
                "trace_id": self.trace_id,
                "host": socket.gethostname(),
            },
        }
        fname = f"{self.kind}-{self.op_id[:8]}-rank{self.rank}{TRACE_FILE_SUFFIX}"
        path = os.path.join(self.trace_dir, fname)
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            # Best-effort diagnostics: a trace lost to a crash is the
            # least of that crash's problems; rename-atomicity alone keeps
            # concurrent readers off half-written JSON.
            os.replace(tmp, path)  # tpusnap-lint: disable=durability-flow
            return path
        except OSError:
            logger.warning("failed to write trace file %s", path, exc_info=True)
            return None


def _current() -> Optional[_TraceOp]:
    # Unlocked read of the last element: append/remove happen under
    # _OP_LOCK, and a span racing an op teardown merely lands in (or
    # misses) a file that was being finalized — never corrupts state.
    active = _ACTIVE
    return active[-1] if active else None


def begin_op(kind: str, op_id: str, rank: int) -> Optional[_TraceOp]:
    """Start collecting spans for one operation.  Returns None (and costs
    one env lookup) when tracing is disabled."""
    trace_dir = knobs.get_trace_dir()
    if trace_dir is None:
        return None
    op = _TraceOp(kind, op_id, rank, trace_dir)
    with _OP_LOCK:
        _ACTIVE.append(op)
        phase_stats.set_trace_hook(record_phase)
    return op


def end_op(
    op: Optional[_TraceOp], success: bool = True, **extra: Any
) -> Optional[str]:
    """Stop collecting and write the op's trace file; returns its path."""
    if op is None:
        return None
    with _OP_LOCK:
        try:
            _ACTIVE.remove(op)
        except ValueError:
            return None  # already ended (double end_op on an error path)
        if not _ACTIVE:
            phase_stats.set_trace_hook(None)
    return op.finish(success, extra)


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def set(self, **args: Any) -> None:
        return None


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_op", "_name", "_cat", "_args", "_begin_us", "_token")

    def __init__(self, op: _TraceOp, name: str, cat: str, args: Dict[str, Any]):
        self._op = op
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._begin_us = _now_us()
        # Reserve the id up front so children opened inside see it.
        self._args["parent"] = _parent_span.get()
        span_id = next(_ids)
        self._args["span_id"] = span_id
        self._token = _parent_span.set(span_id)
        return self

    def set(self, **args: Any) -> None:
        """Attach outcome args (status, byte counts) discovered after the
        span opened; recorded at exit."""
        self._args.update(args)

    def __exit__(self, exc_type: Any, *exc: Any) -> None:
        _parent_span.reset(self._token)
        if exc_type is not None:
            self._args["error"] = getattr(exc_type, "__name__", str(exc_type))
        end_us = _now_us()
        _count_span()
        with self._op._lock:
            self._op._events.append(
                {
                    "name": self._name,
                    "cat": self._cat,
                    "ph": "X",
                    "ts": self._begin_us,
                    "dur": end_us - self._begin_us,
                    "pid": self._op.rank,
                    "tid": self._op._tid(),
                    "args": {**self._args, "op": self._op.op_id},
                }
            )


def span(name: str, cat: str = "span", nbytes: Optional[int] = None, **args: Any):
    """Context manager recording one complete span on the active op; a
    shared no-op when no op is collecting (the common, disabled case)."""
    op = _current()
    if op is None:
        return _NOOP
    if nbytes is not None:
        args["bytes"] = int(nbytes)
    return _Span(op, name, cat, args)


def instant(name: str, **args: Any) -> None:
    op = _current()
    if op is not None:
        op.add_instant(name, args)


def record_phase(phase: str, begin_mono: float, end_mono: float, nbytes: int) -> None:
    """phase_stats hook: every recorded interval becomes a leaf span.
    Installed only while at least one op is collecting."""
    op = _current()
    if op is None:
        return
    args: Dict[str, Any] = {"parent": _parent_span.get()}
    if nbytes:
        args["bytes"] = int(nbytes)
    op.add_complete(
        name=phase,
        begin_us=(begin_mono + _EPOCH_OFFSET_S) * 1e6,
        dur_us=(end_mono - begin_mono) * 1e6,
        cat="phase",
        args=args,
    )


# ------------------------------------------------- context propagation


def current_trace_id() -> Optional[str]:
    """The active op's trace id, or None when nothing is collecting —
    stamped into events (peer.reject, peer.demoted) so a quarantine can be
    joined back to the request that triggered it."""
    op = _current()
    return op.trace_id if op is not None else None


def current_traceparent() -> Optional[str]:
    """W3C ``traceparent`` header for the active op's current span context
    (``00-<trace>-<span>-01``), or None when nothing is collecting.  Sent
    on every outbound peer fetch so the serving daemon's handler span joins
    the caller's trace."""
    op = _current()
    if op is None:
        return None
    parent = _parent_span.get() or op.root_span_id
    return f"00-{op.trace_id}-{parent:016x}-01"


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, int]]:
    """Parse a ``traceparent`` header into ``(trace_id, parent_span_id)``.
    Tolerant of unknown versions, strict about shape — a malformed header
    yields None (the handler span simply starts a fresh trace)."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    trace_hex, span_hex = parts[1], parts[2]
    if len(trace_hex) != 32 or len(span_hex) != 16:
        return None
    try:
        span_id = int(span_hex, 16)
        int(trace_hex, 16)
    except ValueError:
        return None
    if span_id == 0 or trace_hex == "0" * 32:
        return None
    return trace_hex, span_id


# ------------------------------------------------- serving-plane tracing


class ServerTracer:
    """Span collector for a long-lived peer daemon.

    Unlike :class:`_TraceOp` (one op, one file at finish), a daemon serves
    requests indefinitely: spans land in a bounded in-memory buffer (oldest
    dropped when ``TPUSNAP_PEER_TRACE_MAX_SPANS`` is exceeded — the drop
    count is carried in ``otherData.dropped_spans``, never silently) and
    the buffer is rewritten to one trace file at most every
    ``TPUSNAP_PEER_TRACE_FLUSH_S`` seconds plus once at :meth:`close`.
    A background flusher thread covers the idle tail: with record-time
    flushing alone, spans recorded after the last flush sat invisible
    until the NEXT request arrived — a daemon that served one burst and
    went quiet never exposed it, and a postmortem read an empty file.
    Each span carries its own ``args.trace`` id parsed from the request's
    ``traceparent`` header, so one daemon file contributes to many
    stitched client traces.
    """

    def __init__(self, trace_dir: str, ident: str, kind: str = "peerd") -> None:
        self.trace_dir = trace_dir
        self.ident = ident
        self.kind = kind
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._dropped = 0
        self._dirty = False
        self._max_spans = knobs.get_peer_trace_max_spans()
        self._flush_s = knobs.get_peer_trace_flush_s()
        self._last_flush = time.monotonic()
        self.path = os.path.join(
            trace_dir, f"{kind}-{ident[:8]}-rank0{TRACE_FILE_SUFFIX}"
        )
        self._stop = threading.Event()
        self._flusher = threading.Thread(
            target=self._flush_loop, name="tpusnap-peerd-flush", daemon=True
        )
        self._flusher.start()

    def _flush_loop(self) -> None:
        """Time-based flush independent of request arrival: spans become
        visible within one flush interval even when the daemon goes idle."""
        while not self._stop.wait(self._flush_s):
            with self._lock:
                dirty = self._dirty
            if dirty:
                self.flush()

    def record_span(
        self,
        name: str,
        begin_us: float,
        dur_us: float,
        args: Dict[str, Any],
    ) -> None:
        span_id = next(_ids)
        args = dict(args)
        args["span_id"] = span_id
        _count_span()
        flush_due = False
        with self._lock:
            self._events.append(
                {
                    "name": name,
                    "cat": "phase",
                    "ph": "X",
                    "ts": begin_us,
                    "dur": max(dur_us, 0.0),
                    "pid": 0,
                    "tid": 0,
                    "args": args,
                }
            )
            if len(self._events) > self._max_spans:
                overflow = len(self._events) - self._max_spans
                del self._events[:overflow]
                self._dropped += overflow
            self._dirty = True
            now = time.monotonic()
            if now - self._last_flush >= self._flush_s:
                self._last_flush = now
                flush_due = True
        if flush_due:
            self.flush()

    def flush(self) -> Optional[str]:
        """Rewrite the daemon's trace file from the current buffer."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
            self._dirty = False
        payload = {
            "traceEvents": events
            + [
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": 0,
                    "tid": 0,
                    "args": {"name": f"{self.kind} {self.ident[:8]}"},
                }
            ],
            "displayTimeUnit": "ms",
            "otherData": {
                "op": self.ident,
                "kind": self.kind,
                "rank": 0,
                "success": True,
                "host": socket.gethostname(),
                "dropped_spans": dropped,
            },
        }
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            # Same best-effort stance as _TraceOp.finish: rename-atomicity
            # protects concurrent readers, durability is not the point.
            os.replace(tmp, self.path)  # tpusnap-lint: disable=durability-flow
            return self.path
        except OSError:
            logger.warning(
                "failed to write server trace file %s", self.path, exc_info=True
            )
            return None

    def close(self) -> Optional[str]:
        self._stop.set()
        self._flusher.join(timeout=5.0)
        return self.flush()


class AccessLog:
    """Structured JSONL access log with size-capped rotation.

    One line per served request: ``{ts, trace, digest, range, status,
    bytes, wall_s, client}``.  When the file crosses ``max_bytes`` it is
    renamed to ``<path>.1`` (one generation kept) and a fresh file is
    started — bounded disk, no silent truncation of in-flight lines.
    """

    def __init__(self, path: str, max_bytes: Optional[int] = None) -> None:
        self.path = path
        self.max_bytes = (
            max_bytes
            if max_bytes is not None
            else knobs.get_peerd_access_log_max_bytes()
        )
        self._lock = threading.Lock()

    def log(self, **fields: Any) -> None:
        line = json.dumps(fields, separators=(",", ":")) + "\n"
        with self._lock:
            try:
                parent = os.path.dirname(self.path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                try:
                    if os.path.getsize(self.path) >= self.max_bytes:
                        os.replace(self.path, self.path + ".1")
                except OSError:
                    pass  # no file yet — nothing to rotate
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line)
            except OSError:
                logger.warning(
                    "failed to append access log %s", self.path, exc_info=True
                )


def validate_access_log(path: str) -> List[str]:
    """Schema check for a peer daemon access log: every line must be a
    JSON object with the documented fields.  Returns problems; empty means
    valid."""
    required = ("ts", "trace", "digest", "status", "bytes", "wall_s", "client")
    problems: List[str] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.readlines()
    except OSError as e:
        return [f"unreadable: {e}"]
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            problems.append(f"line {i}: not JSON")
            continue
        if not isinstance(doc, dict):
            problems.append(f"line {i}: not an object")
            continue
        for field in required:
            if field not in doc:
                problems.append(f"line {i}: missing {field}")
        if not isinstance(doc.get("status"), int):
            problems.append(f"line {i}: status must be int")
        if not isinstance(doc.get("ts"), (int, float)):
            problems.append(f"line {i}: ts must be numeric")
    return problems


def calibrated_span_cost_s(samples: int = 200) -> Dict[str, Any]:
    """Isolated per-span recording cost x spans recorded this process: an
    estimate by parts of what tracing added to this process's wall."""
    spans = spans_recorded()  # snapshot first: probe spans are not workload
    probe = _TraceOp("calibration", "calibration", 0, trace_dir="")
    t0 = time.perf_counter()
    for _ in range(max(1, samples)):
        with _Span(probe, "calibration_span", "phase", {"bytes": 1}):
            pass
    per_span = (time.perf_counter() - t0) / max(1, samples)
    return {
        "per_span_s": per_span,
        "spans": spans,
        "estimated_s": per_span * spans,
    }


# --------------------------------------------------------------- tooling


def validate_trace(obj: Any) -> List[str]:
    """Structural validation of a trace-event JSON document (a schema
    check, not string matching).  Returns a list of problems; empty means
    valid."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["missing traceEvents array"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ev.get("name"), str):
            problems.append(f"{where}: missing string name")
        if ph not in ("X", "M", "i", "B", "E", "C"):
            problems.append(f"{where}: unknown ph {ph!r}")
            continue
        if ph in ("X", "i"):
            if not isinstance(ev.get("ts"), (int, float)):
                problems.append(f"{where}: ph={ph} needs numeric ts")
            if not isinstance(ev.get("pid"), int) or not isinstance(
                ev.get("tid"), int
            ):
                problems.append(f"{where}: needs integer pid/tid")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: ph=X needs non-negative dur")
        args = ev.get("args")
        if args is not None and not isinstance(args, dict):
            problems.append(f"{where}: args must be an object")
    return problems


def merge_trace_files(paths: List[str]) -> Dict[str, Any]:
    """Merge per-rank/per-op trace files into one Perfetto-loadable
    document (timestamps are epoch-anchored, so events align)."""
    merged: List[Dict[str, Any]] = []
    sources: List[Dict[str, Any]] = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        problems = validate_trace(doc)
        if problems:
            raise ValueError(f"{path}: invalid trace: {problems[:3]}")
        merged.extend(doc.get("traceEvents", []))
        other = doc.get("otherData", {})
        sources.append({"file": os.path.basename(path), **other})
    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {"merged_from": sources},
    }


def host_skew_from_spool(spool: str) -> Dict[str, float]:
    """Per-host clock-skew estimate (seconds) from fleet-spool stamps.

    Every spool entry carries ``publish_time`` stamped by the writing
    host's wall clock, while the entry file's mtime comes from the shared
    filesystem's clock — their difference, medianed per host, is that
    host's offset against the common reference.  Offsets are returned
    relative to the smallest (so a single-host fleet, or the write latency
    every host shares, maps to 0.0)."""
    diffs: Dict[str, List[float]] = {}
    try:
        names = os.listdir(spool)
    except OSError:
        return {}
    for name in names:
        if not name.endswith(".fleet.json"):
            continue
        path = os.path.join(spool, name)
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            mtime = os.path.getmtime(path)
        except (OSError, ValueError):
            continue
        host = doc.get("host")
        publish = doc.get("publish_time")
        if not isinstance(host, str) or not isinstance(publish, (int, float)):
            continue
        diffs.setdefault(host, []).append(mtime - publish)
    skew: Dict[str, float] = {}
    for host, vals in diffs.items():
        vals.sort()
        skew[host] = vals[len(vals) // 2]
    if skew:
        base = min(skew.values())
        skew = {host: off - base for host, off in skew.items()}
    return skew


def merge_fleet_traces(
    paths: List[str], spool: Optional[str] = None
) -> Dict[str, Any]:
    """Stitch per-host client and daemon trace files into one timeline.

    Beyond :func:`merge_trace_files`, every event is annotated with the
    trace id it belongs to (``args.trace`` — daemon spans already carry
    their own per-request id; client events inherit the file-level id), a
    per-host clock-skew correction from the fleet spool's stamps is
    applied, and ``otherData.trace_ids`` lists every distinct trace so the
    caller can see which requests cross which files."""
    skew = host_skew_from_spool(spool) if spool else {}
    merged: List[Dict[str, Any]] = []
    sources: List[Dict[str, Any]] = []
    trace_ids: Dict[str, int] = {}
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        problems = validate_trace(doc)
        if problems:
            raise ValueError(f"{path}: invalid trace: {problems[:3]}")
        other = doc.get("otherData", {})
        file_trace = other.get("trace_id")
        host = other.get("host")
        shift_us = skew.get(host, 0.0) * 1e6 if isinstance(host, str) else 0.0
        for ev in doc.get("traceEvents", []):
            if shift_us and isinstance(ev.get("ts"), (int, float)):
                ev = dict(ev)
                ev["ts"] = ev["ts"] + shift_us
            args = ev.get("args")
            trace = args.get("trace") if isinstance(args, dict) else None
            if trace is None and isinstance(file_trace, str) and ev.get("ph") != "M":
                ev = dict(ev)
                ev["args"] = {**(args or {}), "trace": file_trace}
                trace = file_trace
            if isinstance(trace, str):
                trace_ids[trace] = trace_ids.get(trace, 0) + 1
            merged.append(ev)
        sources.append(
            {"file": os.path.basename(path), "skew_s": skew.get(host, 0.0), **other}
        )
    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "merged_from": sources,
            "trace_ids": {
                t: n for t, n in sorted(trace_ids.items(), key=lambda kv: -kv[1])
            },
        },
    }
