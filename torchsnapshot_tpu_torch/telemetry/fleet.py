"""Fleet telemetry: a live view across ranks and processes.

Counterpart of ``torchsnapshot_tpu/telemetry/fleet.py``, on the same spool:
its schema version, entry suffix, conventional directory and entry names
are the JAX package's, and an entry's keys are too, so the workers of both
packages publish into one spool and either package's :func:`collect` and
:func:`aggregate` read it.  The traces, metrics, sidecars, monitor and
history are per rank and per process; this module says, live and in one
place, what the whole fleet is doing, which worker is the straggler and how
many bytes the serving tier pulls from origin.

- **Publisher**: with ``TPUSNAP_FLEET_TELEMETRY=<spool-dir>`` set (by
  convention ``<root>/telemetry/live``) every monitored op (take,
  async_take, restore, read_object, a peer daemon's serve and rollout)
  writes one bounded JSON entry into the spool each
  ``TPUSNAP_FLEET_TELEMETRY_INTERVAL_S``: the op's
  :meth:`OpMonitor.progress` document, the process's totals, its cache and
  peer splits (``cache.process_stats``, ``peer.process_stats``,
  ``peer_scoreboard``), the metrics registry's dump when
  ``TPUSNAP_METRICS=1``, and the op's ``fleet_extra`` (the rollout's wave
  document).  An entry is written to a temporary name and renamed, so a
  reader never sees a torn one; it is named ``<host>-<pid>-<kind>-rank<r>``,
  so a process's successive ops of one kind reuse one file.  A terminal
  publish at the op's end carries ``done`` and ``success``.  There is no
  fsync: entries are rewritten every interval and aged out in seconds.
- **Collector**: :func:`collect` reads every entry and ages out those older
  than ``TPUSNAP_FLEET_TELEMETRY_STALE_S``: a finished op's is swept, an
  in-flight op's is kept as suspected-dead.  :func:`aggregate` folds the
  entries into the fleet view (per-worker state, bytes and ETA, aggregate
  bandwidth, cache hit ratio and origin bytes, the peer offload, the
  straggler ranking, the in-flight rollout); :func:`render` and
  :func:`render_prometheus` format it as ``tpusnap top`` does.
- **Self-metering**: every publish's wall adds to the process's overhead
  total and ``tpusnap_telemetry_overhead_seconds_total``; periodic
  publishes stay within ``OVERHEAD_BUDGET_FRAC`` of the op's elapsed time
  (a live op's monitor publishes at least every half stale bound whatever
  the budget: telemetry/monitor.py).
  :func:`calibrated_overhead_s` prices the marginal bill (the per-publish
  cost measured in isolation times the publishes), which should stay under
  1% of an op's wall.

With the knob unset (the default) nothing is written, and the module costs
one environment lookup per monitored op.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from .. import knobs
from . import metrics as tmetrics

logger = logging.getLogger(__name__)

SCHEMA_VERSION = 1
ENTRY_SUFFIX = ".fleet.json"
# Conventional spool location under a snapshot or manager root.
SPOOL_DIRNAME = os.path.join("telemetry", "live")

# ---------------------------------------------------------- process totals

_STATE_LOCK = threading.Lock()
_PROC_TOTALS: Dict[str, float] = {
    "ops_done": 0,
    "ops_failed": 0,
    "bytes_staged": 0,
    "bytes_written": 0,
    "publishes": 0,
    "overhead_s": 0.0,
}

# A periodic publish is skipped while the op's accumulated publish wall
# exceeds this fraction of its elapsed time (terminal publishes always run):
# under heavy I/O one spool write can cost several ms, and pacing by the
# measured cost keeps the bill under 1% of the op's wall on a loaded host.
OVERHEAD_BUDGET_FRAC = 0.005


def enabled() -> bool:
    return knobs.get_fleet_telemetry_dir() is not None


def process_overhead_s() -> float:
    """Wall this process has spent publishing fleet telemetry."""
    with _STATE_LOCK:
        return float(_PROC_TOTALS["overhead_s"])


def process_totals() -> Dict[str, float]:
    with _STATE_LOCK:
        return dict(_PROC_TOTALS)


def reset_process_totals() -> None:
    """Tests only."""
    with _STATE_LOCK:
        for k in _PROC_TOTALS:
            _PROC_TOTALS[k] = 0


# -------------------------------------------------------------- publishing


_HOSTNAME: Optional[str] = None


def _hostname() -> str:
    global _HOSTNAME
    if _HOSTNAME is None:
        _HOSTNAME = socket.gethostname()
    return _HOSTNAME


def entry_name(kind: str, rank: int, pid: Optional[int] = None) -> str:
    host = _hostname().replace("/", "_")
    return f"{host}-{pid if pid is not None else os.getpid()}-{kind}-rank{rank}{ENTRY_SUFFIX}"


def _op_bytes(progress: Dict[str, Any]) -> Dict[str, int]:
    b = progress.get("bytes") or {}
    return {"staged": int(b.get("staged", 0)), "written": int(b.get("written", 0))}


def build_entry(mon: Any) -> Dict[str, Any]:
    """One spool document for an OpMonitor-shaped object (``kind``,
    ``op_id``, ``rank``, ``progress()``).  Bounded: the progress document
    holds one small dict per pipeline, and the metrics dump is empty unless
    ``TPUSNAP_METRICS`` is on in this process."""
    progress = mon.progress()
    doc: Dict[str, Any] = {
        "schema": SCHEMA_VERSION,
        "host": _hostname(),
        "pid": os.getpid(),
        "rank": mon.rank,
        "kind": mon.kind,
        "op_id": mon.op_id,
        "publish_time": time.time(),
        "op": progress,
        "proc": process_totals(),
        "metrics": tmetrics.dump_registry(),
    }
    try:
        from .. import cache as cache_mod

        doc["cache"] = cache_mod.process_stats()
    except Exception:  # noqa: BLE001 — the cache layer never fails telemetry
        doc["cache"] = {}
    try:
        from .. import peer as peer_mod

        doc["peer"] = peer_mod.process_stats()
        # One small row per peer address, left out while empty so the
        # entries of ops that fetched from no peer do not grow.
        scoreboard = peer_mod.peer_scoreboard()
        if scoreboard:
            doc["peer_scoreboard"] = scoreboard
    except Exception:  # noqa: BLE001 — the peer layer never fails telemetry
        doc["peer"] = {}
    # The op's own extension (rollout_fleet's wave document).
    extra = getattr(mon, "fleet_extra", None)
    if isinstance(extra, dict) and extra:
        doc["extra"] = extra
    return doc


def within_overhead_budget(mon: Any, elapsed_s: float) -> bool:
    """Whether a periodic publish for this op is affordable now: its
    accumulated publish wall stays within ``OVERHEAD_BUDGET_FRAC`` of the
    op's elapsed time."""
    spent = float(getattr(mon, "fleet_overhead_s", 0.0))
    return spent <= OVERHEAD_BUDGET_FRAC * max(elapsed_s, 0.0)


def publish(mon: Any, final: bool = False) -> Optional[str]:
    """Write one spool entry for ``mon`` atomically; the entry's path, or
    None (publishing off, or the write failed: publishing is never
    load-bearing).  ``final`` folds the op's terminal byte counts into the
    process totals, once per monitor, and marks the entry terminal."""
    spool = knobs.get_fleet_telemetry_dir()
    if not spool:
        return None
    # Wall-metered: under a saturated data plane the publishing thread
    # waits behind the op's own work, so this overcounts.  The raw number
    # still drives the budget (beacons that pause under load are the right
    # backpressure; the monitor's liveness floor bounds the pause);
    # calibrated_overhead_s gives the marginal cost.
    begin = time.monotonic()
    path = os.path.join(spool, entry_name(mon.kind, mon.rank))
    try:
        if final:
            _fold_terminal(mon)
        _atomic_write_json(path, build_entry(mon))
        return path
    except OSError:
        logger.debug("fleet telemetry publish failed: %s", path, exc_info=True)
        return None
    finally:
        overhead = time.monotonic() - begin
        try:
            mon.fleet_overhead_s = float(getattr(mon, "fleet_overhead_s", 0.0)) + overhead
        except AttributeError:
            pass
        with _STATE_LOCK:
            _PROC_TOTALS["publishes"] += 1
            _PROC_TOTALS["overhead_s"] += overhead
        tmetrics.record_telemetry_overhead(overhead)


class _CalibrationProbe:
    """The smallest OpMonitor-shaped object, for calibration publishes."""

    kind = "calibration"
    op_id = "0" * 32
    rank = 0

    @staticmethod
    def progress() -> Dict[str, Any]:
        return {
            "action": "calibration",
            "requests": {"total": 0, "staged": 0, "written": 0},
            "bytes": {"staged": 0, "written": 0},
            "elapsed_s": 0.0,
            "done": True,
            "success": True,
        }


def calibrated_overhead_s(samples: int = 5) -> Dict[str, float]:
    """The marginal telemetry bill: the per-publish wall measured in
    isolation (call it at a quiet moment, after the op drained) times the
    publishes this process made.  The live ``overhead_s`` total includes
    the time the publishing thread was descheduled behind the op's own
    work; this estimate leaves that out and keeps the real write cost."""
    with _STATE_LOCK:
        publishes = int(_PROC_TOTALS["publishes"])
    spool = knobs.get_fleet_telemetry_dir()
    if not spool or samples <= 0:
        return {"per_publish_s": 0.0, "publishes": publishes, "estimated_s": 0.0}
    probe = _CalibrationProbe()
    path = os.path.join(spool, entry_name(probe.kind, probe.rank))
    begin = time.monotonic()
    try:
        for _ in range(samples):
            _atomic_write_json(path, build_entry(probe))
    except OSError:
        return {"per_publish_s": 0.0, "publishes": publishes, "estimated_s": 0.0}
    per_publish = (time.monotonic() - begin) / samples
    try:
        os.unlink(path)
    except OSError:
        pass
    return {
        "per_publish_s": round(per_publish, 6),
        "publishes": publishes,
        "estimated_s": round(per_publish * publishes, 6),
    }


def _fold_terminal(mon: Any) -> None:
    # The folded-once mark lives on the monitor: a set of id()s would take a
    # new monitor at a recycled address for a folded one, and grow forever.
    with _STATE_LOCK:
        if getattr(mon, "_fleet_folded", False):
            return
        try:
            mon._fleet_folded = True
        except AttributeError:
            return  # an object that cannot be marked: skip rather than double-count
    try:
        progress = mon.progress()
    except Exception:  # noqa: BLE001
        return
    op_bytes = _op_bytes(progress)
    with _STATE_LOCK:
        _PROC_TOTALS["ops_done"] += 1
        if progress.get("success") is False:
            _PROC_TOTALS["ops_failed"] += 1
        _PROC_TOTALS["bytes_staged"] += op_bytes["staged"]
        _PROC_TOTALS["bytes_written"] += op_bytes["written"]


def _atomic_write_json(path: str, doc: Dict[str, Any]) -> None:
    """Temporary file and atomic rename, so a reader never parses a torn
    entry.  No fsync: an entry is a liveness beacon rewritten every interval
    and aged out in seconds, and an fsync mid-op waits behind the data
    plane's own writeback (the heartbeat file does the same).  The document
    is encoded whole and written once: ``json.dump`` would write it in
    thousands of small pieces, each a Python call, at over twice the cost.
    On a network file system every call is a round trip, so the entry goes
    through ``os.open``/``os.write`` (no buffered file object, whose open
    asks for the file's status) and the spool directory is made only when
    the open finds it missing."""
    # A temporary name per thread: two threads of one process may publish
    # the same entry at once (two read_object ops ending together).
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    data = json.dumps(doc).encode("utf-8")
    flags = os.O_WRONLY | os.O_CREAT | os.O_TRUNC
    try:
        fd = os.open(tmp, flags, 0o644)
    except FileNotFoundError:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd = os.open(tmp, flags, 0o644)
    try:
        view = memoryview(data)
        while view:
            view = view[os.write(fd, view):]
    finally:
        os.close(fd)
    try:
        os.replace(tmp, path)  # tpusnap-lint: disable=durability-flow
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# -------------------------------------------------------------- collecting


def resolve_spool(path: Optional[str]) -> Optional[str]:
    """The spool directory behind a path: a spool directory itself, a root
    with the conventional ``telemetry/live`` under it, or, with no path,
    the ``TPUSNAP_FLEET_TELEMETRY`` knob."""
    if not path:
        return knobs.get_fleet_telemetry_dir()
    nested = os.path.join(path, SPOOL_DIRNAME)
    if os.path.isdir(nested):
        return nested
    if os.path.isdir(path):
        return path
    return None


# A suspected-dead entry (stale while its op was in flight) stays visible
# for this many stale intervals before a sweep reclaims it.
_SUSPECT_SWEEP_FACTOR = 10.0

# (host, pid, kind, rank, op_id, publish_time) of the entries already
# reported suspected-dead: one fleet.peer_stale event per death, not one
# per collect pass.
_PEER_STALE_SEEN: set = set()


def _note_peer_stale(doc: Dict[str, Any], age: float) -> None:
    key = (doc.get("host"), doc.get("pid"), doc.get("kind"), doc.get("rank"), doc.get("op_id"), doc.get("publish_time"))
    if key in _PEER_STALE_SEEN:
        return
    _PEER_STALE_SEEN.add(key)
    from ..event import Event
    from ..event_handlers import log_event

    log_event(
        Event(
            name="fleet.peer_stale",
            metadata={
                "worker": f"{doc.get('host', '?')}:{doc.get('pid', '?')}",
                "rank": doc.get("rank", 0),
                "kind": doc.get("kind", "?"),
                "op_id": str(doc.get("op_id", ""))[:8],
                "last_seen_s": round(age, 3),
            },
        )
    )


def collect(spool: str, stale_s: Optional[float] = None, sweep: bool = True) -> List[Dict[str, Any]]:
    """Every entry in the spool, oldest published first.  An entry older
    than ``stale_s`` (default: ``TPUSNAP_FLEET_TELEMETRY_STALE_S``) is
    debris if its op finished (skipped and, with ``sweep``, unlinked); if
    its op was in flight it is a worker's last sign before it likely died,
    kept with ``_stale: True`` (one ``fleet.peer_stale`` event per death,
    the ``tpusnap_fleet_stale_peers`` gauge) until ten stale intervals have
    passed.  Unreadable or torn entries are skipped."""
    if stale_s is None:
        stale_s = knobs.get_fleet_telemetry_stale_s()
    now = time.time()
    entries: List[Dict[str, Any]] = []
    n_suspected = 0
    try:
        names = sorted(os.listdir(spool))
    except OSError:
        return []
    for name in names:
        if not name.endswith(ENTRY_SUFFIX):
            continue
        path = os.path.join(spool, name)
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        age = now - float(doc.get("publish_time") or 0.0)
        if age > stale_s:
            op_done = bool((doc.get("op") or {}).get("done"))
            if op_done or age > stale_s * _SUSPECT_SWEEP_FACTOR:
                if sweep:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                continue
            doc["_stale"] = True
            n_suspected += 1
            _note_peer_stale(doc, age)
        doc["_age_s"] = round(age, 3)
        doc["_file"] = name
        entries.append(doc)
    tmetrics.record_fleet_stale_peers(n_suspected)
    entries.sort(key=lambda d: d.get("publish_time", 0.0))
    return entries


def _worker_row(doc: Dict[str, Any]) -> Dict[str, Any]:
    op = doc.get("op") or {}
    reqs = op.get("requests") or {}
    op_bytes = _op_bytes(op)
    elapsed = float(op.get("elapsed_s") or 0.0)
    done = bool(op.get("done"))
    total = int(reqs.get("total") or 0)
    staged = int(reqs.get("staged") or 0)
    written = int(reqs.get("written") or 0)
    if doc.get("_stale") and not done:
        # Published mid-op, then silent past the stale bound: most likely
        # killed mid-op, and this last beacon is what the fleet saw of it.
        state = "suspected-dead"
    elif done:
        state = "done" if op.get("success", True) else "failed"
    elif total == 0:
        state = "planning"
    elif written >= total:
        state = "committing"
    elif staged > written:
        state = "writing"
    else:
        state = "staging"
    moved = max(op_bytes["staged"], op_bytes["written"])
    return {
        "worker": f"{doc.get('host', '?')}:{doc.get('pid', '?')}",
        "rank": doc.get("rank", 0),
        "kind": doc.get("kind", "?"),
        "op_id": str(doc.get("op_id", ""))[:8],
        "state": state,
        "done": done,
        "success": op.get("success"),
        "elapsed_s": round(elapsed, 3),
        "requests": {"total": total, "staged": staged, "written": written},
        "bytes_staged": op_bytes["staged"],
        "bytes_written": op_bytes["written"],
        "gbps": round(moved / 1e9 / elapsed, 3) if elapsed > 0 else 0.0,
        "eta_s": op.get("eta_s"),
        "stalls": int(op.get("stalls") or 0),
        "age_s": doc.get("_age_s", 0.0),
        "proc": doc.get("proc") or {},
        "cache": doc.get("cache") or {},
        "peer": doc.get("peer") or {},
    }


def aggregate(entries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold collected entries into the fleet view ``tpusnap top`` renders.
    Cache, peer and process totals are cumulative per process, so they sum
    one entry per process (the newest); op-level bytes sum over all
    entries."""
    workers = [_worker_row(d) for d in entries]
    suspected = [w for w in workers if w["state"] == "suspected-dead"]
    # Suspected-dead workers stay out of the live set: their ETAs and rates
    # describe a process that is gone.
    live = [w for w in workers if not w["done"] and w["state"] != "suspected-dead"]
    per_proc: Dict[str, Dict[str, Any]] = {}
    for w in workers:
        per_proc[w["worker"]] = w  # newest entry per process wins
    cache_totals = {"hits": 0, "misses": 0, "hit_bytes": 0, "miss_bytes": 0}
    peer_totals = {"hits": 0, "misses": 0, "hit_bytes": 0, "miss_bytes": 0, "rejects": 0}
    proc_totals = {"ops_done": 0, "ops_failed": 0, "bytes_staged": 0, "bytes_written": 0, "overhead_s": 0.0}
    for w in per_proc.values():
        for k in cache_totals:
            cache_totals[k] += int(w["cache"].get(k, 0) or 0)
        for k in peer_totals:
            peer_totals[k] += int(w["peer"].get(k, 0) or 0)
        for k in proc_totals:
            proc_totals[k] += w["proc"].get(k, 0) or 0
    proc_totals["overhead_s"] = round(proc_totals["overhead_s"], 6)
    op_totals = {
        "bytes_staged": sum(w["bytes_staged"] for w in workers),
        "bytes_written": sum(w["bytes_written"] for w in workers),
        "stalls": sum(w["stalls"] for w in workers),
    }
    hit_and_miss = cache_totals["hit_bytes"] + cache_totals["miss_bytes"]
    cache_view = {
        **cache_totals,
        "origin_bytes": cache_totals["miss_bytes"],
        "hit_ratio": round(cache_totals["hit_bytes"] / hit_and_miss, 4) if hit_and_miss else None,
    }
    # Bytes the fleet did not pull from origin because a peer served them.
    peer_view = {**peer_totals, "offload_bytes": peer_totals["hit_bytes"]}

    # Stragglers among the live workers: the longest ETA first; a worker
    # with no ETA yet ranks first, by its lowest completed fraction.
    def _straggle_key(w: Dict[str, Any]):
        eta = w["eta_s"]
        total = w["requests"]["total"]
        frac = w["requests"]["written"] / total if total else 0.0
        return (-(eta if isinstance(eta, (int, float)) else float("inf")), frac)

    stragglers = [
        {"worker": w["worker"], "rank": w["rank"], "kind": w["kind"], "eta_s": w["eta_s"], "state": w["state"]}
        for w in sorted(live, key=_straggle_key)
    ]
    # Per-peer scoreboard merged across processes by address (the newest
    # entry per process): counters sum, health estimates take the worst
    # view seen (max EWMA and p99, any quarantine or demotion).
    per_proc_docs: Dict[str, Dict[str, Any]] = {}
    for d in entries:
        per_proc_docs[f"{d.get('host', '?')}:{d.get('pid', '?')}"] = d
    scoreboard: Dict[str, Dict[str, Any]] = {}
    for d in per_proc_docs.values():
        for addr, row in (d.get("peer_scoreboard") or {}).items():
            if not isinstance(row, dict):
                continue
            slot = scoreboard.get(addr)
            if slot is None:
                scoreboard[addr] = dict(row)
                continue
            for k in ("hits", "misses", "errors", "rejects", "bytes"):
                slot[k] = int(slot.get(k, 0) or 0) + int(row.get(k, 0) or 0)
            for k in ("ewma_latency_s", "ewma_error", "p50_s", "p99_s", "quarantined_until"):
                slot[k] = max(float(slot.get(k, 0.0) or 0.0), float(row.get(k, 0.0) or 0.0))
            slot["demoted"] = bool(slot.get("demoted")) or bool(row.get("demoted"))
    for row in scoreboard.values():
        fetches = sum(int(row.get(k, 0)) for k in ("hits", "misses", "errors", "rejects"))
        row["fetches"] = fetches
        row["hit_ratio"] = round(int(row.get("hits", 0)) / fetches, 4) if fetches else None
    # The in-flight rollout (the newest): the wave document rollout_fleet
    # publishes through its monitor's fleet_extra.
    rollout_doc: Optional[Dict[str, Any]] = None
    for d in entries:
        if d.get("kind") != "rollout" or bool((d.get("op") or {}).get("done")):
            continue
        wave = (d.get("extra") or {}).get("rollout")
        if isinstance(wave, dict):
            rollout_doc = {
                **wave,
                "worker": f"{d.get('host', '?')}:{d.get('pid', '?')}",
                "age_s": d.get("_age_s", 0.0),
            }
    return {
        "schema": SCHEMA_VERSION,
        "time": time.time(),
        "n_entries": len(workers),
        "n_processes": len(per_proc),
        "n_live": len(live),
        "n_suspected_dead": len(suspected),
        "suspected_dead": [
            {"worker": w["worker"], "rank": w["rank"], "kind": w["kind"], "last_seen_s": w["age_s"]} for w in suspected
        ],
        "workers": workers,
        "aggregate_gbps": round(sum(w["gbps"] for w in live), 3),
        "op_totals": op_totals,
        "proc_totals": proc_totals,
        "cache": cache_view,
        "peer": peer_view,
        "peer_scoreboard": scoreboard,
        "rollout": rollout_doc,
        "stragglers": stragglers,
        "straggler": stragglers[0] if stragglers else None,
    }


# --------------------------------------------------------------- rendering


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


def render(view: Dict[str, Any], spool: str) -> str:
    """The ``tpusnap top`` table."""
    lines: List[str] = []
    when = time.strftime("%H:%M:%S", time.localtime(view.get("time")))
    lines.append(
        f"tpusnap top — {spool} — {when} — "
        f"{view['n_live']} live / {view['n_entries']} worker entr"
        f"{'y' if view['n_entries'] == 1 else 'ies'}"
    )
    cache = view["cache"]
    ratio = cache["hit_ratio"]
    lines.append(
        f"aggregate: {view['aggregate_gbps']:.2f} GB/s live; "
        f"{_fmt_bytes(view['op_totals']['bytes_written'])} written, "
        f"{_fmt_bytes(view['proc_totals']['bytes_written'])} lifetime; "
        f"cache hit {'-' if ratio is None else f'{ratio:.0%}'} "
        f"({_fmt_bytes(cache['origin_bytes'])} from origin); "
        f"telemetry overhead {view['proc_totals']['overhead_s']:.3f}s"
    )
    peer = view.get("peer") or {}
    if peer.get("hits") or peer.get("misses") or peer.get("rejects"):
        lines.append(
            f"peer: {_fmt_bytes(peer.get('hit_bytes', 0))} from "
            f"{peer.get('hits', 0)} peer fetches, "
            f"{peer.get('misses', 0)} origin fallbacks, "
            f"{peer.get('rejects', 0)} rejected"
        )
    rollout = view.get("rollout")
    if rollout:
        eta = rollout.get("eta_s")
        lines.append(
            f"ROLLOUT in flight ({rollout.get('worker', '?')}): "
            f"step {rollout.get('step')} wave {rollout.get('wave', '?')} — "
            f"{rollout.get('completed', 0)}/{rollout.get('total', 0)} hosts, "
            f"{_fmt_bytes(rollout.get('peer_bytes', 0))} via peers / "
            f"{_fmt_bytes(rollout.get('origin_bytes', 0))} from origin"
            + (f", eta {eta:.0f}s" if isinstance(eta, (int, float)) else "")
        )
    for dead in view.get("suspected_dead") or ():
        lines.append(
            f"SUSPECTED DEAD: {dead['worker']} rank {dead['rank']} "
            f"({dead['kind']}) — last seen {dead['last_seen_s']:.0f}s ago mid-op"
        )
    straggler = view.get("straggler")
    if straggler is not None:
        eta = straggler["eta_s"]
        lines.append(
            f"straggler: {straggler['worker']} rank {straggler['rank']} "
            f"({straggler['kind']}, {straggler['state']}"
            + (f", eta {eta:.1f}s)" if isinstance(eta, (int, float)) else ")")
        )
    lines.append(
        f"  {'worker':<22} {'rank':>4} {'kind':>10} {'state':>10} "
        f"{'staged':>9} {'written':>9} {'GB/s':>6} {'eta':>7} "
        f"{'elapsed':>8} {'stalls':>6}"
    )
    for w in view["workers"]:
        eta = w["eta_s"]
        lines.append(
            f"  {w['worker']:<22} {w['rank']:>4} {w['kind']:>10} "
            f"{w['state']:>10} {_fmt_bytes(w['bytes_staged']):>9} "
            f"{_fmt_bytes(w['bytes_written']):>9} {w['gbps']:>6.2f} "
            f"{(f'{eta:.1f}s' if isinstance(eta, (int, float)) else '-'):>7} "
            f"{w['elapsed_s']:>7.1f}s {w['stalls']:>6}"
        )
    if not view["workers"]:
        lines.append("  (no live entries — fleet idle, or the spool is stale)")
    scoreboard = view.get("peer_scoreboard") or {}
    if scoreboard:
        lines.append(
            f"  PEERS {'addr':<22} {'fetch':>6} {'hit%':>5} {'p99':>9} "
            f"{'served':>9} {'quarantined':>12} {'state':>8}"
        )
        now = time.time()
        for addr in sorted(scoreboard):
            row = scoreboard[addr]
            ratio = row.get("hit_ratio")
            quar_until = float(row.get("quarantined_until", 0.0) or 0.0)
            quar = f"{quar_until - now:.0f}s left" if quar_until > now else "-"
            state = "demoted" if row.get("demoted") else "ok"
            lines.append(
                f"        {addr:<22} {row.get('fetches', 0):>6} "
                f"{('-' if ratio is None else f'{ratio:.0%}'):>5} "
                f"{row.get('p99_s', 0.0) * 1e3:>7.1f}ms "
                f"{_fmt_bytes(row.get('bytes', 0)):>9} {quar:>12} {state:>8}"
            )
    return "\n".join(lines)


def render_prometheus(entries: List[Dict[str, Any]]) -> str:
    """Every worker's embedded registry dump merged into one Prometheus
    text exposition, each series with a ``worker`` label, plus fleet gauges
    from the aggregation: one scrape sees the whole fleet."""
    fams: Dict[str, Dict[str, Any]] = {}
    for doc in entries:
        worker = f"{doc.get('host', '?')}:{doc.get('pid', '?')}"
        for fam in doc.get("metrics") or []:
            name = fam.get("name")
            if not name:
                continue
            slot = fams.setdefault(
                name,
                {"type": fam.get("type", "counter"), "help": fam.get("help", ""), "buckets": fam.get("buckets"),
                 "rows": []},
            )
            for child in fam.get("children") or []:
                labels = dict(child.get("labels") or {})
                labels["worker"] = worker
                slot["rows"].append((labels, child))
    lines: List[str] = []

    def _fmt_labels(labels: Dict[str, str]) -> str:
        parts = [f'{k}="{v}"' for k, v in sorted(labels.items())]
        return "{" + ",".join(parts) + "}" if parts else ""

    def _fmt_value(v: float) -> str:
        return str(int(v)) if float(v).is_integer() else repr(float(v))

    for name in sorted(fams):
        fam = fams[name]
        if fam["help"]:
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for labels, child in fam["rows"]:
            if fam["type"] == "histogram":
                cumulative = 0
                for le, n in zip(fam.get("buckets") or (), child.get("buckets") or ()):
                    cumulative += n
                    lines.append(f"{name}_bucket{_fmt_labels({**labels, 'le': str(le)})} {cumulative}")
                lines.append(f"{name}_bucket{_fmt_labels({**labels, 'le': '+Inf'})} {child.get('count', 0)}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_value(child.get('sum', 0.0))}")
                lines.append(f"{name}_count{_fmt_labels(labels)} {child.get('count', 0)}")
            else:
                lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(child.get('value', 0.0))}")
    view = aggregate(entries)
    lines.append("# HELP tpusnap_fleet_workers Worker entries currently in the fleet telemetry spool")
    lines.append("# TYPE tpusnap_fleet_workers gauge")
    lines.append(f"tpusnap_fleet_workers {view['n_entries']}")
    lines.append("# HELP tpusnap_fleet_live_workers Spool entries for ops still in flight")
    lines.append("# TYPE tpusnap_fleet_live_workers gauge")
    lines.append(f"tpusnap_fleet_live_workers {view['n_live']}")
    lines.append("# HELP tpusnap_fleet_bytes_written Lifetime bytes written/read across fleet processes")
    lines.append("# TYPE tpusnap_fleet_bytes_written gauge")
    lines.append(f"tpusnap_fleet_bytes_written {int(view['proc_totals']['bytes_written'])}")
    lines.append("# HELP tpusnap_fleet_origin_bytes Cache-miss bytes fetched from origin across fleet processes")
    lines.append("# TYPE tpusnap_fleet_origin_bytes gauge")
    lines.append(f"tpusnap_fleet_origin_bytes {view['cache']['origin_bytes']}")
    lines.append(
        "# HELP tpusnap_fleet_peer_bytes Bytes served by fleet peers instead of origin across fleet processes"
    )
    lines.append("# TYPE tpusnap_fleet_peer_bytes gauge")
    lines.append(f"tpusnap_fleet_peer_bytes {int((view.get('peer') or {}).get('hit_bytes', 0))}")
    if "tpusnap_fleet_stale_peers" not in fams:
        # A merged registry that carries the family already would make a
        # second TYPE line, which is invalid exposition.
        lines.append(
            "# HELP tpusnap_fleet_stale_peers Spool entries for in-flight ops whose publisher went silent past "
            "the stale bound (suspected-dead workers)"
        )
        lines.append("# TYPE tpusnap_fleet_stale_peers gauge")
        lines.append(f"tpusnap_fleet_stale_peers {view['n_suspected_dead']}")
    return "\n".join(lines) + "\n"
