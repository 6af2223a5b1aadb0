"""Crash forensics: the postmortem of a manager root.

Counterpart of ``torchsnapshot_tpu/telemetry/postmortem.py``, with its
functions, its report keys, its verdicts and its classifications, so an
operator reads the same report whichever package wrote the trail, and
either package's postmortem reads the other's.

Every robustness invariant the chaos suites prove (marker iff success,
debris GC-able, lease adoption converges) leaves a *trail* when it runs
for real: flight-recorder rings (blackbox.py), a frozen heartbeat, lease
stamps and tombstones in the coordination store, in-flight markers,
store ledger, sweep and quarantine state, orphan journal segments, and
stale fleet-spool entries.  This module stitches those planes into ONE
clock-skew-corrected causal timeline, classifies the failure, and emits
the remediation that the chaos tests assert converges.

The report answers the operator's questions in order:

- **Who died first?**  Per-process reconstruction from the rings: an
  ``op`` start without its end is an op cut short; an injected crash
  leaves a ``fault`` record (written with ``os.pwrite`` just before
  ``os._exit``, so it survives); a pid on this host is probed directly;
  anything else is judged by record-stamp age against the lease grace,
  the same stamp-age liveness rule the store planes use.
- **Where in the pipeline?**  The fault record's phase, else the last
  phase-transition record, classified into the analyzer's phase groups.
- **What did it cost?**  Bytes staged and written from the last progress
  record; orphan steps, segments and chunks and in-flight markers at the
  root; stale writer leases, pending quarantine and ledger entries at the
  shared store; which peer the survivors convicted (``peer_dead``
  records) and which tenant's debris it is.
- **What do I run?**  ``gc --apply`` (with ``--force`` when the marker's
  pid is provably dead), a store sweep (``force=True`` adopts a dead
  sweeper's lease), and the ``restore_latest`` fallback budget.

Clock skew: per-host offsets come from the fleet spool's publish-time
against mtime medians (``trace.host_skew_from_spool``) and shift every
timeline stamp.  :func:`to_perfetto` exports the timeline as instant
events on the tracing plane's pid axes.

The planes have one layout in both packages: the ring files and slots,
the spool entries, the ``oplease/<rank>`` keys of a FileStore directory,
the store's directories and documents, and the in-flight markers.  So
this module reads them as the JAX module does, and its reports differ
from that module's in two places only: a ``command`` names this package,
and a phase's group comes from this package's ``analyze.PHASE_GROUPS``,
where the phases only the port records (``pinned_alloc``,
``native_write_batch``, ...) have the group of their work instead of
``other``.  The store URL of a root comes from
:func:`torchsnapshot_tpu_torch.store._resolve_store_url`.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Any, Dict, List, Optional

from .. import knobs
from ..event import Event
from ..event_handlers import log_event
from . import analyze as tanalyze
from . import blackbox, fleet
from . import metrics as tmetrics
from . import trace as ttrace

BLACKBOX_DIRNAME = os.path.join("telemetry", "blackbox")

# Record-age bound past which a process with an op still open is presumed
# dead even when its pid can't be probed (other host).  Mirrors the lease
# rule: silence past the grace is the fleet's definition of death.
_MIN_SILENCE_S = 5.0


def _local_pid_alive(pid: int) -> Optional[bool]:
    try:
        os.kill(int(pid), 0)
        return True
    except ProcessLookupError:
        return False
    except Exception:  # noqa: BLE001 — no permission or odd pid: no information
        return None


def _root_path(root: str) -> str:
    """Filesystem path behind a root URL (rings and spools are
    local-filesystem artifacts)."""
    from ..storage_plugin import parse_url

    try:
        protocol, path = parse_url(root)
        return path if protocol in ("fs", "file") else root
    except Exception:  # noqa: BLE001 — not a URL: use it as a path
        return root


# ------------------------------------------------------- per-process story


def _reconstruct_process(path: str, records: List[Dict[str, Any]], grace_s: float) -> Dict[str, Any]:
    """One ring -> one process story: identity, open op, last phase, last
    progress, fault record, death verdict."""
    pid = host = None
    last_t = 0.0
    open_ops: Dict[str, Dict[str, Any]] = {}
    last_phase: Optional[str] = None
    last_progress: Optional[Dict[str, Any]] = None
    fault: Optional[Dict[str, Any]] = None
    rank: Optional[int] = None
    stalls = 0
    preempting = False
    peer_verdicts: List[Dict[str, Any]] = []
    lease_events: List[str] = []
    for rec in records:
        pid = rec.get("pid", pid)
        host = rec.get("host", host)
        last_t = max(last_t, float(rec.get("t") or 0.0))
        kind = rec.get("kind")
        name = str(rec.get("name", ""))
        data = rec.get("data") or {}
        if kind == "op":
            op_id = str(data.get("op_id", ""))
            if name.endswith(".start"):
                open_ops[op_id] = {
                    "kind": name[: -len(".start")],
                    "op_id": op_id,
                    "rank": data.get("rank"),
                    "t": rec.get("t"),
                }
            elif name.endswith(".end"):
                open_ops.pop(op_id, None)
            if data.get("rank") is not None:
                rank = data.get("rank")
        elif kind == "phase":
            last_phase = name
        elif kind == "progress":
            last_progress = data
            if data.get("phase"):
                last_phase = data.get("phase")
            if data.get("rank") is not None:
                rank = data.get("rank")
        elif kind == "fault" and name == "crash":
            fault = data
            if data.get("phase"):
                last_phase = data.get("phase")
        elif kind == "event":
            if name == "watchdog.stall":
                stalls += 1
            elif name.startswith("preemption.flush"):
                preempting = True
        elif kind == "lease":
            lease_events.append(name)
            if name == "peer_dead":
                peer_verdicts.append(data)

    age_s = max(0.0, time.time() - last_t) if last_t else None
    dead = False
    verdict = "alive"
    silent = bool(open_ops) and age_s is not None and age_s > max(grace_s, _MIN_SILENCE_S)
    if fault is not None:
        dead, verdict = True, "crash_fault"
    elif pid is not None and host == socket.gethostname():
        alive = _local_pid_alive(pid)
        if alive is False:
            dead = True
            verdict = "pid_dead" if open_ops else "exited"
        elif alive is None and silent:
            dead, verdict = True, "silent_past_grace"
    elif silent:
        dead, verdict = True, "silent_past_grace"

    op = next(iter(open_ops.values()), None)
    return {
        "ring": path,
        "pid": pid,
        "host": host,
        "rank": rank,
        "last_seen": last_t or None,
        "age_s": round(age_s, 3) if age_s is not None else None,
        "open_op": op,
        "phase": last_phase,
        "phase_group": tanalyze.classify_phase(last_phase) if last_phase else None,
        "progress": last_progress,
        "fault": fault,
        "stalls": stalls,
        "preempting": preempting,
        "peer_verdicts": peer_verdicts,
        "lease_events": lease_events,
        "dead": dead,
        # Only a death with an op (or sweep) cut short is a *failure*;
        # "pid gone, every op closed" is a clean exit.
        "died_mid_work": dead
        and (
            fault is not None
            or bool(open_ops)
            or ("store_sweep.acquire" in lease_events and "store_sweep.release" not in lease_events)
        ),
        "verdict": verdict,
        "records": len(records),
    }


# --------------------------------------------------------- plane gathering


def _gather_coord_leases(coord_dir: Optional[str]) -> List[Dict[str, Any]]:
    """Op-lease stamps and tombstones from a FileStore coordination
    directory (keys are %2F-encoded paths: ``oplease%2F<rank>``)."""
    from ..dist_store import OP_LEASE_PREFIX

    if not coord_dir or not os.path.isdir(coord_dir):
        return []
    grace = knobs.get_lease_grace_s() or 10.0
    prefix = f"{OP_LEASE_PREFIX}%2F"
    out: List[Dict[str, Any]] = []
    now = time.time()
    for name in sorted(os.listdir(coord_dir)):
        if not name.startswith(prefix) or name.endswith(".lock"):
            continue
        try:
            with open(os.path.join(coord_dir, name), "rb") as f:
                raw = f.read()
        except OSError:
            continue
        entry: Dict[str, Any] = {"rank": name[len(prefix):]}
        try:
            entry["rank"] = int(entry["rank"])
        except ValueError:
            pass
        if raw == b"done":
            entry["state"] = "tombstone"
        else:
            try:
                stamp = float(raw)
                entry["stamp"] = stamp
                entry["age_s"] = round(now - stamp, 3)
                entry["state"] = "live" if now - stamp <= grace else "stale"
            except ValueError:
                entry["state"] = "unreadable"
        out.append(entry)
    return out


def _gather_root_debris(root: str) -> Dict[str, Any]:
    from ..manager import SnapshotManager
    from ..pg_wrapper import PGWrapper

    out: Dict[str, Any] = {
        "orphan_steps": [],
        "orphan_segments": [],
        "orphan_chunks": [],
        "inflight_markers": [],
        "committed_points": [],
    }
    try:
        mgr = SnapshotManager(root, pg=PGWrapper())
    except Exception:  # noqa: BLE001 — no manager root: no debris plane
        return out
    try:
        orphans, orphan_chunks, orphan_segs = mgr.gc_detail(apply=False)
        out["orphan_steps"] = orphans
        out["orphan_chunks"] = orphan_chunks
        out["orphan_segments"] = orphan_segs
    except Exception:  # noqa: BLE001 — a missing plane narrows the report
        pass
    try:
        out["inflight_markers"] = mgr.inflight_markers()
    except Exception:  # noqa: BLE001
        pass
    try:
        out["committed_points"] = [
            {"step": step, "kind": kind, "committed_at": ts} for step, kind, ts in mgr.restore_point_times()
        ]
    except Exception:  # noqa: BLE001
        pass
    return out


def _stamp_age(doc: Dict[str, Any], now: float) -> float:
    try:
        return now - float(doc.get("stamp", 0.0))
    except (TypeError, ValueError):
        return float("inf")


def _gather_store_state(store_url: Optional[str]) -> Optional[Dict[str, Any]]:
    if store_url is None:
        return None
    from .. import store as store_mod
    from ..storage_plugin import url_to_storage_plugin

    out: Dict[str, Any] = {"url": store_url}
    try:
        storage = url_to_storage_plugin(store_url)
    except Exception:  # noqa: BLE001 — unreachable store: its URL only
        return out
    grace = store_mod._liveness_grace()
    now = time.time()
    try:
        out["epoch"] = store_mod.read_epoch(storage)
        leases: List[Dict[str, Any]] = []
        for name in store_mod._list_dir(storage, store_mod.LEASES_DIR):
            if not name.startswith("writer_"):
                continue
            doc = store_mod._read_json(storage, f"{store_mod.LEASES_DIR}/{name}")
            if doc is None:
                continue
            age = _stamp_age(doc, now)
            leases.append(
                {
                    "tenant": doc.get("tenant"),
                    "root": doc.get("root"),
                    "host": doc.get("host"),
                    "pid": doc.get("pid"),
                    "epoch": doc.get("epoch"),
                    "age_s": round(age, 3),
                    "stale": age > grace,
                }
            )
        out["writer_leases"] = leases
        sweep_doc = store_mod._read_json(storage, store_mod.SWEEP_LEASE_FNAME)
        if sweep_doc is not None:
            age = _stamp_age(sweep_doc, now)
            sweep_doc["age_s"] = round(age, 3)
            sweep_doc["stale"] = age > grace
        out["sweep_lease"] = sweep_doc
        out["ledger_entries"] = [
            {
                "relpath": relpath,
                "tenant": doc.get("tenant"),
                "pid": doc.get("pid"),
                "host": doc.get("host"),
                "chunks": len(doc.get("chunks") or []),
            }
            for relpath, doc in store_mod._ledger_entries(storage)
        ]
        out["quarantined"] = store_mod.quarantined_chunk_relpaths(storage)
    except Exception:  # noqa: BLE001 — a missing plane narrows the report
        pass
    finally:
        try:
            storage.sync_close()
        except Exception:  # noqa: BLE001
            pass
    try:
        cls = store_mod.chunk_classification(store_url)
        out["chunks"] = {
            "referenced": len(cls["referenced"]),
            "orphan": len(cls["orphan"]),
            "condemned": len(cls["condemned"]),
            "orphan_relpaths": cls["orphan"],
        }
    except Exception:  # noqa: BLE001
        pass
    return out


# ------------------------------------------------------------- classification


def _classify(
    first_dead: Optional[Dict[str, Any]],
    processes: List[Dict[str, Any]],
    store_state: Optional[Dict[str, Any]],
) -> str:
    if first_dead is None:
        return "stalled" if any(p["stalls"] for p in processes) else "no_failure"
    fault = first_dead.get("fault") or {}
    path = str(fault.get("path", ""))
    # Sweep-side deaths: the fault's control path (or an unreleased sweep
    # lease) places the kill inside the two-phase GC, not a take.
    if path.startswith("quarantine/"):
        return "killed_mid_condemn"
    if path.startswith("sweep/"):
        return "killed_mid_sweep"
    op = first_dead.get("open_op")
    if op is None:
        events = first_dead.get("lease_events") or []
        if "store_sweep.acquire" in events and "store_sweep.release" not in events:
            sweep = (store_state or {}).get("sweep_lease") or {}
            if sweep.get("phase") == "condemn":
                return "killed_mid_condemn"
            return "killed_mid_sweep"
        if first_dead.get("preempting"):
            return "preempted"
        return "killed"
    kind = str(op.get("kind", ""))
    if first_dead.get("preempting"):
        return "preempted"
    if kind in ("take", "async_take", "save"):
        return "killed_mid_take"
    if kind.startswith("restore"):
        return "killed_mid_restore"
    return f"killed_mid_{kind}" if kind else "killed"


def _remediation(
    root: str,
    classification: str,
    debris: Dict[str, Any],
    store_state: Optional[Dict[str, Any]],
    first_dead: Optional[Dict[str, Any]],
) -> Dict[str, Any]:
    actions: List[Dict[str, Any]] = []
    # A dead pid's in-flight marker defeats the gc liveness guard only
    # with --force; when the marker's pid is provably the dead process,
    # force is safe and required.
    dead_pids = {p["pid"] for p in [first_dead] if p}
    marker_pids = {m.get("pid") for m in debris.get("inflight_markers", [])}
    need_force = bool(marker_pids) and (bool(marker_pids & dead_pids) or first_dead is not None)
    if (
        debris.get("orphan_steps")
        or debris.get("orphan_segments")
        or debris.get("orphan_chunks")
        or debris.get("inflight_markers")
    ):
        actions.append(
            {
                "action": "gc",
                "force": need_force,
                "command": f"python -m torchsnapshot_tpu_torch gc {root} --apply" + (" --force" if need_force else ""),
                "reclaims": {
                    "steps": debris.get("orphan_steps", []),
                    "segments": debris.get("orphan_segments", []),
                    "chunks": len(debris.get("orphan_chunks", [])),
                    "markers": len(debris.get("inflight_markers", [])),
                },
            }
        )
    if store_state is not None:
        chunks = store_state.get("chunks") or {}
        stale_writers = [lease for lease in store_state.get("writer_leases", []) if lease.get("stale")]
        sweep = store_state.get("sweep_lease") or {}
        # An existing sweep lease is itself debris (release deletes it): a
        # dead sweeper's lease must be adopted for GC to resume.  Ledger
        # entries are NOT debris: a healthy store always has the committed
        # takes' reference-journal entries.
        if chunks.get("orphan") or store_state.get("quarantined") or stale_writers or sweep:
            # force adopts a dead sweeper's stale lease (mid-sweep and
            # mid-condemn kills): adoption is the documented convergence
            # path, and quarantine is idempotent.
            force = bool(sweep) and bool(sweep.get("stale"))
            actions.append(
                {
                    "action": "store_sweep",
                    "store": store_state.get("url"),
                    "force": force or classification in ("killed_mid_sweep", "killed_mid_condemn"),
                    "command": (
                        'python -c "from torchsnapshot_tpu_torch import store; '
                        f"print(store.sweep('{store_state.get('url')}', force=True))\""
                    ),
                }
            )
    committed = debris.get("committed_points", [])
    restore: Dict[str, Any] = {
        "committed_points": len(committed),
        "newest": committed[-1] if committed else None,
        # Orphans were never committed, so restore_latest's first candidate
        # IS the newest committed point: expected depth 1.
        "expected_fallback_depth": 1 if committed else 0,
    }
    if committed:
        actions.append(
            {
                "action": "restore_latest",
                "command": f"SnapshotManager(root).restore_latest(app_state)  # lands step {committed[-1]['step']}",
            }
        )
    return {"actions": actions, "restore": restore}


# ------------------------------------------------------------------ timeline


def _build_timeline(
    rings: Dict[str, List[Dict[str, Any]]],
    spool_entries: List[Dict[str, Any]],
    heartbeat: Optional[Dict[str, Any]],
    skew: Dict[str, float],
) -> List[Dict[str, Any]]:
    timeline: List[Dict[str, Any]] = []
    for records in rings.values():
        for rec in records:
            host = rec.get("host", "?")
            timeline.append(
                {
                    "t": float(rec.get("t") or 0.0) - skew.get(host, 0.0),
                    "source": "blackbox",
                    "host": host,
                    "pid": rec.get("pid"),
                    "kind": rec.get("kind"),
                    "name": rec.get("name"),
                    "data": rec.get("data"),
                }
            )
    for doc in spool_entries:
        host = doc.get("host", "?")
        timeline.append(
            {
                "t": float(doc.get("publish_time") or 0.0) - skew.get(host, 0.0),
                "source": "fleet_spool",
                "host": host,
                "pid": doc.get("pid"),
                "kind": "spool",
                "name": "suspected_dead" if doc.get("_stale") else "beacon",
                "data": {
                    "kind": doc.get("kind"),
                    "rank": doc.get("rank"),
                    "op_id": str(doc.get("op_id", ""))[:8],
                    "age_s": doc.get("_age_s"),
                },
            }
        )
    if heartbeat is not None:
        timeline.append(
            {
                "t": float(heartbeat.get("heartbeat_time") or 0.0),
                "source": "heartbeat",
                "host": None,
                "pid": None,
                "kind": "heartbeat",
                "name": heartbeat.get("op_kind", heartbeat.get("action")),
                "data": {
                    "phase": heartbeat.get("phase"),
                    "trace_id": heartbeat.get("trace_id"),
                    "done": heartbeat.get("done"),
                    "success": heartbeat.get("success"),
                },
            }
        )
    timeline.sort(key=lambda e: e["t"])
    return timeline


def to_perfetto(report: Dict[str, Any]) -> Dict[str, Any]:
    """Timeline as Chrome/Perfetto instant events, on the same pid axes as
    the tracing plane, so a postmortem opens beside the op's trace files."""
    events: List[Dict[str, Any]] = []
    for entry in report.get("timeline", []):
        args = {"source": entry.get("source"), "host": entry.get("host")}
        if entry.get("data"):
            args.update({k: v for k, v in entry["data"].items() if v is not None})
        events.append(
            {
                "name": f"{entry.get('kind')}:{entry.get('name')}",
                "ph": "i",
                "s": "g",
                "ts": entry["t"] * 1e6,
                "pid": entry.get("pid") or 0,
                "tid": 0,
                "args": args,
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ------------------------------------------------------------------ analysis


def _spool_process(doc: Dict[str, Any]) -> Dict[str, Any]:
    """A suspected-dead spool entry of a pid with no ring (recorder off in
    that process), as a process story: it still names the dead worker."""
    return {
        "ring": None,
        "pid": doc.get("pid"),
        "host": doc.get("host"),
        "rank": doc.get("rank"),
        "last_seen": doc.get("publish_time"),
        "age_s": doc.get("_age_s"),
        "open_op": {"kind": doc.get("kind"), "op_id": doc.get("op_id"), "rank": doc.get("rank")},
        "phase": None,
        "phase_group": None,
        "progress": doc.get("op"),
        "fault": None,
        "stalls": 0,
        "preempting": False,
        "peer_verdicts": [],
        "lease_events": [],
        "dead": True,
        "died_mid_work": True,
        "verdict": "spool_stale",
        "records": 0,
    }


def _implicated(
    processes: List[Dict[str, Any]],
    store_state: Optional[Dict[str, Any]],
    first_dead: Optional[Dict[str, Any]],
) -> Dict[str, Any]:
    """The peer the survivors convicted, and the tenant whose debris it is."""
    peer = None
    verdicts = [v for p in processes for v in p["peer_verdicts"]]
    if verdicts:
        v = verdicts[0]
        peer = {"rank": v.get("peer"), "lease_age_s": v.get("age_s"), "convicted_by_rank": v.get("rank")}
    tenant = None
    if store_state is not None:
        for lease in store_state.get("writer_leases", []):
            if lease.get("stale"):
                tenant = {"tenant": lease.get("tenant"), "root": lease.get("root"), "pid": lease.get("pid")}
                break
        if tenant is None:
            dead_pid = first_dead.get("pid") if first_dead else None
            for entry in store_state.get("ledger_entries", []):
                if dead_pid is not None and entry.get("pid") == dead_pid:
                    tenant = {"tenant": entry.get("tenant"), "ledger": entry.get("relpath")}
                    break
    return {"peer": peer, "tenant": tenant}


def _read_heartbeat(path: Optional[str]) -> Optional[Dict[str, Any]]:
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def analyze_root(
    root: str,
    store_url: Optional[str] = None,
    coord_dir: Optional[str] = None,
    heartbeat_path: Optional[str] = None,
    blackbox_dir: Optional[str] = None,
) -> Dict[str, Any]:
    """The full postmortem report for a manager root.  Pure read (the
    fleet-spool scan runs with sweep off); never raises for a missing
    plane: absent inputs narrow the verdict, they don't fail it."""
    root_path = _root_path(root)
    if blackbox_dir is None:
        blackbox_dir = knobs.get_blackbox_dir() or os.path.join(root_path, BLACKBOX_DIRNAME)
    grace = knobs.get_lease_grace_s() or 10.0

    rings = blackbox.read_all(blackbox_dir)
    processes = [_reconstruct_process(path, records, grace) for path, records in rings.items() if records]

    spool = fleet.resolve_spool(root_path)
    spool_entries = fleet.collect(spool, sweep=False) if spool is not None else []
    skew: Dict[str, float] = {}
    if spool is not None:
        try:
            skew = ttrace.host_skew_from_spool(spool)
        except Exception:  # noqa: BLE001 — no skew: stamps as recorded
            skew = {}

    heartbeat_doc = _read_heartbeat(heartbeat_path or knobs.get_heartbeat_file())
    coord_leases = _gather_coord_leases(coord_dir if coord_dir is not None else knobs.get_store_path())
    debris = _gather_root_debris(root)
    if store_url is None:
        store_url = _resolve_store(root)
    store_state = _gather_store_state(store_url)

    # Spool-side deaths reinforce ring-side verdicts.
    ring_pids = {p["pid"] for p in processes}
    processes.extend(
        _spool_process(doc) for doc in spool_entries if doc.get("_stale") and doc.get("pid") not in ring_pids
    )

    dead = [p for p in processes if p["died_mid_work"]]
    dead.sort(key=lambda p: p["last_seen"] - skew.get(p.get("host") or "", 0.0) if p["last_seen"] else 0.0)
    first_dead = dead[0] if dead else None
    classification = _classify(first_dead, processes, store_state)

    progress = (first_dead or {}).get("progress") or {}
    pbytes = progress.get("bytes") or {}
    open_op = (first_dead or {}).get("open_op") or {}
    report = {
        "root": root,
        "blackbox_dir": blackbox_dir,
        "generated_at": time.time(),
        "classification": classification,
        "first_dead": (
            {
                "pid": first_dead["pid"],
                "host": first_dead["host"],
                "rank": first_dead["rank"],
                "verdict": first_dead["verdict"],
                "op": open_op.get("kind"),
                "op_id": open_op.get("op_id"),
                "phase": first_dead["phase"],
                "phase_group": first_dead["phase_group"],
                "fault": first_dead["fault"],
                "last_seen": first_dead["last_seen"],
                "age_s": first_dead["age_s"],
            }
            if first_dead
            else None
        ),
        "bytes": {"staged": pbytes.get("staged"), "written": pbytes.get("written")},
        "processes": processes,
        "coord_leases": coord_leases,
        "debris": debris,
        "store": store_state,
        "implicated": _implicated(processes, store_state, first_dead),
        "skew": skew,
        "heartbeat": heartbeat_doc,
    }
    report["remediation"] = _remediation(root, classification, debris, store_state, first_dead)
    report["timeline"] = _build_timeline(rings, spool_entries, heartbeat_doc, skew)
    tmetrics.maybe_install_bridge()
    tmetrics.record_postmortem_report(classification)
    log_event(
        Event(
            name="postmortem.report",
            metadata={
                "root": root,
                "classification": classification,
                "first_dead_pid": (first_dead or {}).get("pid"),
                "processes": len(processes),
            },
        )
    )
    return report


def _resolve_store(root: str) -> Optional[str]:
    from ..store import _resolve_store_url

    try:
        return _resolve_store_url(root)
    except Exception:  # noqa: BLE001 — no store plane
        return None


# ----------------------------------------------------------------- rendering


def format_report(report: Dict[str, Any]) -> str:
    lines: List[str] = []
    out = lines.append
    out(f"postmortem: {report['root']}")
    out(f"classification: {report['classification']}")
    fd = report.get("first_dead")
    if fd:
        where = f" on {fd['host']}" if fd.get("host") else ""
        rank = f" rank {fd['rank']}" if fd.get("rank") is not None else ""
        out(f"first dead: pid {fd['pid']}{rank}{where} ({fd['verdict']})")
        if fd.get("op"):
            out(f"  op at death: {fd['op']} ({str(fd.get('op_id'))[:8]})")
        if fd.get("phase"):
            out(f"  phase at death: {fd['phase']} (group {fd.get('phase_group')})")
        fault = fd.get("fault")
        if fault:
            out(f"  injected kill point: {fault.get('op')} {fault.get('path')}")
    else:
        out("no process died mid-work")
    b = report.get("bytes") or {}
    if b.get("staged") is not None:
        out(f"bytes at death: staged {b.get('staged')} / written {b.get('written')}")
    debris = report.get("debris") or {}
    out(
        f"debris: {len(debris.get('orphan_steps', []))} orphan step(s), "
        f"{len(debris.get('orphan_segments', []))} orphan segment(s), "
        f"{len(debris.get('orphan_chunks', []))} orphan chunk(s), "
        f"{len(debris.get('inflight_markers', []))} in-flight marker(s)"
    )
    store = report.get("store")
    if store and store.get("chunks"):
        ch = store["chunks"]
        stale_writers = sum(1 for lease in store.get("writer_leases", []) if lease.get("stale"))
        out(
            f"store {store['url']}: {ch.get('referenced')} referenced / "
            f"{ch.get('orphan')} orphan / {ch.get('condemned')} condemned "
            f"chunk(s); {stale_writers} stale writer lease(s); "
            f"{len(store.get('quarantined', []))} quarantined"
        )
        sweep = store.get("sweep_lease")
        if sweep:
            out(
                f"  sweep lease: phase {sweep.get('phase')} epoch {sweep.get('epoch')} "
                f"({'STALE' if sweep.get('stale') else 'live'}, pid {sweep.get('pid')})"
            )
    imp = report.get("implicated") or {}
    if imp.get("peer"):
        p = imp["peer"]
        out(
            f"implicated peer: rank {p.get('rank')} (lease {p.get('lease_age_s')}s stale, "
            f"convicted by rank {p.get('convicted_by_rank')})"
        )
    if imp.get("tenant"):
        t = imp["tenant"]
        out(f"implicated tenant: {t.get('tenant')} ({t.get('root', '')})")
    for lease in report.get("coord_leases", []):
        age = f" (age {lease.get('age_s')}s)" if lease.get("age_s") is not None else ""
        out(f"coord lease rank {lease.get('rank')}: {lease.get('state')}{age}")
    rem = report.get("remediation") or {}
    actions = rem.get("actions") or []
    if actions:
        out("remediation:")
        for a in actions:
            out(f"  [{a['action']}] {a.get('command')}")
    restore = rem.get("restore") or {}
    newest = f", newest step {restore['newest']['step']}" if restore.get("newest") else ""
    out(f"restore: {restore.get('committed_points', 0)} committed point(s) available{newest}")
    return "\n".join(lines)
