"""Bottleneck analysis over per-rank trace files, profiles and telemetry
sidecars.

Counterpart of ``torchsnapshot_tpu/telemetry/analyze.py``, with its names,
its report keys and its verdicts: either package's analyzer reads the
other's trace directories, profile directories and sidecars, since their
formats are shared.  It answers the operator's questions after the fact:
*was this take d2h-bound, serialize-bound, storage-bound, or throttled by
a wait, and which rank dragged the op*.

Input: a ``TPUSNAP_TRACE_DIR`` of per-rank ``<kind>-<op8>-rank<r>``
trace-event files (telemetry/trace.py), optionally enriched with the
snapshot's ``telemetry/*.json`` sidecars.  Per (kind, op) the analyzer
computes, per rank and across ranks:

- **per-phase exclusive wall**: the union of each leaf phase's intervals
  (``cat: "phase"`` spans: d2h, serialize, compress, checksum, fs_write,
  h2d_*, ...), so concurrent workers don't double-count;
- **scheduler idle**: op wall not covered by ANY phase interval, the time
  the pipeline spent in barriers, planning, or waiting on nothing
  attributable;
- **the limiting resource**: a wait group (``memory_budget``,
  ``io_concurrency``, ``barrier``, ``cache_wait``) when it dominates, else
  the dominant of the d2h / serialize / storage_io / h2d phase groups;
- **cross-rank skew**: p50/p99/max op duration, the straggler rank, and
  the slowest rank per phase.

The port records phases the JAX package does not have (the pinned and
device staging allocations, the native write batch, the S3 and GCS
plugins' requests, the process-group wait, the CAS delta probe):
:data:`PHASE_GROUPS` classifies each into the group of its work, so the
JAX package's analyzer reads them as ``other`` and this one does not.

Also here: :func:`profile_report` over the sampling profiler's files,
:func:`barrier_blame` over the async take's commit-barrier table, and
:func:`peer_report` over the serving plane's ``peer_fetch`` and
``peerd_handle`` spans.  Schema-invalid trace or profile input raises
:class:`ValueError`: a corrupt trace must never produce a
confident-looking report.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from . import trace as ttrace

# Leaf-phase → resource-group classification.  Storage phases are matched
# by suffix so every backend (fs/mem/gcs/s3) lands in storage_io without
# this table needing to know plugin names.
PHASE_GROUPS: Dict[str, frozenset] = {
    # pinned_alloc (staging.py) page-locks the host buffer a D2H copy lands
    # in, stage_alloc (device_staging.py) allocates the device-side copy of
    # an async take: both are paid for the copy off the device.
    "d2h": frozenset({"d2h", "device_stage", "pinned_alloc", "stage_alloc"}),
    "serialize": frozenset(
        {
            "serialize",
            "compress",
            "decompress",
            "checksum",
            "slab_pack",
            "consume_copy",
            "scatter_copy",
            # Content-defined chunk-boundary scan (chunker.py): a rolling
            # hash over the staged bytes — hash-class work, same group as
            # checksum.
            "cdc_chunk",
            # The CAS delta probe (cas.py): stages each leaf and hashes it
            # to find the chunks a take can skip.  Its D2H is recorded as
            # d2h of its own, so the rest of its wall is the hash.
            "prestage_delta",
        }
    ),
    "h2d": frozenset({"h2d_dispatch", "h2d_land"}),
    "memory_budget": frozenset({"budget_wait"}),
    "io_concurrency": frozenset({"io_slot_wait"}),
    # Waits, not work: barrier_wait is wall parked in LinearBarrier
    # arrive/depart (commit-barrier skew — the straggler's peers burn it),
    # pg_wait is wall parked on a process-group key a peer has not set yet
    # (pg_wrapper.py), cache_wait is wall parked on a sibling's in-flight
    # cache populate (the single-flight lock).  They classify as wait
    # groups so they can name the limiting resource without inflating any
    # work group.
    "barrier": frozenset({"barrier_wait", "pg_wait"}),
    "cache_wait": frozenset({"cache_wait"}),
    # The native data plane's fused phases: native_write_hash is hash+write
    # in one call, native_write_batch one call writing a batch of small
    # files (native_write_batched a member's wall until its batch is
    # written), and native_read is the parallel pread fan-out — all wall
    # spent driving storage.  The chunk cache's phases (cache.py) are
    # local-disk I/O standing in for origin storage, and peer_read is wall
    # spent pulling a chunk from a fleet peer's daemon (peer.py): the same
    # group.  The object stores' requests (storage_plugins/s3.py, gcs.py)
    # are named by their request, not by a _write/_read suffix, and
    # gcs_retry is the backoff before a storage request is sent again.
    "storage_io": frozenset(
        {
            "native_write_hash",
            "native_write_batch",
            "native_write_batched",
            "native_read",
            "cache_read",
            "cache_populate",
            "peer_read",
            "s3_put",
            "s3_multipart",
            "s3_multipart_part",
            "s3_get",
            "s3_fanout",
            "s3_copy",
            "gcs_upload",
            "gcs_chunk_put",
            "gcs_get",
            "gcs_fanout",
            "gcs_copy",
            "gcs_retry",
        }
    ),
    # Serving-plane spans: peer_fetch is the client side of a peer chunk
    # fetch (peer.py, includes rendezvous retries + digest verify),
    # peerd_handle is the daemon side of one HTTP request (peerd.py,
    # recorded with a remote parent span from the traceparent header).
    # A distinct group so the peer report can aggregate them without
    # muddying the storage_io attribution of the restore pipeline.
    "peer": frozenset({"peer_fetch", "peerd_handle"}),
}
_STORAGE_SUFFIXES = ("_write", "_read")
# Groups that are time spent WAITING on a resource rather than doing
# work; the limiting-resource classifier treats them specially and the
# dominant-phase ranking excludes them.
WAIT_GROUPS = ("memory_budget", "io_concurrency", "barrier", "cache_wait")
# A wait group only names the limiting resource when it covers at least
# this share of the op (below that it's contention noise, and the real
# answer is the dominant work group).
_WAIT_DOMINANCE_SHARE = 0.2


def classify_phase(phase: str) -> str:
    for group, members in PHASE_GROUPS.items():
        if phase in members:
            return group
    if phase.endswith(_STORAGE_SUFFIXES):
        return "storage_io"
    # Op-driver attribution tags (<kind>_drive from OpMonitor,
    # io_drain_drive from the scheduler's background drain): wall the
    # driving thread spends between explicit phases — plan building,
    # event-loop turns, future plumbing.  Profiler-only pseudo-phases;
    # they never appear as trace spans.
    if phase.endswith("_drive"):
        return "driver"
    return "other"


def _merge_intervals(
    intervals: List[Tuple[float, float]],
) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for begin, end in sorted(intervals):
        if merged and begin <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((begin, end))
    return merged


def _union_s(intervals: List[Tuple[float, float]]) -> float:
    return sum(e - b for b, e in _merge_intervals(intervals))


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[int(idx)]


# ------------------------------------------------------------------ loading


def load_trace_dir(trace_dir: str) -> List[Dict[str, Any]]:
    """Load and schema-validate every trace file under ``trace_dir``.
    Raises ValueError on the first invalid file; returns the parsed docs
    (each with ``_file`` set to its basename)."""
    paths = sorted(
        glob.glob(os.path.join(trace_dir, f"*{ttrace.TRACE_FILE_SUFFIX}"))
    )
    docs: List[Dict[str, Any]] = []
    for path in paths:
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: unreadable trace file: {e}") from None
        problems = ttrace.validate_trace(doc)
        if problems:
            raise ValueError(f"{path}: invalid trace: {problems[:3]}")
        doc["_file"] = os.path.basename(path)
        docs.append(doc)
    return docs


def load_sidecars(snapshot_url: str) -> List[Dict[str, Any]]:
    """Read a snapshot's telemetry sidecars (best effort: a snapshot
    without sidecars yields [])."""
    from ..storage_plugin import url_to_storage_plugin
    from . import sidecar

    storage = url_to_storage_plugin(snapshot_url)
    try:
        return sidecar.read_all(storage)
    finally:
        storage.sync_close()


# ----------------------------------------------------------------- analysis


def _rank_analysis(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Per-phase walls, bytes, idle, and op duration for one rank's file."""
    events = doc.get("traceEvents", [])
    op_dur_s: Optional[float] = None
    op_begin = op_end = None
    phase_intervals: Dict[str, List[Tuple[float, float]]] = {}
    phase_bytes: Dict[str, int] = {}
    span_lo = span_hi = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        ts = float(ev.get("ts", 0.0))
        dur = float(ev.get("dur", 0.0))
        span_lo = ts if span_lo is None else min(span_lo, ts)
        span_hi = ts + dur if span_hi is None else max(span_hi, ts + dur)
        if ev.get("cat") == "op":
            op_dur_s = dur / 1e6
            op_begin, op_end = ts, ts + dur
        elif ev.get("cat") == "phase":
            name = ev["name"]
            phase_intervals.setdefault(name, []).append((ts, ts + dur))
            nbytes = (ev.get("args") or {}).get("bytes")
            if isinstance(nbytes, (int, float)):
                phase_bytes[name] = phase_bytes.get(name, 0) + int(nbytes)
    if op_dur_s is None:
        # Crashed op whose root span never closed: use the event envelope.
        op_begin = span_lo or 0.0
        op_end = span_hi or 0.0
        op_dur_s = (op_end - op_begin) / 1e6
    phases = {
        name: {
            "wall_s": round(_union_s(ivs) / 1e6, 6),
            "bytes": phase_bytes.get(name, 0),
            "n": len(ivs),
        }
        for name, ivs in phase_intervals.items()
    }
    busy_s = _union_s([iv for ivs in phase_intervals.values() for iv in ivs]) / 1e6
    idle_s = max(0.0, op_dur_s - busy_s)
    return {
        "duration_s": round(op_dur_s, 6),
        "phases": phases,
        "busy_s": round(busy_s, 6),
        "idle_s": round(idle_s, 6),
        "idle_frac": round(idle_s / op_dur_s, 4) if op_dur_s > 0 else 0.0,
    }


def _classify_limiting(
    group_walls: Dict[str, float], duration_s: float
) -> str:
    """Name the limiting resource from group walls: a dominant wait group
    (budget / io-slot) wins outright — the pipeline was *throttled*, and
    attacking the work phases won't help until the throttle moves."""
    if duration_s <= 0 or not group_walls:
        return "unknown"
    for wait_group in WAIT_GROUPS:
        wait = group_walls.get(wait_group, 0.0)
        work_max = max(
            (v for k, v in group_walls.items() if k not in WAIT_GROUPS),
            default=0.0,
        )
        if wait / duration_s >= _WAIT_DOMINANCE_SHARE and wait >= work_max:
            return wait_group
    work = {
        k: v
        for k, v in group_walls.items()
        if k not in WAIT_GROUPS and k != "other"
    }
    if not work:
        return "unknown"
    return max(work, key=work.get)


def analyze_traces(
    docs: List[Dict[str, Any]],
    sidecars: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Group trace docs by (kind, op) and compute the cross-rank report."""
    by_op: Dict[Tuple[str, str], Dict[int, Dict[str, Any]]] = {}
    for doc in docs:
        other = doc.get("otherData", {})
        key = (other.get("kind", "?"), str(other.get("op", "?")))
        rank = int(other.get("rank", 0))
        by_op.setdefault(key, {})[rank] = _rank_analysis(doc)
    sidecars = sidecars or []

    ops: List[Dict[str, Any]] = []
    for (kind, op), ranks in sorted(by_op.items()):
        durations = {r: a["duration_s"] for r, a in ranks.items()}
        sorted_durs = sorted(durations.values())
        p50 = _percentile(sorted_durs, 0.5)
        straggler = max(durations, key=durations.get)
        # Aggregate phases: mean wall across ranks (the per-rank view stays
        # available), slowest rank per phase.
        phase_names = sorted(
            {p for a in ranks.values() for p in a["phases"]}
        )
        phases: Dict[str, Any] = {}
        for name in phase_names:
            walls = {
                r: a["phases"].get(name, {}).get("wall_s", 0.0)
                for r, a in ranks.items()
            }
            phases[name] = {
                "wall_s": round(sum(walls.values()) / len(walls), 6),
                "max_wall_s": round(max(walls.values()), 6),
                "slowest_rank": max(walls, key=walls.get),
                "bytes": sum(
                    a["phases"].get(name, {}).get("bytes", 0)
                    for a in ranks.values()
                ),
                "group": classify_phase(name),
                "by_rank": {str(r): round(w, 6) for r, w in walls.items()},
            }
        group_walls: Dict[str, float] = {}
        for name, info in phases.items():
            group_walls[info["group"]] = (
                group_walls.get(info["group"], 0.0) + info["wall_s"]
            )
        mean_duration = sum(sorted_durs) / len(sorted_durs)
        limiting = _classify_limiting(group_walls, mean_duration)
        work_phases = {
            n: i
            for n, i in phases.items()
            if i["group"] not in WAIT_GROUPS
        }
        dominant_phase = (
            max(work_phases, key=lambda n: work_phases[n]["wall_s"])
            if work_phases
            else None
        )
        op_sidecars = {
            str(d.get("rank", "?")): d
            for d in sidecars
            if str(d.get("op_id", ""))[:8] == op[:8]
            and d.get("action") == kind
        }
        entry: Dict[str, Any] = {
            "kind": kind,
            "op": op,
            "ranks": sorted(ranks),
            "world": len(ranks),
            "duration_s": {
                "p50": round(p50, 6),
                "p99": round(_percentile(sorted_durs, 0.99), 6),
                "max": round(sorted_durs[-1], 6),
                "by_rank": {
                    str(r): round(d, 6) for r, d in durations.items()
                },
            },
            "straggler_rank": straggler,
            "skew": round(durations[straggler] / p50, 4) if p50 > 0 else 1.0,
            "idle": {
                "mean_s": round(
                    sum(a["idle_s"] for a in ranks.values()) / len(ranks), 6
                ),
                "by_rank": {
                    str(r): a["idle_s"] for r, a in ranks.items()
                },
            },
            "phases": phases,
            "groups": {
                g: round(w, 6) for g, w in sorted(group_walls.items())
            },
            "limiting_resource": limiting,
            "dominant_phase": dominant_phase,
        }
        if op_sidecars:
            entry["sidecars"] = {
                r: {
                    k: d.get(k)
                    for k in (
                        "duration_s",
                        "bytes",
                        "throughput_gbps",
                        "rss_high_water_bytes",
                        "staging_mode",
                        "knobs",
                    )
                    if k in d
                }
                for r, d in op_sidecars.items()
            }
        ops.append(entry)
    return {"ops": ops}


# ------------------------------------------------------------ profile report


def load_profile_dir(profile_dir: str) -> List[Dict[str, Any]]:
    """Load + schema-validate every profile file under ``profile_dir``
    (delegates to telemetry/profiler.py; ValueError on garbage, same
    contract as load_trace_dir)."""
    from . import profiler

    return profiler.load_profile_dir(profile_dir)


def profile_report(
    docs: List[Dict[str, Any]], top: int = 5
) -> Dict[str, Any]:
    """Fold per-rank profile documents into the analyzer's view.

    Per (kind, op), merged across ranks: per-phase on/off-CPU seconds
    cross-checked against PHASE_GROUPS (each phase carries its resource
    group, so profile CPU and trace wall line up row for row), the
    top-N hottest frames per phase by self CPU, the on-vs-off-CPU
    split, the untagged on-CPU share (the attribution-health signal),
    the calibrated sampler overhead, and a **dominant CPU sink**
    verdict — the (phase, frame) bucket burning the most CPU, the
    profile-plane counterpart of the trace report's limiting-resource
    classification."""
    from . import profiler

    by_op: Dict[Tuple[str, str], List[Dict[str, Any]]] = {}
    for doc in docs:
        meta = doc.get("tpusnap") or {}
        key = (str(meta.get("kind", "?")), str(meta.get("op", "?")))
        by_op.setdefault(key, []).append(meta)

    profiles: List[Dict[str, Any]] = []
    for (kind, op), metas in sorted(by_op.items()):
        merged = profiler.merge_metas(metas)
        weight = float(merged.get("weight_s") or 0.0)
        phases: Dict[str, Any] = {}
        sink = None  # (cpu_s, phase, frame)
        for phase, states in sorted((merged.get("stacks") or {}).items()):
            on = states.get("on") or {}
            off = states.get("off") or {}
            frame_cpu: Dict[str, float] = {}
            for stack, n in on.items():
                leaf = stack.rsplit(";", 1)[-1]
                frame_cpu[leaf] = frame_cpu.get(leaf, 0.0) + n * weight
            hottest = [
                {"frame": f, "cpu_s": round(s, 4)}
                for f, s in sorted(
                    frame_cpu.items(), key=lambda kv: -kv[1]
                )[:top]
            ]
            cpu_s = sum(on.values()) * weight
            phases[phase] = {
                "cpu_s": round(cpu_s, 4),
                "offcpu_s": round(sum(off.values()) * weight, 4),
                "group": classify_phase(phase),
                "hottest": hottest,
            }
            if hottest and (sink is None or cpu_s > sink[0]):
                sink = (cpu_s, phase, hottest[0]["frame"])
        group_cpu: Dict[str, float] = {}
        for info in phases.values():
            group_cpu[info["group"]] = (
                group_cpu.get(info["group"], 0.0) + info["cpu_s"]
            )
        oncpu_s = merged["oncpu_samples"] * weight
        untagged_share = (
            merged["untagged_oncpu"] / merged["oncpu_samples"]
            if merged["oncpu_samples"]
            else 0.0
        )
        cal = merged.get("calibration") or {}
        profiles.append(
            {
                "kind": kind,
                "op": op,
                "ranks": sorted(
                    {m.get("rank") for m in metas if m.get("rank") is not None}
                ),
                "hz": merged.get("hz"),
                "duration_s": merged.get("duration_s"),
                "samples_total": merged["samples_total"],
                "oncpu_s": round(oncpu_s, 4),
                "offcpu_s": round(
                    (merged["samples_total"] - merged["oncpu_samples"])
                    * weight,
                    4,
                ),
                "untagged_oncpu_share": round(untagged_share, 4),
                "phases": phases,
                "groups_cpu_s": {
                    g: round(s, 4) for g, s in sorted(group_cpu.items())
                },
                "dominant_cpu_sink": (
                    {
                        "phase": sink[1],
                        "frame": sink[2],
                        "cpu_s": round(sink[0], 4),
                    }
                    if sink
                    else None
                ),
                "overhead": {
                    "per_tick_s": cal.get("per_tick_s"),
                    "estimated_s": cal.get("estimated_s"),
                },
            }
        )
    return {"profiles": profiles}


def render_profile(report: Dict[str, Any]) -> str:
    """Human-readable continuous-profiling report."""
    profiles = report.get("profiles", [])
    if not profiles:
        return "no profiles found (TPUSNAP_PROFILE unset during the run?)"
    lines: List[str] = []
    for prof in profiles:
        ranks = ",".join(str(r) for r in prof["ranks"])
        lines.append(
            f"{prof['kind']} {prof['op'][:8]} — profile, rank(s) {ranks}, "
            f"{prof['samples_total']} samples @ {prof['hz']:g} Hz "
            f"({prof['duration_s']:.2f}s)"
        )
        lines.append(
            f"  CPU: {prof['oncpu_s']:.2f}s on-CPU, "
            f"{prof['offcpu_s']:.2f}s off-CPU; untagged on-CPU share "
            f"{prof['untagged_oncpu_share']:.1%}"
        )
        sink = prof.get("dominant_cpu_sink")
        if sink:
            lines.append(
                f"  dominant CPU sink: {sink['phase']} / {sink['frame']} "
                f"({sink['cpu_s']:.2f}s)"
            )
        over = prof.get("overhead") or {}
        if over.get("estimated_s") is not None:
            lines.append(
                f"  sampler overhead: {over['estimated_s']:.4f}s estimated "
                f"({(over.get('per_tick_s') or 0) * 1e6:.0f}us/tick)"
            )
        lines.append(
            f"  {'phase':<16} {'cpu':>8} {'off-cpu':>8}  "
            f"{'group':<13} hottest frames"
        )
        ranked = sorted(
            prof["phases"].items(), key=lambda kv: -kv[1]["cpu_s"]
        )
        for name, info in ranked:
            hot = ", ".join(
                f"{h['frame']} {h['cpu_s']:.2f}s"
                for h in info["hottest"][:3]
            )
            lines.append(
                f"  {name:<16} {info['cpu_s']:>7.2f}s "
                f"{info['offcpu_s']:>7.2f}s  {info['group']:<13} {hot}"
            )
        lines.append("")
    return "\n".join(lines).rstrip()


# ------------------------------------------------------------ barrier blame


def _phase_wall(vals: Dict[str, Any]) -> float:
    """A sidecar phase record's wall seconds (phase_stats uses `wall`
    with `s` = thread-seconds; old records may carry only `s`)."""
    return float(vals.get("wall", vals.get("s", 0.0)) or 0.0)


def barrier_blame(
    sidecars: List[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Cross-rank commit-barrier skew attribution, one report per op.

    Input: telemetry sidecars whose ``barrier`` block carries every
    rank's arrive/depart wall-clock stamps (recorded by
    ``LinearBarrier`` through the dist store and exchanged at commit
    time).  For each op the report names the skew (last arriver minus
    first), blames the last-arriving rank, and attributes the skew to
    that rank's dominant pre-barrier WORK phase (its per-rank phase
    walls ride the same sidecars) — the phase the fleet was actually
    waiting on.  Ops without barrier data are skipped."""
    by_op: Dict[Tuple[str, str], Dict[int, Dict[str, Any]]] = {}
    for doc in sidecars:
        action = doc.get("action", "?")
        op_id = str(doc.get("op_id", "?"))
        rank = int(doc.get("rank", 0))
        by_op.setdefault((action, op_id), {})[rank] = doc

    reports: List[Dict[str, Any]] = []
    for (action, op_id), ranks in sorted(by_op.items()):
        # Any rank's sidecar carries the full exchanged table; merge in
        # case some ranks' sidecar writes failed.
        arrivals: Dict[int, float] = {}
        departs: Dict[int, float] = {}
        for doc in ranks.values():
            table = (doc.get("barrier") or {}).get("arrivals") or {}
            for r, row in table.items():
                if "arrive" in row:
                    arrivals[int(r)] = float(row["arrive"])
                if "depart" in row:
                    departs[int(r)] = float(row["depart"])
        if len(arrivals) < 2:
            continue
        first_rank = min(arrivals, key=arrivals.get)
        blamed_rank = max(arrivals, key=arrivals.get)
        t0 = arrivals[first_rank]
        skew_s = arrivals[blamed_rank] - t0
        blamed_doc = ranks.get(blamed_rank)
        blamed_phase = None
        blamed_phase_wall_s = None
        if blamed_doc is not None:
            work = {
                name: _phase_wall(vals)
                for name, vals in (blamed_doc.get("phases") or {}).items()
                if classify_phase(name) not in WAIT_GROUPS
            }
            if work:
                blamed_phase = max(work, key=work.get)
                blamed_phase_wall_s = round(work[blamed_phase], 6)
        barrier_wait_s = {
            str(r): round(
                _phase_wall((doc.get("phases") or {}).get("barrier_wait", {})),
                6,
            )
            for r, doc in sorted(ranks.items())
        }
        reports.append(
            {
                "kind": action,
                "op": op_id,
                "world": len(arrivals),
                "skew_s": round(skew_s, 6),
                "first_rank": first_rank,
                "blamed_rank": blamed_rank,
                "blamed_phase": blamed_phase,
                "blamed_phase_wall_s": blamed_phase_wall_s,
                "arrivals_rel_s": {
                    str(r): round(t - t0, 6)
                    for r, t in sorted(arrivals.items())
                },
                "departs_rel_s": {
                    str(r): round(t - t0, 6)
                    for r, t in sorted(departs.items())
                },
                "barrier_wait_s": barrier_wait_s,
            }
        )
    return reports


def render_barrier(reports: List[Dict[str, Any]]) -> str:
    """Human-readable barrier-blame table."""
    if not reports:
        return (
            "no barrier data (sidecars predate barrier stamping, the op "
            "was single-rank, or sidecars are disabled)"
        )
    lines: List[str] = []
    for rep in reports:
        lines.append(
            f"{rep['kind']} {rep['op'][:8]} — commit barrier, "
            f"{rep['world']} rank(s), skew {rep['skew_s']:.3f}s"
        )
        blame = f"rank {rep['blamed_rank']} arrived last"
        if rep["blamed_phase"] is not None:
            blame += (
                f"; its dominant pre-barrier phase: {rep['blamed_phase']} "
                f"({rep['blamed_phase_wall_s']:.2f}s wall)"
            )
        lines.append(f"  blame: {blame}")
        lines.append(
            f"  {'rank':>6} {'arrived+':>10} {'barrier_wait':>13}"
        )
        for r, rel in rep["arrivals_rel_s"].items():
            wait = rep["barrier_wait_s"].get(r, 0.0)
            marker = "  << straggler" if int(r) == rep["blamed_rank"] else ""
            lines.append(
                f"  {r:>6} {rel:>9.3f}s {wait:>12.3f}s{marker}"
            )
        lines.append("")
    return "\n".join(lines).rstrip()


# -------------------------------------------------------------- peer report


def peer_report(docs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Serving-plane report from ``peer_fetch`` / ``peerd_handle`` spans.

    Client side (``peer_fetch``, recorded by peer.py): per-peer p50/p99
    fetch latency, hit / reject / fallback rates, and the TTFB-vs-transfer
    split — was the slow peer slow to *answer* or slow to *stream*.
    Server side (``peerd_handle``, recorded by each daemon's
    ServerTracer): per-daemon request counts and latency, keyed by the
    daemon trace file's host.  ``slowest_peer`` names the peer with the
    worst p99 fetch latency."""
    peers: Dict[str, Dict[str, Any]] = {}
    daemons: Dict[str, Dict[str, Any]] = {}
    for doc in docs:
        other = doc.get("otherData", {})
        for ev in doc.get("traceEvents", []):
            if ev.get("ph") != "X":
                continue
            args = ev.get("args") or {}
            dur_s = float(ev.get("dur", 0.0)) / 1e6
            if ev.get("name") == "peer_fetch":
                addr = str(args.get("peer", "?"))
                row = peers.setdefault(
                    addr,
                    {
                        "latencies": [],
                        "ttfb_s": 0.0,
                        "transfer_s": 0.0,
                        "bytes": 0,
                        "statuses": {},
                    },
                )
                row["latencies"].append(dur_s)
                row["ttfb_s"] += float(args.get("ttfb_s", 0.0) or 0.0)
                row["transfer_s"] += float(
                    args.get("transfer_s", 0.0) or 0.0
                )
                nbytes = args.get("bytes")
                if isinstance(nbytes, (int, float)):
                    row["bytes"] += int(nbytes)
                status = str(args.get("status", "?"))
                row["statuses"][status] = row["statuses"].get(status, 0) + 1
            elif ev.get("name") == "peerd_handle":
                ident = str(
                    other.get("host", "?")
                ) + "/" + str(other.get("op", "?"))[:8]
                row = daemons.setdefault(
                    ident, {"latencies": [], "bytes": 0, "requests": 0}
                )
                row["requests"] += 1
                row["latencies"].append(dur_s)
                nbytes = args.get("bytes")
                if isinstance(nbytes, (int, float)):
                    row["bytes"] += int(nbytes)

    peer_rows: Dict[str, Any] = {}
    for addr, row in peers.items():
        lat = sorted(row["latencies"])
        n = len(lat)
        statuses = row["statuses"]
        hits = statuses.get("hit", 0)
        rejects = statuses.get("reject", 0)
        # Fallback-to-origin: the fetch ended without peer bytes (clean
        # miss or transport error) — rejects also fall back but are
        # counted separately because they indicate a corrupt peer.
        fallbacks = statuses.get("miss", 0) + statuses.get("error", 0)
        peer_rows[addr] = {
            "fetches": n,
            "p50_s": round(_percentile(lat, 0.5), 6),
            "p99_s": round(_percentile(lat, 0.99), 6),
            "max_s": round(lat[-1], 6) if lat else 0.0,
            "hit_rate": round(hits / n, 4) if n else 0.0,
            "reject_rate": round(rejects / n, 4) if n else 0.0,
            "fallback_rate": round(fallbacks / n, 4) if n else 0.0,
            "ttfb_mean_s": round(row["ttfb_s"] / n, 6) if n else 0.0,
            "transfer_mean_s": (
                round(row["transfer_s"] / n, 6) if n else 0.0
            ),
            "bytes": row["bytes"],
            "statuses": dict(sorted(statuses.items())),
        }
    daemon_rows = {
        ident: {
            "requests": row["requests"],
            "p50_s": round(
                _percentile(sorted(row["latencies"]), 0.5), 6
            ),
            "p99_s": round(
                _percentile(sorted(row["latencies"]), 0.99), 6
            ),
            "bytes": row["bytes"],
        }
        for ident, row in daemons.items()
    }
    slowest = (
        max(peer_rows, key=lambda a: peer_rows[a]["p99_s"])
        if peer_rows
        else None
    )
    return {
        "peers": dict(sorted(peer_rows.items())),
        "daemons": dict(sorted(daemon_rows.items())),
        "slowest_peer": slowest,
    }


def render_peer(report: Dict[str, Any]) -> str:
    """Human-readable per-peer serving report."""
    peers = report.get("peers", {})
    if not peers:
        return (
            "no peer_fetch spans in trace input (serving plane idle, or "
            "traces predate serving-plane tracing)"
        )
    lines: List[str] = [
        f"  {'peer':<22} {'fetch':>6} {'hit%':>5} {'rej%':>5} "
        f"{'fall%':>6} {'p50':>9} {'p99':>9} {'ttfb':>8} {'xfer':>8} "
        f"{'bytes':>10}"
    ]
    for addr, row in peers.items():
        lines.append(
            f"  {addr:<22} {row['fetches']:>6} "
            f"{row['hit_rate'] * 100:>4.0f}% {row['reject_rate'] * 100:>4.0f}% "
            f"{row['fallback_rate'] * 100:>5.0f}% "
            f"{row['p50_s'] * 1e3:>7.1f}ms {row['p99_s'] * 1e3:>7.1f}ms "
            f"{row['ttfb_mean_s'] * 1e3:>6.1f}ms "
            f"{row['transfer_mean_s'] * 1e3:>6.1f}ms "
            f"{_fmt_bytes(row['bytes']):>10}"
        )
    if report.get("slowest_peer"):
        slow = report["slowest_peer"]
        lines.append(
            f"  slowest peer: {slow} "
            f"(p99 {peers[slow]['p99_s'] * 1e3:.1f}ms)"
        )
    daemons = report.get("daemons", {})
    if daemons:
        lines.append(
            f"  {'daemon':<31} {'reqs':>6} {'p50':>9} {'p99':>9} "
            f"{'bytes':>10}"
        )
        for ident, row in daemons.items():
            lines.append(
                f"  {ident:<31} {row['requests']:>6} "
                f"{row['p50_s'] * 1e3:>7.1f}ms "
                f"{row['p99_s'] * 1e3:>7.1f}ms "
                f"{_fmt_bytes(row['bytes']):>10}"
            )
    return "\n".join(lines)


# ---------------------------------------------------------------- rendering


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


def render(analysis: Dict[str, Any]) -> str:
    """Human-readable report (one block per analyzed operation)."""
    lines: List[str] = []
    for op in analysis.get("ops", []):
        dur = op["duration_s"]
        lines.append(
            f"{op['kind']} {op['op'][:8]} — {op['world']} rank(s), "
            f"p50 {dur['p50']:.2f}s  p99 {dur['p99']:.2f}s  "
            f"max {dur['max']:.2f}s"
        )
        lines.append(
            f"  straggler: rank {op['straggler_rank']} "
            f"({dur['by_rank'][str(op['straggler_rank'])]:.2f}s, "
            f"{op['skew']:.2f}x the p50)"
        )
        limiting = op["limiting_resource"]
        dom = op["dominant_phase"]
        dom_str = ""
        if dom is not None:
            info = op["phases"][dom]
            share = info["wall_s"] / dur["p50"] if dur["p50"] > 0 else 0.0
            dom_str = (
                f"; dominant phase {dom} "
                f"({info['wall_s']:.2f}s wall, {share:.0%} of p50)"
            )
        lines.append(f"  limiting resource: {limiting}{dom_str}")
        lines.append(
            f"  scheduler idle (no phase active): "
            f"{op['idle']['mean_s']:.2f}s mean"
        )
        lines.append(
            f"  {'phase':<14} {'wall(mean)':>10} {'wall(max)':>10} "
            f"{'slowest':>8} {'bytes':>10}  group"
        )
        ranked = sorted(
            op["phases"].items(), key=lambda kv: -kv[1]["wall_s"]
        )
        for name, info in ranked:
            lines.append(
                f"  {name:<14} {info['wall_s']:>9.2f}s "
                f"{info['max_wall_s']:>9.2f}s "
                f"{'rank ' + str(info['slowest_rank']):>8} "
                f"{_fmt_bytes(info['bytes']):>10}  {info['group']}"
            )
        lines.append("")
    if not lines:
        return "no operations found in trace input"
    return "\n".join(lines).rstrip()
