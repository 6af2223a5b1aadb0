"""Sampling profiler: phase-attributed on- and off-CPU stack samples.

Counterpart of ``torchsnapshot_tpu/telemetry/profiler.py``.  The profile
documents are a contract between the packages: the file names
(``<kind>-<op8>-rank<r>.profile.json`` and ``.profile.collapsed``), the
speedscope layout with the tpusnap schema under the ``tpusnap`` key, the
``<untagged>`` bucket and the ``profiler.start``/``profiler.end`` events
are the JAX package's, so each package's ``validate_profile`` and
``merge_profile_files`` read the other's files.

A daemon timer thread walks ``sys._current_frames()`` at
``TPUSNAP_PROFILE_HZ`` (default 99) and counts collapsed stacks per
``(phase, state)``:

- **phase**: the sampled thread's attribution from
  ``phase_stats.thread_phases()``, the innermost ``timed()`` block or
  ``tagged()`` scope on it, else its op-driver tag (``<kind>_drive``).
  Work no phase covers lands in ``<untagged>``; a small untagged share is
  the health signal.
- **state**: ``on`` or ``off`` CPU, from the thread's CPU-time delta since
  the previous tick (its per-thread CPU clock, see :func:`_thread_cpu_times`):
  a thread that ran for at least half the tick interval was on-CPU.
  Without such clocks every sample is ``off``.

The health monitor (``telemetry/monitor.py``) begins and ends one profile
per monitored operation, written into ``TPUSNAP_PROFILE``, and puts a
short burst (:func:`sample_burst`) into each stall bundle.  The profiler
observes the copy-engine work (``d2h``, ``h2d_dispatch``, ``h2d_land``)
only through the host threads that wait on it; it launches nothing on the
device.  Its own cost is estimated by parts: the isolated cost of one tick
times the ticks taken (:func:`calibrated_overhead_s`).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import socket
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import knobs, phase_stats
from ..event import Event
from ..event_handlers import log_event

logger = logging.getLogger(__name__)

PROFILE_FILE_SUFFIX = ".profile.json"
COLLAPSED_FILE_SUFFIX = ".profile.collapsed"
PROFILE_SCHEMA = "tpusnap-profile-v1"
_SPEEDSCOPE_SCHEMA = "https://www.speedscope.app/file-format-schema.json"
UNTAGGED = "<untagged>"
# Stack frames deeper than this collapse into their top: profile stacks
# must stay bounded (a runaway recursion is a bug report, not a 10 MB
# profile line).
_MAX_STACK_DEPTH = 48
# A thread that accrued at least this share of the tick interval in CPU
# time was running (on-CPU).  The delta covers the interval before the
# tick while the stack is the one at the tick, and where the kernel counts
# CPU time in whole scheduler ticks (chip_smoke.py prints the step) a thread
# that keeps waking from a short wait, as one waiting for the GIL does, can
# show most of an interval: such samples are noise of that accounting.
_ONCPU_SHARE = 0.5

# Linux's per-thread CPU clock (MAKE_THREAD_CPUCLOCK(tid, CPUCLOCK_SCHED) in
# the kernel's include/linux/posix-timers.h): the id pthread_getcpuclockid
# returns, computed from the native thread id, so a thread that has exited
# gives EINVAL rather than a dangling pthread handle.
_PER_THREAD_CPUCLOCK = 4
_CPUCLOCK_SCHED = 2
_THREAD_CPU_CLOCKS = sys.platform == "linux" and hasattr(time, "clock_gettime")


# Process-lifetime count of sampling ticks taken (all Sampler instances):
# the multiplier of the calibrated estimate-by-parts overhead proof.
_TICKS_LOCK = threading.Lock()
_TICKS_SAMPLED = 0


def _count_ticks(n: int) -> None:
    global _TICKS_SAMPLED
    with _TICKS_LOCK:
        _TICKS_SAMPLED += n


def ticks_sampled() -> int:
    """Sampling ticks taken by this process so far."""
    return _TICKS_SAMPLED


def enabled() -> bool:
    """Whether per-op profiling is configured (dir set AND hz > 0)."""
    return knobs.get_profile_dir() is not None and knobs.get_profile_hz() > 0


# ------------------------------------------------------------- sampling


def _thread_cpu_times() -> Dict[int, float]:
    """Cumulative CPU seconds (user + system) per native thread id of this
    process's Python threads, the only threads the sampler classifies.

    Each is one ``clock_gettime`` of the thread's CPU clock: nanosecond
    resolution, and the GIL held throughout.  The JAX package reads
    ``/proc/self/task/<tid>/stat`` for every native thread instead (jiffy
    resolution, the GIL dropped and retaken at each file), which on a
    loaded host, or beside a CUDA runtime's and a native pool's threads,
    stretches a tick far past its interval.  Empty where the clocks are
    missing: the sampler then tags phases but marks every sample ``off``."""
    out: Dict[int, float] = {}
    if not _THREAD_CPU_CLOCKS:
        return out
    for t in threading.enumerate():
        tid = t.native_id
        if tid is None:
            continue
        try:
            out[tid] = time.clock_gettime(((~tid) << 3) | _PER_THREAD_CPUCLOCK | _CPUCLOCK_SCHED)
        except OSError:
            continue  # the thread exited since enumerate()
    return out


def _frame_label(frame: Any) -> str:
    code = frame.f_code
    base = os.path.basename(code.co_filename)
    mod = base[:-3] if base.endswith(".py") else base
    return f"{mod}.{code.co_name}"


def _collapse_stack(frame: Any) -> str:
    """Root-first semicolon-joined frame labels (flamegraph order)."""
    parts: List[str] = []
    while frame is not None and len(parts) < _MAX_STACK_DEPTH:
        parts.append(_frame_label(frame))
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts)


class Sampler:
    """The statistical sampler: one daemon timer thread walking every
    Python thread's stack at ``hz``, accumulating collapsed stacks per
    (phase, on/off-CPU state).  start()/stop() bound the collection;
    ``snapshot_state()`` supports per-op delta accounting when several
    monitored ops share one sampler."""

    def __init__(self, hz: float) -> None:
        self.hz = float(hz)
        self.interval_s = 1.0 / self.hz if self.hz > 0 else 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._begin_mono = time.monotonic()
        # (phase, state) -> {collapsed_stack: sample_count}
        self._stacks: Dict[Tuple[str, str], Dict[str, int]] = {}
        self.ticks = 0
        self.samples_total = 0
        self.oncpu_samples = 0
        self.untagged_oncpu = 0

    # -- core tick ----------------------------------------------------

    def _sample_once(
        self, elapsed_s: float, prev_cpu: Dict[int, float]
    ) -> Dict[int, float]:
        """Take one sample of every thread; returns the new per-thread
        CPU-times map (the caller threads it through ticks)."""
        cpu = _thread_cpu_times()
        native: Dict[int, int] = {}
        for t in threading.enumerate():
            nid = getattr(t, "native_id", None)
            if t.ident is not None and nid is not None:
                native[t.ident] = nid
        phases = phase_stats.thread_phases()
        self_ident = threading.get_ident()
        frames = sys._current_frames()
        try:
            with self._lock:
                self.ticks += 1
                for ident, frame in frames.items():
                    if ident == self_ident:
                        continue  # the sampler never profiles itself
                    nid = native.get(ident)
                    on = False
                    if nid is not None and elapsed_s > 0:
                        delta = cpu.get(nid, 0.0) - prev_cpu.get(nid, 0.0)
                        on = (
                            nid in prev_cpu
                            and delta >= _ONCPU_SHARE * elapsed_s
                        )
                    phase = phases.get(ident, UNTAGGED)
                    state = "on" if on else "off"
                    bucket = self._stacks.setdefault((phase, state), {})
                    stack = _collapse_stack(frame)
                    bucket[stack] = bucket.get(stack, 0) + 1
                    self.samples_total += 1
                    if on:
                        self.oncpu_samples += 1
                        if phase == UNTAGGED:
                            self.untagged_oncpu += 1
        finally:
            del frames  # frame objects pin every thread's locals
        _count_ticks(1)
        return cpu

    def _run(self) -> None:
        prev_cpu = _thread_cpu_times()
        prev_t = time.monotonic()
        while not self._stop.wait(self.interval_s):
            now = time.monotonic()
            try:
                prev_cpu = self._sample_once(now - prev_t, prev_cpu)
            except Exception:
                # Telemetry must never break the pipeline; a single torn
                # tick (thread exiting mid-walk) just drops one sample.
                logger.debug("profiler tick failed", exc_info=True)
            prev_t = now

    # -- lifecycle ----------------------------------------------------

    def start(self) -> None:
        self._begin_mono = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="tpusnap-torch-profiler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def duration_s(self) -> float:
        return time.monotonic() - self._begin_mono

    def snapshot_state(self) -> Dict[str, Any]:
        """Deep-copied counters for delta accounting across nested ops."""
        with self._lock:
            return {
                "stacks": {
                    key: dict(bucket) for key, bucket in self._stacks.items()
                },
                "ticks": self.ticks,
                "samples_total": self.samples_total,
                "oncpu_samples": self.oncpu_samples,
                "untagged_oncpu": self.untagged_oncpu,
                "mono": time.monotonic(),
            }


def _subtract_state(
    now: Dict[str, Any], before: Dict[str, Any]
) -> Dict[str, Any]:
    stacks: Dict[Tuple[str, str], Dict[str, int]] = {}
    for key, bucket in now["stacks"].items():
        prev = before["stacks"].get(key, {})
        out = {
            stack: n - prev.get(stack, 0)
            for stack, n in bucket.items()
            if n - prev.get(stack, 0) > 0
        }
        if out:
            stacks[key] = out
    return {
        "stacks": stacks,
        "ticks": now["ticks"] - before["ticks"],
        "samples_total": now["samples_total"] - before["samples_total"],
        "oncpu_samples": now["oncpu_samples"] - before["oncpu_samples"],
        "untagged_oncpu": now["untagged_oncpu"] - before["untagged_oncpu"],
        "duration_s": max(0.0, now["mono"] - before["mono"]),
    }


# ----------------------------------------------------------- calibration

_CAL_LOCK = threading.Lock()
_CAL_PER_TICK_S: Optional[float] = None


def calibrated_overhead_s(samples: int = 50) -> Dict[str, Any]:
    """Isolated per-tick sampling cost x ticks sampled this process —
    the profiler's <1%-of-op-wall overhead proof, same estimate-by-parts
    shape as ``blackbox.calibrated_overhead_s``."""
    ticks = ticks_sampled()  # snapshot first: probe ticks are not workload
    probe = Sampler(hz=knobs.get_profile_hz() or 99.0)
    prev = _thread_cpu_times()
    t0 = time.perf_counter()
    for _ in range(max(1, samples)):
        prev = probe._sample_once(0.01, prev)
    per_tick = (time.perf_counter() - t0) / max(1, samples)
    global _CAL_PER_TICK_S
    with _CAL_LOCK:
        _CAL_PER_TICK_S = per_tick
    return {
        "per_tick_s": per_tick,
        "ticks": ticks,
        "estimated_s": per_tick * ticks,
    }


def _cached_per_tick_s() -> float:
    """Lazily-calibrated per-tick cost (one cheap calibration per
    process) for the per-profile overhead estimate."""
    with _CAL_LOCK:
        cached = _CAL_PER_TICK_S
    if cached is not None:
        return cached
    return calibrated_overhead_s(samples=20)["per_tick_s"]


# ------------------------------------------------------- profile documents


def _meta_from_state(
    kind: str,
    op_id: str,
    rank: int,
    hz: float,
    state: Dict[str, Any],
    success: bool,
) -> Dict[str, Any]:
    """The tpusnap profile schema (the document's ``tpusnap`` object)."""
    per_tick = _cached_per_tick_s()
    stacks_json: Dict[str, Dict[str, Dict[str, int]]] = {}
    for (phase, st), bucket in sorted(state["stacks"].items()):
        stacks_json.setdefault(phase, {})[st] = dict(
            sorted(bucket.items(), key=lambda kv: -kv[1])
        )
    return {
        "schema": PROFILE_SCHEMA,
        "op": op_id,
        "kind": kind,
        "rank": rank,
        "hz": hz,
        "weight_s": 1.0 / hz if hz > 0 else 0.0,
        "duration_s": round(state.get("duration_s", 0.0), 6),
        "ticks": state["ticks"],
        "samples_total": state["samples_total"],
        "oncpu_samples": state["oncpu_samples"],
        "untagged_oncpu": state["untagged_oncpu"],
        "success": success,
        "host": socket.gethostname(),
        "stacks": stacks_json,
        "calibration": {
            "per_tick_s": per_tick,
            "ticks": state["ticks"],
            "estimated_s": round(per_tick * state["ticks"], 6),
        },
    }


def build_document(meta: Dict[str, Any]) -> Dict[str, Any]:
    """Wrap a tpusnap profile meta in a speedscope-loadable document:
    one sampled profile per (phase, state), shared frame table, the full
    meta embedded under ``tpusnap`` (speedscope ignores unknown keys)."""
    frames: List[Dict[str, str]] = []
    index: Dict[str, int] = {}
    profiles: List[Dict[str, Any]] = []
    weight = float(meta.get("weight_s") or 0.0)
    for phase in sorted(meta.get("stacks", {})):
        for st in sorted(meta["stacks"][phase]):
            bucket = meta["stacks"][phase][st]
            samples: List[List[int]] = []
            weights: List[float] = []
            for stack, n in sorted(bucket.items()):
                idxs: List[int] = []
                for label in stack.split(";"):
                    if label not in index:
                        index[label] = len(frames)
                        frames.append({"name": label})
                    idxs.append(index[label])
                samples.append(idxs)
                weights.append(round(n * weight, 6))
            profiles.append(
                {
                    "type": "sampled",
                    "name": f"{meta.get('kind')} rank{meta.get('rank')} "
                    f"{phase}/{st}cpu",
                    "unit": "seconds",
                    "startValue": 0,
                    "endValue": round(sum(weights), 6),
                    "samples": samples,
                    "weights": weights,
                }
            )
    return {
        "$schema": _SPEEDSCOPE_SCHEMA,
        "name": f"{meta.get('kind')}-{str(meta.get('op'))[:8]}"
        f"-rank{meta.get('rank')}",
        "exporter": "tpusnap-profiler",
        "shared": {"frames": frames},
        "profiles": profiles,
        "tpusnap": meta,
    }


def collapsed_lines(meta: Dict[str, Any]) -> List[str]:
    """Flamegraph.pl-style folded stacks, phase and state as synthetic
    root frames, hottest first."""
    rows: List[Tuple[int, str]] = []
    for phase, states in meta.get("stacks", {}).items():
        for st, bucket in states.items():
            for stack, n in bucket.items():
                rows.append((n, f"{phase};{st}cpu;{stack} {n}"))
    rows.sort(key=lambda r: (-r[0], r[1]))
    return [line for _, line in rows]


def write_profile_files(
    meta: Dict[str, Any], profile_dir: str
) -> Optional[str]:
    """Write the per-op profile JSON (+ collapsed text) atomically;
    returns the JSON path (None on write failure — best-effort
    diagnostics, like trace files)."""
    fname = (
        f"{meta['kind']}-{str(meta['op'])[:8]}-rank{meta['rank']}"
        f"{PROFILE_FILE_SUFFIX}"
    )
    path = os.path.join(profile_dir, fname)
    try:
        os.makedirs(profile_dir, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(build_document(meta), f)
        os.replace(tmp, path)  # tpusnap-lint: disable=durability-flow
        collapsed = path[: -len(PROFILE_FILE_SUFFIX)] + COLLAPSED_FILE_SUFFIX
        tmp = f"{collapsed}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write("\n".join(collapsed_lines(meta)) + "\n")
        os.replace(tmp, collapsed)  # tpusnap-lint: disable=durability-flow
        return path
    except OSError:
        logger.warning("failed to write profile %s", path, exc_info=True)
        return None


# ------------------------------------------------------------ op plumbing


class _ProfileOp:
    """One monitored operation's slice of the shared sampler."""

    def __init__(
        self,
        kind: str,
        op_id: str,
        rank: int,
        profile_dir: str,
        begin_state: Dict[str, Any],
    ) -> None:
        self.kind = kind
        self.op_id = op_id
        self.rank = rank
        self.profile_dir = profile_dir
        self.begin_state = begin_state


_OP_LOCK = threading.Lock()
_SAMPLER: Optional[Sampler] = None
_OPS: List[_ProfileOp] = []


def begin_op(kind: str, op_id: str, rank: int) -> Optional[_ProfileOp]:
    """Start profiling one operation.  Returns None (one env lookup)
    when ``TPUSNAP_PROFILE`` is unset or Hz is 0.  Nested/concurrent ops
    share one sampler (refcounted); each op's profile is the delta of
    the shared counters over its lifetime."""
    profile_dir = knobs.get_profile_dir()
    hz = knobs.get_profile_hz()
    if profile_dir is None or hz <= 0:
        return None
    global _SAMPLER
    try:
        with _OP_LOCK:
            if _SAMPLER is None:
                sampler = Sampler(hz)
                sampler.start()
                # Published once started: a start that raised leaves no
                # sampler behind for the next op to share.
                _SAMPLER = sampler
            op = _ProfileOp(
                kind, op_id, rank, profile_dir, _SAMPLER.snapshot_state()
            )
            _OPS.append(op)
    except Exception:
        logger.warning("profiler start failed", exc_info=True)
        return None
    log_event(
        Event(
            name="profiler.start",
            metadata={
                "action": kind,
                "unique_id": op_id,
                "rank": rank,
                "hz": hz,
            },
        )
    )
    return op


def end_op(
    op: Optional[_ProfileOp], success: bool = True
) -> Optional[str]:
    """Stop profiling one operation and write its profile files; stops
    the shared sampler when the last op ends.  Returns the profile JSON
    path (None when profiling was off or the write failed)."""
    if op is None:
        return None
    global _SAMPLER
    sampler: Optional[Sampler] = None
    last = False
    try:
        with _OP_LOCK:
            if op not in _OPS:
                return None  # already ended (error paths double-end)
            _OPS.remove(op)
            sampler = _SAMPLER
            last = not _OPS
            if last:
                _SAMPLER = None
        if sampler is None:
            return None
        if last:
            sampler.stop()  # outside the lock: join must not block begin_op
        end_state = sampler.snapshot_state()
        state = _subtract_state(end_state, op.begin_state)
        meta = _meta_from_state(
            op.kind, op.op_id, op.rank, sampler.hz, state, success
        )
        path = write_profile_files(meta, op.profile_dir)
    except Exception:
        logger.warning("profiler stop failed", exc_info=True)
        return None
    log_event(
        Event(
            name="profiler.end",
            metadata={
                "action": op.kind,
                "unique_id": op.op_id,
                "rank": op.rank,
                "samples": meta["samples_total"],
                "oncpu_samples": meta["oncpu_samples"],
                "untagged_oncpu": meta["untagged_oncpu"],
                "path": path,
            },
        )
    )
    return path


def sample_burst(
    duration_s: float, hz: Optional[float] = None
) -> Dict[str, Any]:
    """Sample every thread inline (on the CALLING thread) for
    ``duration_s`` and return a profile meta — the stall watchdog's
    "what is everything doing right now" evidence, phase-tagged where
    faulthandler's one-shot dump is not."""
    hz = hz or knobs.get_profile_hz() or 99.0
    sampler = Sampler(hz)
    begin = time.monotonic()
    prev_cpu = _thread_cpu_times()
    prev_t = begin
    deadline = begin + max(0.05, duration_s)
    while True:
        time.sleep(sampler.interval_s)
        now = time.monotonic()
        prev_cpu = sampler._sample_once(now - prev_t, prev_cpu)
        prev_t = now
        if now >= deadline:
            break
    state = sampler.snapshot_state()
    state["duration_s"] = time.monotonic() - begin
    return _meta_from_state("burst", "burst", 0, hz, state, True)


# ---------------------------------------------------------------- tooling


def validate_profile(obj: Any) -> List[str]:
    """Structural validation of a profile document of either package.
    Returns a list of problems; empty means valid."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    shared = obj.get("shared")
    if not isinstance(shared, dict) or not isinstance(
        shared.get("frames"), list
    ):
        problems.append("missing shared.frames array")
        n_frames = 0
    else:
        n_frames = len(shared["frames"])
        for i, fr in enumerate(shared["frames"]):
            if not isinstance(fr, dict) or not isinstance(
                fr.get("name"), str
            ):
                problems.append(f"shared.frames[{i}]: missing string name")
    profiles = obj.get("profiles")
    if not isinstance(profiles, list):
        problems.append("missing profiles array")
        profiles = []
    for i, prof in enumerate(profiles):
        where = f"profiles[{i}]"
        if not isinstance(prof, dict):
            problems.append(f"{where}: not an object")
            continue
        if prof.get("type") != "sampled":
            problems.append(f"{where}: type must be 'sampled'")
        samples = prof.get("samples")
        weights = prof.get("weights")
        if not isinstance(samples, list) or not isinstance(weights, list):
            problems.append(f"{where}: needs samples + weights arrays")
            continue
        if len(samples) != len(weights):
            problems.append(f"{where}: samples/weights length mismatch")
        for stack in samples:
            if not isinstance(stack, list) or any(
                not isinstance(ix, int) or ix < 0 or ix >= n_frames
                for ix in stack
            ):
                problems.append(f"{where}: sample frame index out of range")
                break
    meta = obj.get("tpusnap")
    if not isinstance(meta, dict):
        return problems + ["missing tpusnap metadata object"]
    if meta.get("schema") != PROFILE_SCHEMA:
        problems.append(
            f"tpusnap.schema must be {PROFILE_SCHEMA!r}, "
            f"got {meta.get('schema')!r}"
        )
    if not isinstance(meta.get("kind"), str):
        problems.append("tpusnap.kind must be a string")
    if not isinstance(meta.get("rank"), int):
        problems.append("tpusnap.rank must be an int")
    if not isinstance(meta.get("hz"), (int, float)) or meta.get("hz", 0) <= 0:
        problems.append("tpusnap.hz must be a positive number")
    stacks = meta.get("stacks")
    if not isinstance(stacks, dict):
        problems.append("tpusnap.stacks must be an object")
    else:
        for phase, states in stacks.items():
            if not isinstance(states, dict):
                problems.append(f"tpusnap.stacks[{phase!r}]: not an object")
                continue
            for st, bucket in states.items():
                if st not in ("on", "off"):
                    problems.append(
                        f"tpusnap.stacks[{phase!r}]: unknown state {st!r}"
                    )
                if not isinstance(bucket, dict) or any(
                    not isinstance(n, int) or n <= 0
                    for n in bucket.values()
                ):
                    problems.append(
                        f"tpusnap.stacks[{phase!r}][{st!r}]: counts must "
                        "be positive ints"
                    )
    for field in ("samples_total", "oncpu_samples", "untagged_oncpu"):
        if not isinstance(meta.get(field), int):
            problems.append(f"tpusnap.{field} must be an int")
    return problems


def load_profile_dir(profile_dir: str) -> List[Dict[str, Any]]:
    """Load and schema-validate every ``*.profile.json`` under
    ``profile_dir``.  Raises ValueError on the first invalid file —
    garbage must never produce a confident-looking report."""
    paths = sorted(glob.glob(os.path.join(profile_dir, f"*{PROFILE_FILE_SUFFIX}")))
    docs: List[Dict[str, Any]] = []
    for path in paths:
        docs.append(load_profile_file(path))
    return docs


def load_profile_file(path: str) -> Dict[str, Any]:
    """Load + validate one profile document (ValueError on garbage)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: unreadable profile file: {e}") from None
    problems = validate_profile(doc)
    if problems:
        raise ValueError(f"{path}: invalid profile: {problems[:3]}")
    doc["_file"] = os.path.basename(path)
    return doc


def merge_metas(metas: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-rank (or per-op) profile metas into one: stack counts
    and sample counters sum; duration takes the max (ranks overlap)."""
    if not metas:
        raise ValueError("no profiles to merge")
    base = metas[0]
    stacks: Dict[str, Dict[str, Dict[str, int]]] = {}
    merged = {
        "schema": PROFILE_SCHEMA,
        "op": base.get("op"),
        "kind": base.get("kind"),
        "rank": -1,  # merged across ranks; per-rank identity in merged_from
        "hz": base.get("hz"),
        "weight_s": base.get("weight_s"),
        "duration_s": 0.0,
        "ticks": 0,
        "samples_total": 0,
        "oncpu_samples": 0,
        "untagged_oncpu": 0,
        "success": all(m.get("success", True) for m in metas),
        "stacks": stacks,
        "merged_from": [
            {
                "kind": m.get("kind"),
                "op": str(m.get("op"))[:8],
                "rank": m.get("rank"),
                "host": m.get("host"),
            }
            for m in metas
        ],
        "calibration": {
            "per_tick_s": base.get("calibration", {}).get("per_tick_s"),
            "ticks": sum(m.get("ticks", 0) for m in metas),
            "estimated_s": round(
                sum(
                    float(m.get("calibration", {}).get("estimated_s") or 0.0)
                    for m in metas
                ),
                6,
            ),
        },
    }
    for m in metas:
        merged["duration_s"] = max(
            merged["duration_s"], float(m.get("duration_s") or 0.0)
        )
        for field in (
            "ticks",
            "samples_total",
            "oncpu_samples",
            "untagged_oncpu",
        ):
            merged[field] += int(m.get(field, 0))
        for phase, states in (m.get("stacks") or {}).items():
            for st, bucket in states.items():
                out = stacks.setdefault(phase, {}).setdefault(st, {})
                for stack, n in bucket.items():
                    out[stack] = out.get(stack, 0) + int(n)
    merged["duration_s"] = round(merged["duration_s"], 6)
    return merged


def merge_profile_files(paths: List[str]) -> Dict[str, Any]:
    """Merge per-rank/per-op profile files into one speedscope-loadable
    document (ValueError on any invalid input, like trace merging)."""
    metas = [load_profile_file(p)["tpusnap"] for p in paths]
    return build_document(merge_metas(metas))


# ----------------------------------------------------------- differential


def frame_self_cpu_s(meta: Dict[str, Any]) -> Dict[str, float]:
    """Per-frame self (leaf) on-CPU seconds across all phases."""
    weight = float(meta.get("weight_s") or 0.0)
    out: Dict[str, float] = {}
    for states in (meta.get("stacks") or {}).values():
        for stack, n in (states.get("on") or {}).items():
            leaf = stack.rsplit(";", 1)[-1]
            out[leaf] = out.get(leaf, 0.0) + n * weight
    return out


def _oncpu_s(meta: Dict[str, Any]) -> float:
    return float(meta.get("oncpu_samples", 0)) * float(
        meta.get("weight_s") or 0.0
    )


def diff_profiles(
    meta_a: Dict[str, Any], meta_b: Dict[str, Any], top: int = 10
) -> Dict[str, Any]:
    """Differential profile B - A: which frames gained or lost self CPU
    seconds between two runs (a direct-I/O mode against buffered writes,
    one read strategy against another)."""
    a = frame_self_cpu_s(meta_a)
    b = frame_self_cpu_s(meta_b)
    rows = []
    for frame in sorted(set(a) | set(b)):
        delta = b.get(frame, 0.0) - a.get(frame, 0.0)
        rows.append(
            {
                "frame": frame,
                "a_cpu_s": round(a.get(frame, 0.0), 4),
                "b_cpu_s": round(b.get(frame, 0.0), 4),
                "delta_s": round(delta, 4),
            }
        )
    rows.sort(key=lambda r: -abs(r["delta_s"]))
    return {
        "a": {
            "kind": meta_a.get("kind"),
            "oncpu_s": round(_oncpu_s(meta_a), 4),
            "samples": meta_a.get("samples_total", 0),
        },
        "b": {
            "kind": meta_b.get("kind"),
            "oncpu_s": round(_oncpu_s(meta_b), 4),
            "samples": meta_b.get("samples_total", 0),
        },
        "delta_oncpu_s": round(_oncpu_s(meta_b) - _oncpu_s(meta_a), 4),
        "top_regressed": [r for r in rows if r["delta_s"] > 0][:top],
        "top_improved": [r for r in rows if r["delta_s"] < 0][:top],
    }


def render_diff(diff: Dict[str, Any]) -> str:
    """Human-readable differential profile."""
    lines = [
        f"on-CPU: A {diff['a']['oncpu_s']:.2f}s "
        f"({diff['a']['samples']} samples) -> "
        f"B {diff['b']['oncpu_s']:.2f}s ({diff['b']['samples']} samples), "
        f"delta {diff['delta_oncpu_s']:+.2f}s"
    ]
    for label, rows in (
        ("regressed (B burns more)", diff["top_regressed"]),
        ("improved (B burns less)", diff["top_improved"]),
    ):
        lines.append(f"  top {label}:")
        if not rows:
            lines.append("    (none)")
        for r in rows:
            lines.append(
                f"    {r['delta_s']:>+8.3f}s  {r['frame']}  "
                f"({r['a_cpu_s']:.3f}s -> {r['b_cpu_s']:.3f}s)"
            )
    return "\n".join(lines)
