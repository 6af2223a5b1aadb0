"""Metrics registry: counters/gauges/histograms + Prometheus exposition.

Counterpart of ``torchsnapshot_tpu/telemetry/metrics.py``: metric names,
types and label sets are the JAX package's, letter for letter, so that one
dashboard reads both packages.  A small in-process registry (no client
library) gated on ``TPUSNAP_METRICS=1``.  Two feeding paths:

- **Instrumented sites** call the ``record_*`` helpers below (scheduler
  gauges, storage bytes and retries, codec in/out bytes, the CAS, cache,
  peer, journal and store outcomes).  Each helper's first statement is the
  enabled check, so a disabled registry costs one env lookup per call.
- **The event bridge** (:func:`install_event_bridge`) subscribes to
  ``event_handlers.log_event``, so every ``Event`` site
  (take/async_take/restore/read_object start/end, staging downgrades)
  feeds operation counters, duration histograms and the open-operations
  gauge without per-site changes.  The open-ops gauge is the span-leak
  detector: a ``.start`` without its terminal ``.end`` leaves it non-zero.

Exposition is the Prometheus text format (:func:`render_prometheus`),
served by the peer daemon's ``GET /metrics`` and writable to a
textfile-collector path by whoever embeds the library.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

from .. import knobs

_DEFAULT_DURATION_BUCKETS = (
    0.01,
    0.05,
    0.25,
    1.0,
    5.0,
    15.0,
    60.0,
    300.0,
    1800.0,
)

_LOCK = threading.Lock()
_REGISTRY: "Dict[str, _Metric]" = {}

LabelKey = Tuple[Tuple[str, str], ...]


def enabled() -> bool:
    return knobs.metrics_enabled()


class _Child:
    __slots__ = ("value", "sum", "count", "buckets", "_buckets_le")

    def __init__(self, buckets_le: Optional[Tuple[float, ...]] = None) -> None:
        self.value = 0.0
        self.sum = 0.0
        self.count = 0
        self._buckets_le = buckets_le
        self.buckets = [0] * len(buckets_le) if buckets_le else None


class _Metric:
    """One metric family: a name, a type, and labeled children."""

    def __init__(
        self,
        name: str,
        mtype: str,
        help_text: str,
        buckets: Optional[Tuple[float, ...]] = None,
    ) -> None:
        self.name = name
        self.mtype = mtype
        self.help = help_text
        self._buckets = tuple(sorted(buckets)) if buckets else None
        self._children: Dict[LabelKey, _Child] = {}

    def _child(self, labels: Dict[str, str]) -> _Child:
        key: LabelKey = tuple(sorted((k, str(v)) for k, v in labels.items()))
        child = self._children.get(key)
        if child is None:
            with _LOCK:
                child = self._children.setdefault(key, _Child(self._buckets))
        return child

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        child = self._child(labels)
        with _LOCK:
            child.value += amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def set(self, value: float, **labels: str) -> None:
        child = self._child(labels)
        with _LOCK:
            child.value = value

    def observe(self, value: float, **labels: str) -> None:
        child = self._child(labels)
        with _LOCK:
            child.sum += value
            child.count += 1
            if child.buckets is not None:
                # Per-bucket counts stay NON-cumulative here; exposition
                # accumulates.  Incrementing every le >= value would make
                # render's running sum double-count.
                for i, le in enumerate(self._buckets):
                    if value <= le:
                        child.buckets[i] += 1
                        break

    def get(self, **labels: str) -> float:
        child = self._child(labels)
        return child.count if self.mtype == "histogram" else child.value


def _register(
    name: str,
    mtype: str,
    help_text: str,
    buckets: Optional[Tuple[float, ...]] = None,
) -> _Metric:
    with _LOCK:
        metric = _REGISTRY.get(name)
        if metric is None:
            metric = _Metric(name, mtype, help_text, buckets)
            _REGISTRY[name] = metric
    return metric


def counter(name: str, help_text: str = "") -> _Metric:
    return _register(name, "counter", help_text)


def gauge(name: str, help_text: str = "") -> _Metric:
    return _register(name, "gauge", help_text)


def histogram(
    name: str,
    help_text: str = "",
    buckets: Iterable[float] = _DEFAULT_DURATION_BUCKETS,
) -> _Metric:
    return _register(name, "histogram", help_text, tuple(buckets))


def reset() -> None:
    """Drop every registered metric (tests)."""
    with _LOCK:
        _REGISTRY.clear()


def dump_registry() -> List[Dict]:
    """JSON-serializable snapshot of every metric family with children
    (what a fleet publisher embeds, so that one scrape can merge every
    worker's registry).  Empty when nothing has been recorded."""
    with _LOCK:
        metrics = list(_REGISTRY.values())
    out: List[Dict] = []
    for m in metrics:
        with _LOCK:
            children = list(m._children.items())
        if not children:
            continue
        out.append(
            {
                "name": m.name,
                "type": m.mtype,
                "help": m.help,
                "buckets": list(m._buckets) if m._buckets else None,
                "children": [
                    {
                        "labels": dict(key),
                        "value": child.value,
                        "sum": child.sum,
                        "count": child.count,
                        "buckets": (
                            list(child.buckets)
                            if child.buckets is not None
                            else None
                        ),
                    }
                    for key, child in children
                ],
            }
        )
    return out


def _fmt_labels(key: LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def render_prometheus() -> str:
    """The registry in Prometheus text exposition format."""
    lines: List[str] = []
    with _LOCK:
        metrics = list(_REGISTRY.values())
    for m in metrics:
        if m.help:
            lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.mtype}")
        with _LOCK:
            children = list(m._children.items())
        for key, child in children:
            if m.mtype == "histogram":
                cumulative = 0
                for le, n in zip(m._buckets or (), child.buckets or ()):
                    cumulative += n
                    le_label = 'le="%s"' % le
                    lines.append(
                        f"{m.name}_bucket{_fmt_labels(key, le_label)}"
                        f" {cumulative}"
                    )
                inf_label = 'le="+Inf"'
                lines.append(
                    f"{m.name}_bucket{_fmt_labels(key, inf_label)}"
                    f" {child.count}"
                )
                lines.append(
                    f"{m.name}_sum{_fmt_labels(key)} {_fmt_value(child.sum)}"
                )
                lines.append(f"{m.name}_count{_fmt_labels(key)} {child.count}")
            else:
                lines.append(
                    f"{m.name}{_fmt_labels(key)} {_fmt_value(child.value)}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


# --------------------------------------------------- instrumentation helpers
#
# Call sites use these instead of touching the registry: the first statement
# is the enabled check, so with TPUSNAP_METRICS unset each call is one env
# lookup and a return.


def record_io_bytes(direction: str, nbytes: int) -> None:
    """Storage bytes moved through the scheduler (direction: written|read).
    Counted at the pipeline layer so every backend is covered once."""
    if not enabled():
        return
    counter(
        f"tpusnap_storage_bytes_{direction}_total",
        f"Bytes {direction} through storage plugins",
    ).inc(nbytes)


def record_entries(action: str, n: int) -> None:
    if not enabled():
        return
    counter(
        "tpusnap_manifest_entries_total",
        "Manifest entries processed per operation kind",
    ).inc(n, action=action)


def record_progress(
    verb: str,
    requests_total: int,
    requests_staged: int,
    requests_done: int,
    bytes_staged: int,
    bytes_done: int,
) -> None:
    """Live progress gauges for the in-flight pipeline (the monitor's
    machine-readable view, exported so a scrape mid-save answers "how far
    along is rank N" without logs).  Refreshed on the scheduler loop,
    same cadence as record_scheduler_state."""
    if not enabled():
        return
    gauge(
        "tpusnap_progress_requests_total",
        "Requests this operation will stage+write in total",
    ).set(requests_total, pipeline=verb)
    gauge(
        "tpusnap_progress_requests_staged",
        "Requests staged so far (bytes in host memory)",
    ).set(requests_staged, pipeline=verb)
    gauge(
        "tpusnap_progress_requests_written",
        "Requests fully written/consumed so far",
    ).set(requests_done, pipeline=verb)
    gauge(
        "tpusnap_progress_bytes_staged",
        "Payload bytes staged so far",
    ).set(bytes_staged, pipeline=verb)
    gauge(
        "tpusnap_progress_bytes_written",
        "Payload bytes written/consumed so far",
    ).set(bytes_done, pipeline=verb)


def record_scheduler_state(
    verb: str,
    pending: int,
    staging: int,
    inflight_io: int,
    budget_in_use: int,
) -> None:
    """Point-in-time pipeline gauges, refreshed on the scheduler's loop.
    Called once per loop turn, so everything non-trivial (the io-cap knob
    parse included) stays behind the enabled check."""
    if not enabled():
        return
    io_cap = knobs.get_max_per_rank_io_concurrency()
    gauge(
        "tpusnap_scheduler_queue_depth",
        "Requests waiting for budget admission",
    ).set(pending, pipeline=verb)
    gauge(
        "tpusnap_scheduler_staging_inflight",
        "Requests currently staging/reading",
    ).set(staging, pipeline=verb)
    gauge(
        "tpusnap_scheduler_io_inflight",
        "Storage I/O tasks currently in flight",
    ).set(inflight_io, pipeline=verb)
    gauge(
        "tpusnap_memory_budget_in_use_bytes",
        "Scheduler memory budget currently debited",
    ).set(budget_in_use, pipeline=verb)
    gauge(
        "tpusnap_worker_utilization",
        "In-flight storage I/O over the concurrency cap",
    ).set(inflight_io / io_cap if io_cap else 0.0, pipeline=verb)


def record_scheduler_idle(verb: str) -> None:
    """Zero the point-in-time pipeline gauges when an operation drains
    (success or error).  record_scheduler_state only runs inside the
    scheduler loop, so without this the pending/staging/inflight/budget/
    utilization gauges freeze at their last nonzero values forever after
    the op completes — a scrape an hour later would show a phantom
    in-flight save."""
    if not enabled():
        return
    record_scheduler_state(
        verb=verb, pending=0, staging=0, inflight_io=0, budget_in_use=0
    )


def record_retry(backend: str) -> None:
    """A storage-plugin transient-error retry (gcs/s3 backoff loops)."""
    if not enabled():
        return
    counter(
        "tpusnap_storage_retries_total",
        "Transient storage errors retried with backoff",
    ).inc(backend=backend)


def record_pipeline_retry(stage: str) -> None:
    """A bounded pipeline-level retry of a failed storage write: the
    scheduler requeueing a write request (``stage="write"``) or rank 0
    re-attempting the metadata commit (``stage="commit"``)."""
    if not enabled():
        return
    counter(
        "tpusnap_pipeline_retries_total",
        "Transient write failures retried at the pipeline layer",
    ).inc(stage=stage)


def record_restore_fallback(reason: str) -> None:
    """restore_latest skipped a committed-looking snapshot that failed to
    load (torn manifest, checksum mismatch, unreadable payload) and fell
    back to the previous step."""
    if not enabled():
        return
    counter(
        "tpusnap_restore_fallbacks_total",
        "Snapshots skipped by restore_latest's last-good fallback",
    ).inc(reason=reason)


def record_gc(kind: str) -> None:
    """A crash-consistency GC action: ``take_cleanup`` (a failed take tore
    down its partial dir) or ``orphan_removed`` (gc removed an uncommitted
    snapshot dir)."""
    if not enabled():
        return
    counter(
        "tpusnap_gc_actions_total",
        "Partial-snapshot cleanup and orphan-GC actions",
    ).inc(kind=kind)


def record_fault(op: str, kind: str) -> None:
    """A deliberately injected fault fired (faults.py) — lets a chaos run
    assert its schedule actually executed."""
    if not enabled():
        return
    counter(
        "tpusnap_faults_injected_total",
        "Faults fired by the deterministic injection wrapper",
    ).inc(op=op, kind=kind)


def record_store_usage(tenant: str, logical: int, exclusive: int) -> None:
    """One tenant's quota accounting against the shared chunk store
    (store.tenant_usage): logical bytes its manifests reference vs the
    physical bytes only it references (what deleting it would reclaim)."""
    if not enabled():
        return
    gauge(
        "tpusnap_store_logical_bytes",
        "Bytes a tenant's committed manifests reference in the shared store",
    ).set(logical, tenant=tenant)
    gauge(
        "tpusnap_store_physical_bytes",
        "Physical store bytes attributable exclusively to a tenant",
    ).set(exclusive, tenant=tenant)


def record_store_totals(logical: int, physical: int) -> None:
    """Store-wide totals: the logical/physical gap IS the cross-tenant
    dedup win."""
    if not enabled():
        return
    gauge(
        "tpusnap_store_logical_bytes",
        "Bytes a tenant's committed manifests reference in the shared store",
    ).set(logical, tenant="_total")
    gauge(
        "tpusnap_store_physical_bytes",
        "Physical store bytes attributable exclusively to a tenant",
    ).set(physical, tenant="_total")


def record_cas_dedup(hits: int, bytes_saved: int) -> None:
    """Content-addressed dedup outcome of one take (cas.py): payload
    writes satisfied by an existing chunk, and the logical bytes those
    hits did NOT write."""
    if not enabled() or not (hits or bytes_saved):
        return
    counter(
        "tpusnap_cas_dedup_hits_total",
        "Payload writes deduplicated against the content-addressed store",
    ).inc(hits)
    counter(
        "tpusnap_cas_dedup_bytes_saved_total",
        "Logical payload bytes not written thanks to CAS dedup",
    ).inc(bytes_saved)


def record_cdc(chunks: int, dedup_hits: int, bytes_saved: int) -> None:
    """Content-defined sub-chunking outcome of one take (cas.py +
    chunker.py): sub-slab chunks produced on FastCDC edges, and the
    per-chunk dedup they unlocked."""
    if not enabled() or not (chunks or dedup_hits):
        return
    counter(
        "tpusnap_cdc_chunks_total",
        "Content-defined sub-chunks produced by the CAS writer",
    ).inc(chunks)
    counter(
        "tpusnap_cdc_dedup_hits_total",
        "Sub-chunk writes deduplicated against the content-addressed store",
    ).inc(dedup_hits)
    counter(
        "tpusnap_cdc_bytes_saved_total",
        "Bytes not written thanks to content-defined sub-chunk dedup",
    ).inc(bytes_saved)


def record_cas_prestage(hits: int, bytes_skipped: int) -> None:
    """Streaming delta detection outcome of one take: leaves resolved to
    pure manifest references BEFORE the write pipeline (one hash, zero
    scheduler traffic)."""
    if not enabled() or not hits:
        return
    counter(
        "tpusnap_cas_prestage_hits_total",
        "Unchanged leaves skipped before the write pipeline",
    ).inc(hits)
    counter(
        "tpusnap_cas_prestage_bytes_total",
        "Bytes of unchanged leaves that never entered the write pipeline",
    ).inc(bytes_skipped)


def record_cache(
    hits: int, misses: int, hit_bytes: int, miss_bytes: int
) -> None:
    """One read operation's chunk-cache outcome (cache.py): how many
    payload reads were served from the shared host cache vs fetched from
    origin storage, and the byte split — the serving tier's headline."""
    if not enabled() or not (hits or misses):
        return
    if hits:
        counter(
            "tpusnap_cache_hits_total",
            "Payload reads served from the shared host chunk cache",
        ).inc(hits)
        counter(
            "tpusnap_cache_hit_bytes_total",
            "Payload bytes served from the shared host chunk cache",
        ).inc(hit_bytes)
    if misses:
        counter(
            "tpusnap_cache_misses_total",
            "Payload reads that missed the chunk cache (fetched from origin)",
        ).inc(misses)
        counter(
            "tpusnap_cache_miss_bytes_total",
            "Payload bytes fetched from origin on chunk-cache misses",
        ).inc(miss_bytes)


def record_peer(
    hits: int, misses: int, hit_bytes: int, miss_bytes: int
) -> None:
    """One read operation's peer-tier outcome (peer.py): chunks fetched
    from fleet peers vs fallen back to origin, and the byte split — the
    cross-host distribution headline (origin offload = peer_hit_bytes)."""
    if not enabled() or not (hits or misses):
        return
    if hits:
        counter(
            "tpusnap_peer_hits_total",
            "Chunks fetched from fleet peers instead of origin",
        ).inc(hits)
        counter(
            "tpusnap_peer_hit_bytes_total",
            "Bytes fetched from fleet peers instead of origin",
        ).inc(hit_bytes)
    if misses:
        counter(
            "tpusnap_peer_misses_total",
            "Digest chunk reads no peer could serve (origin fallback)",
        ).inc(misses)
        counter(
            "tpusnap_peer_miss_bytes_total",
            "Bytes read from origin after the peer tier came up empty",
        ).inc(miss_bytes)


def record_peer_reject(reason: str) -> None:
    """One peer response discarded before trust: digest mismatch,
    truncation, or an unverifiable body.  The peer is quarantined; the
    read proceeds from the next candidate or origin."""
    if not enabled():
        return
    counter(
        "tpusnap_peer_rejects_total",
        "Peer chunk responses rejected by digest verification",
    ).inc(reason=reason)


# Peer fetches are LAN round-trips, not object-store I/O: the default
# duration buckets start at 10 ms, which would flatten a healthy 1-5 ms
# fleet into one bucket.  Explicit sub-ms..10 s ladder instead.
_PEER_FETCH_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def record_peer_fetch_seconds(seconds: float) -> None:
    """One peer chunk fetch's wall (success or failure): the latency
    distribution behind the per-peer scoreboard EWMAs, scrapeable from the
    daemon's /metrics endpoint."""
    if not enabled():
        return
    histogram(
        "tpusnap_peer_fetch_seconds",
        "Wall seconds per peer chunk fetch attempt sequence",
        buckets=_PEER_FETCH_BUCKETS,
    ).observe(max(0.0, float(seconds)))


def record_peer_demoted() -> None:
    """A peer crossed the scoreboard's demotion threshold (latency EWMA
    past TPUSNAP_PEER_DEMOTE_FACTOR x fleet median, or error EWMA > 0.5)
    and moved to the back of the rendezvous order."""
    if not enabled():
        return
    counter(
        "tpusnap_peer_demotions_total",
        "Peers demoted to last-resort candidates by the serving scoreboard",
    ).inc()


def record_rollout_wave(wave: str) -> None:
    """One rollout wave transition (canary / verify / fleet) published by
    rollout_fleet's live progress."""
    if not enabled():
        return
    counter(
        "tpusnap_rollout_waves_total",
        "Rollout wave transitions (canary warm, canary verify, fleet fan-out)",
    ).inc(wave=wave)


def record_peerd_request(kind: str, status: int, nbytes: int = 0) -> None:
    """One request served by this host's peer daemon (peerd.py)."""
    if not enabled():
        return
    counter(
        "tpusnap_peerd_requests_total",
        "HTTP requests served by the peer chunk daemon",
    ).inc(kind=kind, status=str(status))
    if nbytes:
        counter(
            "tpusnap_peerd_bytes_total",
            "Chunk bytes served to peers by this host's daemon",
        ).inc(nbytes, kind=kind)


def record_cache_wait(seconds: float) -> None:
    """Wall one cold read spent parked on a sibling's in-flight populate
    (the cache's per-key single-flight lock, cache.py).  A fleet whose
    waits dwarf its misses is convoying on too few distinct keys."""
    if not enabled():
        return
    counter(
        "tpusnap_cache_wait_seconds_total",
        "Wall spent waiting on another process's in-flight cache populate",
    ).inc(max(0.0, float(seconds)))


def record_fleet_stale_peers(count: int) -> None:
    """Gauge of fleet-spool entries whose op looks dead (published mid-op,
    then silent past the stale bound) as of the collector's latest pass."""
    if not enabled():
        return
    gauge(
        "tpusnap_fleet_stale_peers",
        "Fleet-telemetry entries for in-flight ops whose publisher went "
        "silent past the stale bound (suspected-dead workers)",
    ).set(float(max(0, count)))


def record_telemetry_overhead(seconds: float) -> None:
    """Self-metering for the fleet telemetry plane (fleet.py): the wall
    each spool publish costs the op that performed it.  The observability
    layer's own bill, so "telemetry is slowing the fleet" is answerable
    from the telemetry itself."""
    if not enabled():
        return
    counter(
        "tpusnap_telemetry_overhead_seconds_total",
        "Wall spent publishing fleet telemetry spool entries",
    ).inc(max(0.0, float(seconds)))


def record_cache_evicted(entries: int, nbytes: int) -> None:
    """An LRU eviction pass reclaimed cache entries to fit the
    ``TPUSNAP_CACHE_MAX_BYTES`` bound."""
    if not enabled():
        return
    counter(
        "tpusnap_cache_evicted_bytes_total",
        "Chunk-cache bytes reclaimed by LRU eviction",
    ).inc(nbytes)
    counter(
        "tpusnap_cache_evicted_entries_total",
        "Chunk-cache entries removed by LRU eviction",
    ).inc(entries)


def record_journal_segment(delta_entries: int, delta_bytes: int) -> None:
    """One committed journal delta segment (journal.py): how many manifest
    entries changed and their logical payload bytes — the per-step append
    cost the journal mode exists to minimize."""
    if not enabled():
        return
    counter(
        "tpusnap_journal_segments_total",
        "Journal delta segments committed",
    ).inc()
    counter(
        "tpusnap_journal_delta_entries_total",
        "Manifest entries carried by committed journal segments",
    ).inc(max(0, int(delta_entries)))
    counter(
        "tpusnap_journal_appended_bytes_total",
        "Logical payload bytes appended by committed journal segments",
    ).inc(max(0, int(delta_bytes)))


def record_journal_compaction(folded_segments: int) -> None:
    """One background compaction: base + segments folded into a fresh full
    step (pure metadata — every payload already lives in the CAS)."""
    if not enabled():
        return
    counter(
        "tpusnap_journal_compactions_total",
        "Journal compactions (segments folded into a full step)",
    ).inc()
    counter(
        "tpusnap_journal_folded_segments_total",
        "Journal segments removed by compactions",
    ).inc(max(0, int(folded_segments)))


def record_journal_fallback(reason: str) -> None:
    """restore skipped a journal segment whose replay chain failed (missing
    base, corrupt prior segment, bad delta) and fell back to an older
    restore point."""
    if not enabled():
        return
    counter(
        "tpusnap_journal_fallbacks_total",
        "Journal segments skipped by restore's replay fallback",
    ).inc(reason=reason)


def record_native_degraded(reason: str) -> None:
    """The native data plane lost features (stale libtpusnap.so missing
    newer symbols, rebuild impossible): the affected fast paths fall back
    to Python.  One increment per process per reason."""
    if not enabled():
        return
    counter(
        "tpusnap_native_degraded_total",
        "Native data-plane degradations (stale library, missing symbols)",
    ).inc(reason=reason)


def record_codec(codec: str, uncompressed: int, compressed: int) -> None:
    """One framed payload's in/out byte counts; ratio derives at query
    time as uncompressed_total / compressed_total."""
    if not enabled():
        return
    counter(
        "tpusnap_codec_uncompressed_bytes_total",
        "Logical bytes entering the compression codec",
    ).inc(uncompressed, codec=codec)
    counter(
        "tpusnap_codec_compressed_bytes_total",
        "Stored frame bytes leaving the compression codec",
    ).inc(compressed, codec=codec)


def record_blackbox_record() -> None:
    """One record spilled to the flight-recorder ring (blackbox.py)."""
    if not enabled():
        return
    counter(
        "tpusnap_blackbox_records_total",
        "Records spilled to the crash-surviving flight-recorder ring",
    ).inc()


def record_blackbox_spill_error() -> None:
    """A flight-recorder spill failed (ring unopenable, pwrite error).
    The recorder swallows the exception — this counter is the evidence."""
    if not enabled():
        return
    counter(
        "tpusnap_blackbox_spill_errors_total",
        "Failed flight-recorder spills (the recorder never raises)",
    ).inc()


def record_postmortem_report(classification: str) -> None:
    """One postmortem analysis, by failure classification."""
    if not enabled():
        return
    counter(
        "tpusnap_postmortem_reports_total",
        "Postmortem analyses run, by failure classification",
    ).inc(classification=classification)


# ------------------------------------------------------------- event bridge

# The bridge's contract with the event stream, the JAX package's own: every
# event kind either package emits must be covered by one of these three
# sets, so a new event cannot bypass metrics without a word
# (tests/test_torch_metrics.py checks the port's emit sites).
#
# Operation-lifecycle families: any "<action>.start" / "<action>.end" pair
# feeds the open-ops gauge, the operations counter, and the duration/bytes
# series generically.
BRIDGED_EVENT_SUFFIXES = (".start", ".end")
# Events the bridge maps to a dedicated metric by exact name.
BRIDGED_EVENTS = frozenset(
    {
        "async_take.staging_downgrade",
        "async_take.device_staged",
        "watchdog.stall",
        "telemetry.regression",
    }
)
# Events whose metric is recorded directly at the emit site (a record_*
# helper next to the log_event call) — bridging them too would double-count.
DIRECT_METRIC_EVENTS = frozenset(
    {
        "scheduler.write_retry",  # record_pipeline_retry("write")
        "scheduler.read_retry",  # record_pipeline_retry("read")
        "fleet.peer_stale",  # record_fleet_stale_peers
        "restore_latest.fallback",  # record_restore_fallback
        "gc.orphan_removed",  # record_gc("orphan_removed")
        "gc.chunk_removed",  # record_gc("chunk_removed")
        "take.cleanup",  # record_gc("take_cleanup")
        "async_take.cleanup",  # record_gc("take_cleanup")
        "cas.dedup",  # record_cas_dedup
        "gc.segment_removed",  # record_gc("segment_removed")
        "journal.commit",  # record_journal_segment
        "journal.compaction",  # record_journal_compaction
        "journal.fallback",  # record_journal_fallback
        "native.degraded",  # record_native_degraded
        "cache.hit",  # record_cache
        "cache.miss",  # record_cache
        "cache.evict",  # record_cache_evicted
        "cache.wait",  # record_cache_wait
        "peer.hit",  # record_peer
        "peer.miss",  # record_peer
        "peer.reject",  # record_peer_reject
        "peer.demoted",  # record_peer_demoted
        "rollout.wave",  # record_rollout_wave
        "store.sweep",  # record_gc("chunk_condemned"/"chunk_restored"/...)
        "blackbox.spill_error",  # record_blackbox_spill_error
        "postmortem.report",  # record_postmortem_report
    }
)

_BRIDGE_LOCK = threading.Lock()
_BRIDGE_INSTALLED = False


def _bridge_handler(event) -> None:
    """Maps the existing Event stream onto metrics.  Registered via
    event_handlers.register_event_handler, so one raising handler (this
    one included) is isolated by log_event's per-handler try/except."""
    if not enabled():
        # Installed once, but honors the knob live: flipping
        # TPUSNAP_METRICS off mid-process stops recording immediately.
        return
    name = event.name
    md = event.metadata or {}
    counter("tpusnap_events_total", "Events seen on the log_event fan-out").inc(
        event=name
    )
    action = md.get("action") or name.rsplit(".", 1)[0]
    if name.endswith(".start"):
        gauge(
            "tpusnap_open_operations",
            "Operations started but not yet ended (a leaked span holds "
            "this above zero)",
        ).inc(action=action)
    elif name.endswith(".end"):
        gauge(
            "tpusnap_open_operations",
            "Operations started but not yet ended (a leaked span holds "
            "this above zero)",
        ).dec(action=action)
        outcome = "success" if md.get("is_success", True) else "error"
        counter(
            "tpusnap_operations_total", "Completed operations by outcome"
        ).inc(action=action, outcome=outcome)
        duration = md.get("duration_s")
        if isinstance(duration, (int, float)):
            histogram(
                "tpusnap_operation_duration_seconds",
                "End-to-end operation wall time",
            ).observe(float(duration), action=action)
        nbytes = md.get("bytes")
        if isinstance(nbytes, (int, float)) and nbytes:
            counter(
                "tpusnap_operation_bytes_total",
                "Payload bytes moved per completed operation",
            ).inc(float(nbytes), action=action)
    elif name == "async_take.staging_downgrade":
        counter(
            "tpusnap_staging_downgrades_total",
            "async_take staging-mode downgrades",
        ).inc(
            from_mode=md.get("from_mode", "?"), to_mode=md.get("to_mode", "?")
        )
    elif name == "async_take.device_staged":
        copy_bytes = md.get("copy_bytes")
        if isinstance(copy_bytes, (int, float)):
            counter(
                "tpusnap_device_staged_bytes_total",
                "Bytes made snapshot-stable by device-side staging",
            ).inc(float(copy_bytes), mode=md.get("mode", "?"))
    elif name == "watchdog.stall":
        counter(
            "tpusnap_stalls_total",
            "Stalls detected by the pipeline health watchdog",
        ).inc(action=md.get("action", "?"))
    elif name == "telemetry.regression":
        counter(
            "tpusnap_save_regressions_total",
            "Committed saves slower than the trailing-window "
            "regression threshold",
        ).inc(action=md.get("action", "?"))


def install_event_bridge() -> None:
    """Idempotently subscribe the bridge to the log_event fan-out."""
    global _BRIDGE_INSTALLED
    from ..event_handlers import register_event_handler

    with _BRIDGE_LOCK:
        if _BRIDGE_INSTALLED:
            return
        register_event_handler(_bridge_handler)
        _BRIDGE_INSTALLED = True


def uninstall_event_bridge() -> None:
    global _BRIDGE_INSTALLED
    from ..event_handlers import unregister_event_handler

    with _BRIDGE_LOCK:
        if not _BRIDGE_INSTALLED:
            return
        try:
            unregister_event_handler(_bridge_handler)
        except ValueError:
            pass
        _BRIDGE_INSTALLED = False


def maybe_install_bridge() -> None:
    """Install the bridge iff metrics are enabled — called at every
    operation entry point, so flipping TPUSNAP_METRICS on takes effect at
    the next take/restore with no explicit setup."""
    if enabled():
        install_event_bridge()
