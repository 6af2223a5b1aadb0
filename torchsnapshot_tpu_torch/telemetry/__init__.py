"""Telemetry: sidecars, step history, traces, metrics, the health monitor,
the flight recorder, the sampling profiler, fleet telemetry and the
bottleneck analysis.

Counterpart of ``torchsnapshot_tpu/telemetry/`` for nine of its modules:

- :mod:`.sidecar` — a small ``telemetry/<op>.json`` next to
  ``.snapshot_metadata`` for each take, async take and restore
  (``TPUSNAP_SIDECAR=0`` opts out), in the JAX package's schema, so either
  package reads the other's;
- :mod:`.history` — ``<root>/telemetry/history.jsonl``, one line per
  committed manager save, with trailing-median regression detection;
- :mod:`.trace` — per-operation Chrome/Perfetto trace files under
  ``TPUSNAP_TRACE_DIR``, the peer daemon's server tracer and access log,
  and the W3C ``traceparent`` that joins a peer fetch to the daemon's span;
- :mod:`.metrics` — the ``TPUSNAP_METRICS`` registry in the Prometheus
  text format, fed by the instrumented sites and the event bridge;
- :mod:`.monitor` — live progress (``PendingSnapshot.progress()``, the
  ``tpusnap_progress_*`` gauges), the ``TPUSNAP_STALL_TIMEOUT_S`` stall
  watchdog with its diagnostic bundles, and the
  ``TPUSNAP_HEARTBEAT_FILE`` supervisor heartbeat;
- :mod:`.blackbox` — the crash-surviving flight recorder
  (``TPUSNAP_BLACKBOX``): a bounded per-process ring of records, in the
  JAX package's file format;
- :mod:`.profiler` — phase-attributed on- and off-CPU stack samples of
  each monitored operation under ``TPUSNAP_PROFILE``, and the stall
  bundle's sampled profile, in the JAX package's profile format;
- :mod:`.fleet` — the live fleet view: every monitored op publishes its
  progress, process totals and cache and peer splits into the
  ``TPUSNAP_FLEET_TELEMETRY`` spool, which both packages share, and
  ``collect``/``aggregate``/``render`` fold the spool into one view;
- :mod:`.analyze` — the bottleneck analysis over trace directories,
  profile directories and sidecars: per-phase walls and resource groups,
  the limiting resource and the straggler, the profile's CPU sinks, the
  commit barrier's blamed rank and the serving plane's per-peer report.

The postmortem is a later slice.
"""

from . import analyze, blackbox, fleet, history, metrics, monitor, profiler, sidecar, trace

__all__ = ["trace", "metrics", "sidecar", "monitor", "history", "blackbox", "profiler", "fleet", "analyze"]
