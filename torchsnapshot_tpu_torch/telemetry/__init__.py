"""Telemetry: sidecars, step history, traces, metrics, the health monitor
and the flight recorder.

Counterpart of ``torchsnapshot_tpu/telemetry/`` for six of its modules:

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
  JAX package's file format.

The profiler, fleet telemetry, the analysis and the postmortem are later
slices.
"""

from . import blackbox, history, metrics, monitor, sidecar, trace

__all__ = ["trace", "metrics", "sidecar", "monitor", "history", "blackbox"]
