"""Telemetry: sidecars, step history, traces and metrics.

Counterpart of ``torchsnapshot_tpu/telemetry/`` for four of its modules:

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
  text format, fed by the instrumented sites and the event bridge.

The health monitor, the flight recorder, the profiler and fleet telemetry
are later slices.
"""
