"""Telemetry: per-snapshot sidecars and the manager's step history.

Counterpart of ``torchsnapshot_tpu/telemetry/`` for the two modules the
manager reads:

- :mod:`.sidecar` — a small ``telemetry/<op>.json`` next to
  ``.snapshot_metadata`` for each take, async take and restore
  (``TPUSNAP_SIDECAR=0`` opts out), in the JAX package's schema, so either
  package reads the other's;
- :mod:`.history` — ``<root>/telemetry/history.jsonl``, one line per
  committed manager save, with trailing-median regression detection.

Span tracing, the metrics registry and the health monitors are a later
slice.
"""
