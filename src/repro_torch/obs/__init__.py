"""Unified telemetry for the out-of-core data plane (the port's copy of
the reference's ``obs`` package: standard library only).

One substrate, three surfaces:

- ``MetricsRegistry`` — thread-safe counters/gauges/log-bucket
  histograms, lock-free hot path via per-thread shards, merged at
  snapshot time; periodic JSONL snapshots through ``MetricsWriter``.
- ``SpanTracer`` + ``trace_span`` — closed-by-construction spans on
  per-lane tracks, exported as Chrome/Perfetto trace-event JSON.
- ``names`` — the canonical metric-name table every emitter uses
  (``IOContext.KEYS``, the device-cache counter keys) plus the compat
  shim for pre-unification BENCH keys.

Enabled declaratively via the ``obs`` node on ``PipelineSpec``
(``--trace-out`` / ``--metrics-out``); disabled is a no-op fast path.
"""

from repro_torch.obs import names
from repro_torch.obs.metrics import (HIST_BUCKETS, HIST_EDGES,
                                     MetricsRegistry, MetricsWriter,
                                     bucket_index, idle_fraction,
                                     merge_snapshots)
from repro_torch.obs.session import (NULL_SPAN, ObsSession, active_session,
                                     install, metric_inc, metric_observe,
                                     tick, trace_span, tracing, uninstall)
from repro_torch.obs.summary import epoch_summary
from repro_torch.obs.tracer import SpanTracer

__all__ = [
    "HIST_BUCKETS", "HIST_EDGES", "MetricsRegistry", "MetricsWriter",
    "NULL_SPAN", "ObsSession", "SpanTracer", "active_session",
    "bucket_index", "epoch_summary", "idle_fraction", "install",
    "merge_snapshots", "metric_inc", "metric_observe", "names", "tick",
    "trace_span", "tracing", "uninstall",
]
