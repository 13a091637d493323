"""The process-wide telemetry session (the port's copy of the
reference's ``obs/session.py``).

Instrumentation points (loader lanes, store preads, the consumer step,
the oracle lane) call the module-level ``trace_span``/``tick`` hooks;
when no session is installed those are no-ops on a fast path — one
global read and a shared null context manager, no allocation beyond the
kwargs dict — so telemetry-off runs pay nothing measurable and, because
spans only *observe* the monotonic clock, telemetry-on runs never
perturb the bit-exact batch stream (loss trajectories are
repr-identical either way; CI-gated).

``build_pipeline`` opens one ``ObsSession`` per enabled pipeline and
``Pipeline.close()`` finalizes it: the trace JSON and the terminal
metrics snapshot are flushed exactly once, on the owner's close path.
"""

from __future__ import annotations

import threading

from repro_torch.obs.metrics import MetricsRegistry, MetricsWriter
from repro_torch.obs.tracer import SpanTracer


class _NullSpan:
    """Shared do-nothing context manager — the telemetry-off fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()

_lock = threading.Lock()
_session: "ObsSession | None" = None
_tracer: SpanTracer | None = None   # mirrored for the hot-path read


class ObsSession:
    """One telemetry scope: a metrics registry (+ optional JSONL sink)
    and a span tracer (+ optional Perfetto export path)."""

    def __init__(self, *, trace_path: str | None = None,
                 metrics_path: str | None = None,
                 metrics_interval_s: float = 5.0):
        self.trace_path = trace_path
        self.metrics_path = metrics_path
        self.registry = MetricsRegistry()
        self.tracer = SpanTracer() if trace_path else None
        self.writer = (MetricsWriter(self.registry, metrics_path,
                                     metrics_interval_s)
                       if metrics_path else None)
        self.trace_summary: dict | None = None
        self._closed = False

    def close(self) -> None:
        """Flush both sinks (idempotent) and uninstall if active."""
        if self._closed:
            return
        self._closed = True
        uninstall(self)
        if self.writer is not None:
            self.writer.close()
        if self.tracer is not None and self.trace_path:
            self.trace_summary = self.tracer.export(self.trace_path)


def install(session: ObsSession) -> ObsSession:
    """Make ``session`` the process-wide telemetry target (last wins)."""
    global _session, _tracer
    with _lock:
        _session = session
        _tracer = session.tracer
    return session


def uninstall(session: ObsSession) -> None:
    """Detach ``session`` if it is the active one (a later ``install``
    already superseded it otherwise)."""
    global _session, _tracer
    with _lock:
        if _session is session:
            _session = None
            _tracer = None


def active_session() -> ObsSession | None:
    return _session


def tracing() -> bool:
    """Cheap guard for instrumentation that wants to skip even the
    attrs-dict construction when spans are off."""
    return _tracer is not None


def trace_span(name: str, **attrs):
    """``with trace_span("resolve", batch=t): ...`` — records one closed
    span on the active tracer, or returns the shared null context when
    telemetry is off.  ``lane=`` overrides the span's track (defaults to
    the current thread's name, i.e. the pipeline lane)."""
    t = _tracer
    if t is None:
        return NULL_SPAN
    return t.span(name, attrs)


def metric_inc(name: str, value: float = 1) -> None:
    """Add to a counter on the active registry (no-op when off)."""
    s = _session
    if s is not None:
        s.registry.inc(name, value)


def metric_observe(name: str, value: float) -> None:
    """Record into a histogram on the active registry (no-op when off)."""
    s = _session
    if s is not None:
        s.registry.observe(name, value)


def tick() -> None:
    """Give the periodic JSONL sink a chance to snapshot.  Called from
    the consumer loop once per step; a no-op without an active writer."""
    s = _session
    if s is not None and s.writer is not None:
        s.writer.tick()
