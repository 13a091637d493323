"""Span tracer with Chrome/Perfetto trace-event JSON export (the port's
copy of the reference's ``obs/tracer.py``).

``SpanTracer.span(name, attrs)`` returns a context manager; the span is
recorded at ``__exit__`` as one *complete* event (``ph: "X"`` with
``ts``/``dur`` in microseconds) — complete events are closed by
construction, so an exported trace can never contain a dangling begin.
Events land in per-thread append-only buffers (no locks on the hot
path; each buffer is registered once per thread under the tracer lock)
and every span carries a *lane*: the thread name by default — which is
exactly the pipeline's lane identity (``overlap-sample`` /
``overlap-resolve`` / ``overlap-admit``, ``diskstore-io_*``,
``*-replay-lane``) — or an explicit ``lane=`` attr (the consumer).
Export assigns one Perfetto track (tid) per lane with a
``thread_name`` metadata record, so ``chrome://tracing`` or
https://ui.perfetto.dev renders the run as a lane timeline.

All timestamps come from one monotonic clock (``time.perf_counter``),
so spans from different lanes line up on a shared axis.  They are host
time: around CUDA work, which runs asynchronously on a lane's stream, a
span measures the enqueue, not the device time, and telemetry never
synchronizes the device for a span's sake (that would change the
overlap it observes).
"""

from __future__ import annotations

import json
import threading
import time

#: Soft cap on buffered events per tracer; beyond it spans are dropped
#: (and counted) rather than growing without bound on long runs.
MAX_EVENTS = 1_000_000


class _Span:
    __slots__ = ("_tracer", "name", "attrs", "lane", "t0")

    def __init__(self, tracer: "SpanTracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.lane = attrs.pop("lane", None)
        self.attrs = attrs

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        lane = self.lane or threading.current_thread().name
        self._tracer._record(lane, self.name, self.t0,
                             time.perf_counter(), self.attrs)
        return False


class SpanTracer:
    def __init__(self, max_events: int = MAX_EVENTS):
        self._lock = threading.Lock()
        self._buffers: list[list] = []
        self._tls = threading.local()
        self._max_events = max_events
        self._n = 0          # approximate (racy) total, for the cap
        self.dropped = 0

    def span(self, name: str, attrs: dict) -> _Span:
        return _Span(self, name, attrs)

    def _record(self, lane, name, t0, t1, attrs) -> None:
        if self._n >= self._max_events:
            self.dropped += 1
            return
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = []
            self._tls.buf = buf
            with self._lock:
                self._buffers.append(buf)
        buf.append((lane, name, t0, t1, attrs))
        self._n += 1

    # -- export --------------------------------------------------------------
    def events(self) -> list[tuple]:
        """Every recorded ``(lane, name, t0, t1, attrs)``, globally
        sorted by start time."""
        with self._lock:
            merged = [ev for buf in self._buffers for ev in list(buf)]
        merged.sort(key=lambda ev: ev[2])
        return merged

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        events = self.events()
        t_origin = events[0][2] if events else 0.0
        tids: dict[str, int] = {}
        out = []
        for lane, name, t0, t1, attrs in events:
            tid = tids.get(lane)
            if tid is None:
                tid = tids[lane] = len(tids) + 1
                out.append({"ph": "M", "pid": 1, "tid": tid,
                            "name": "thread_name",
                            "args": {"name": lane}})
            ev = {"ph": "X", "pid": 1, "tid": tid, "name": name,
                  "ts": round((t0 - t_origin) * 1e6, 3),
                  "dur": round((t1 - t0) * 1e6, 3)}
            if attrs:
                ev["args"] = {k: v for k, v in attrs.items()
                              if v is not None}
            out.append(ev)
        meta = {"spans": len(events), "lanes": sorted(tids),
                "dropped": self.dropped}
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": meta}

    def export(self, path: str) -> dict:
        """Write the Perfetto trace to ``path``; returns the summary
        (span/lane counts) for logging."""
        trace = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace["otherData"]
