"""Thread-safe metrics registry with a lock-free hot path (the port's
copy of the reference's ``obs/metrics.py``).

Counters, gauges, and fixed-bucket log-scale histograms.  The hot path
(``inc``/``observe``) touches only a per-thread shard — a plain dict
owned by the calling thread, registered once per thread under the
registry lock — so producer lanes and pread-pool workers never contend.
``snapshot()`` merges every shard (and pulls any registered collectors)
into one flat ``{canonical_name: value}`` dict; ``merge_snapshots`` is
associative and commutative, so partial snapshots from different
registries/processes can be combined in any order (property-tested).
"""

from __future__ import annotations

import json
import math
import threading
import time

# -- shared idle-fraction helper (single copy; RunStats and
# PipelineStats both delegate here) ------------------------------------------


def idle_fraction(idle_s: float, busy_s: float) -> float:
    """Fraction of consumer wall time spent waiting on the data plane
    — the paper's Fig. 7 quantity.  Zero when nothing ran yet."""
    total = idle_s + busy_s
    return idle_s / total if total > 0 else 0.0


# -- histogram ---------------------------------------------------------------

# Fixed log2-scale bucket edges shared by every histogram: 64 buckets,
# the i-th holding values in [2**(i-20), 2**(i-19)), i.e. ~1 µs up to
# ~12 days when observing seconds, with one underflow bucket below
# 2**-20.  Fixed (not data-dependent) so bucket arrays from different
# shards, snapshots, or runs merge by plain element-wise addition.
HIST_SHIFT = 20
HIST_BUCKETS = 64
HIST_EDGES = tuple(2.0 ** (i - HIST_SHIFT) for i in range(HIST_BUCKETS - 1))


def bucket_index(value: float) -> int:
    """The fixed bucket a value lands in (underflow -> 0, overflow ->
    the last bucket).  Pure and stable across runs."""
    if value < HIST_EDGES[0]:
        return 0
    i = min(int(math.log2(value)) + HIST_SHIFT + 1, HIST_BUCKETS - 1)
    # guard the binade boundary: int(log2) can round either way there
    while i > 0 and value < HIST_EDGES[i - 1]:
        i -= 1
    while i < HIST_BUCKETS - 1 and value >= HIST_EDGES[i]:
        i += 1
    return i


class _Hist:
    """Per-shard histogram cell: bucket counts plus count/sum."""
    __slots__ = ("buckets", "count", "sum")

    def __init__(self):
        self.buckets = [0] * HIST_BUCKETS
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.buckets[bucket_index(value)] += 1
        self.count += 1
        self.sum += value

    def to_dict(self) -> dict:
        return {"buckets": list(self.buckets), "count": self.count,
                "sum": self.sum}


class MetricsRegistry:
    """Namespaced counters/gauges/histograms with per-thread shards.

    - ``inc(name, v)``: add to a counter (lock-free, per-thread shard).
    - ``observe(name, v)``: record into the fixed-bucket histogram.
    - ``gauge(name, v)``: set a last-write-wins gauge (registry-level,
      locked — gauges are rare and not hot).
    - ``register_collector(fn)``: ``fn() -> flat dict`` pulled at
      snapshot time; how the existing ``stats()`` surfaces (store I/O
      bill, cache tiers, oracle lane) are absorbed without moving their
      counters.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._shards: list[dict] = []
        self._tls = threading.local()
        self._gauges: dict[str, float] = {}
        self._collectors: list = []

    # -- hot path ------------------------------------------------------------
    def _shard(self) -> dict:
        shard = getattr(self._tls, "shard", None)
        if shard is None:
            shard = {}
            self._tls.shard = shard
            with self._lock:
                self._shards.append(shard)
        return shard

    def inc(self, name: str, value: float = 1) -> None:
        shard = self._shard()
        shard[name] = shard.get(name, 0) + value

    def observe(self, name: str, value: float) -> None:
        shard = self._shard()
        cell = shard.get(name)
        if not isinstance(cell, _Hist):
            cell = shard[name] = _Hist()
        cell.observe(value)

    # -- cold path -----------------------------------------------------------
    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def register_collector(self, fn) -> None:
        with self._lock:
            self._collectors.append(fn)

    def snapshot(self) -> dict:
        """Merge every shard + gauges + collector pulls into one flat
        dict.  Counters sum across shards; histogram cells merge
        element-wise; collectors and gauges are last-write-wins."""
        with self._lock:
            shards = [dict(s) for s in self._shards]
            gauges = dict(self._gauges)
            collectors = list(self._collectors)
        snap: dict = {}
        for shard in shards:
            part = {k: (v.to_dict() if isinstance(v, _Hist) else v)
                    for k, v in shard.items()}
            snap = merge_snapshots(snap, part)
        for fn in collectors:
            try:
                snap.update(fn())
            except Exception:  # a dead collector must not sink telemetry
                pass
        snap.update(gauges)
        return snap


def _is_hist(v) -> bool:
    return isinstance(v, dict) and "buckets" in v


def merge_snapshots(a: dict, b: dict) -> dict:
    """Combine two snapshot dicts: counters add, histogram cells add
    element-wise, anything non-numeric is last-write-wins.  Associative
    and commutative over counter/histogram entries (property-tested in
    ``tests/test_obs.py``), so shards/partials merge in any order."""
    out = dict(a)
    for k, v in b.items():
        cur = out.get(k)
        if cur is None:
            out[k] = v
        elif _is_hist(cur) and _is_hist(v):
            out[k] = {
                "buckets": [x + y for x, y in
                            zip(cur["buckets"], v["buckets"])],
                "count": cur["count"] + v["count"],
                "sum": cur["sum"] + v["sum"],
            }
        elif isinstance(cur, (int, float)) and isinstance(v, (int, float)):
            out[k] = cur + v
        else:
            out[k] = v
    return out


class MetricsWriter:
    """Periodic JSONL snapshot sink: one line per snapshot —
    ``{"t": <seconds since start>, "metrics": {...}}``.  ``tick()`` is
    cheap (one clock read) until the interval elapses."""

    def __init__(self, registry: MetricsRegistry, path: str,
                 interval_s: float = 5.0):
        self.registry = registry
        self.path = path
        self.interval_s = float(interval_s)
        self._t0 = time.perf_counter()
        self._last = self._t0
        self._f = open(path, "w")
        self._lock = threading.Lock()

    def tick(self) -> bool:
        now = time.perf_counter()
        if now - self._last < self.interval_s:
            return False
        self.write_snapshot(now)
        return True

    def write_snapshot(self, now: float | None = None) -> None:
        now = time.perf_counter() if now is None else now
        snap = self.registry.snapshot()
        with self._lock:
            if self._f.closed:
                return
            self._last = now
            self._f.write(json.dumps(
                {"t": round(now - self._t0, 6), "metrics": snap}) + "\n")
            self._f.flush()

    def close(self) -> None:
        self.write_snapshot()  # final snapshot is always on disk
        with self._lock:
            self._f.close()
