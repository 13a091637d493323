"""Canonical metric names for the out-of-core data plane (the port's
copy of the reference's ``obs/names.py``).

Every counter the data plane emits — the ``DiskStore`` I/O bill, the
two ``DeviceArrayCache`` tiers, the fault-injection books, the oracle
replay lane, the overlapped-pipeline lane supervisor and the consumer
idle split — is addressed here by exactly one dotted name, e.g.
``store.bytes_fetched`` or ``devcache.hit_rate``.  The emitters import
their key tuples from this module (``IOContext.KEYS`` is built from
``STORE_IO_KEYS + FAULT_KEYS``; the device tiers report
``DEVCACHE_KEYS``), so the flat dict keys seen in ``stats()`` trees and
BENCH rows *are* the canonical leaf names — drift between surfaces is a
single-source-of-truth violation rather than a latent rename.

``flatten_stats`` maps a loader ``stats()`` tree onto the canonical
flat namespace (the shape the metrics registry snapshots and BENCH rows
embed), and ``legacy_key`` is the compat shim: it answers which
pre-unification key an old BENCH comparison script would have used for
a canonical name, so historical BENCH JSONs stay comparable.
"""

from __future__ import annotations

# -- canonical leaf-key tuples (single source of truth for emitters) ---------

#: ``DiskStore`` per-context I/O bill (``IOContext``/``io_counters``).
STORE_IO_KEYS = ("requests", "block_fetches", "bytes_fetched", "hits",
                 "misses", "evictions")

#: Fault kinds, flat — ``nest_fault_counters`` folds them under
#: ``"faults"`` at trace-assembly time; canonically they live under
#: ``store.faults.*``.
FAULT_KEYS = ("retries", "io_errors", "short_reads", "corrupt_blocks",
              "timeouts")

#: ``DeviceArrayCache.counters()`` — both tiers (features, edge blocks).
DEVCACHE_KEYS = ("hits", "misses", "evictions", "preload_rows",
                 "bytes_uploaded")

#: ``OracleReplayer.stats()`` numeric keys.
ORACLE_KEYS = ("window", "windows_built", "batches_replayed", "errors",
               "timeouts")

#: Overlapped-pipeline supervisor counters (top level of loader stats).
PIPELINE_KEYS = ("prefetched", "lane_failures", "lane_stall_restarts",
                 "planner_warm_ranges")

#: Consumer-side training counters (RunStats / PipelineStats).
TRAIN_KEYS = ("steps", "idle_s", "busy_s", "steps_per_s", "idle_fraction")

#: In-storage-processing wire counters (``IspClient.counters`` /
#: ``RemoteGraphStore.isp_counters()``) — both endpoints count frame
#: bytes into the same names, plus the client's connection-health pair.
ISP_KEYS = ("requests", "bytes_tx", "bytes_rx", "disconnects",
            "reconnects")

#: Cache tiers whose subtree in a loader ``stats()`` dict carries
#: ``DEVCACHE_KEYS``-shaped counters.
TIERS = ("devcache", "edgecache")


def canonical(group: str, key: str) -> str:
    """The canonical dotted metric name for ``key`` within ``group``
    (``canonical("store", "hits") -> "store.hits"``; fault kinds are
    nested under ``store.faults`` regardless of the flat emitter key)."""
    if group == "store" and key in FAULT_KEYS:
        return f"store.faults.{key}"
    return f"{group}.{key}"


# Every canonical name the unified layer emits, grouped for the README
# table and for schema checks.  Derived ``*.hit_rate`` gauges are
# computed at snapshot time from the hit/miss counters.
CANONICAL_NAMES: dict[str, tuple[str, ...]] = {
    "store": tuple(canonical("store", k) for k in STORE_IO_KEYS)
             + ("store.hit_rate",),
    "store.faults": tuple(canonical("store", k) for k in FAULT_KEYS),
    "devcache": tuple(canonical("devcache", k) for k in DEVCACHE_KEYS)
                + ("devcache.hit_rate",),
    "edgecache": tuple(canonical("edgecache", k) for k in DEVCACHE_KEYS)
                 + ("edgecache.hit_rate",),
    "isp": tuple(canonical("isp", k) for k in ISP_KEYS),
    "oracle": tuple(canonical("oracle", k) for k in ORACLE_KEYS),
    "pipeline": tuple(canonical("pipeline", k) for k in PIPELINE_KEYS)
                + ("pipeline.degraded",),
    "train": tuple(canonical("train", k) for k in TRAIN_KEYS),
}

# -- compat shim -------------------------------------------------------------

# canonical name -> the key an old BENCH/stats consumer read.  Before
# unification the fault kinds sat *flat* inside the store block
# (``loader_stats["store"]["retries"]``) and trace assembly nested them
# under ``io["faults"]``; both spellings map onto ``store.faults.*``.
_LEGACY: dict[str, str] = {}
for _k in STORE_IO_KEYS:
    _LEGACY[f"store.{_k}"] = _k
for _k in FAULT_KEYS:
    _LEGACY[f"store.faults.{_k}"] = _k
for _t in TIERS:
    for _k in DEVCACHE_KEYS:
        _LEGACY[f"{_t}.{_k}"] = _k
for _k in ORACLE_KEYS:
    _LEGACY[f"oracle.{_k}"] = _k
for _k in PIPELINE_KEYS:
    _LEGACY[f"pipeline.{_k}"] = _k


def legacy_key(name: str) -> str | None:
    """The pre-unification flat key for a canonical metric name (the
    key inside its old ``stats()`` subtree), or ``None`` when the metric
    did not exist before the unified layer (e.g. ``store.hit_rate``)."""
    return _LEGACY.get(name)


def from_legacy(group: str, key: str) -> str:
    """Map an old-style ``(subtree, flat key)`` pair onto its canonical
    name — the direction BENCH comparison scripts need when they hold a
    historical row and want to look up the same counter in a new one."""
    return canonical(group, key)


# -- stats-tree flattening ---------------------------------------------------

def _hit_rate(c: dict) -> float:
    total = c.get("hits", 0) + c.get("misses", 0)
    return c["hits"] / total if total > 0 else 0.0


def flatten_stats(stats: dict | None) -> dict[str, float]:
    """Project a loader ``stats()`` tree onto the canonical flat metric
    namespace.  Only numeric leaves with canonical names are kept; the
    derived per-tier ``hit_rate`` gauges are computed here.  This is the
    shape the metrics registry snapshots, the JSONL sink writes, and
    every BENCH row embeds under ``"metrics"``."""
    out: dict[str, float] = {}
    if not stats:
        return out
    store = stats.get("store")
    if isinstance(store, dict) and store.get("kind") == "isp":
        # RemoteGraphStore.stats(): the trainer-side wire counters land
        # under ``isp.*``; the storage process's own DiskStore stats ride
        # in the "server" subtree and flatten onto ``store.*`` exactly
        # like a local store would
        isp = store.get("isp")
        if isinstance(isp, dict):
            for k in ISP_KEYS:
                if k in isp:
                    out[canonical("isp", k)] = isp[k]
        store = store.get("server")
    if isinstance(store, dict):
        # the store block may be a full ``DiskStore.stats()`` (io
        # counters inlined) or a bare counter dict; either way the
        # canonical keys are present by construction
        for k in STORE_IO_KEYS:
            if k in store:
                out[canonical("store", k)] = store[k]
        for k in FAULT_KEYS:
            if k in store:
                out[canonical("store", k)] = store[k]
        if "hits" in store:
            out["store.hit_rate"] = _hit_rate(store)
    for tier in TIERS:
        c = stats.get(tier)
        if isinstance(c, dict):
            for k in DEVCACHE_KEYS:
                if k in c:
                    out[canonical(tier, k)] = c[k]
            if "hits" in c:
                out[f"{tier}.hit_rate"] = _hit_rate(c)
    oracle = stats.get("oracle")
    if isinstance(oracle, dict):
        for k in ORACLE_KEYS:
            if k in oracle:
                out[canonical("oracle", k)] = oracle[k]
    for k in PIPELINE_KEYS:
        if k in stats and isinstance(stats[k], (int, float)):
            out[canonical("pipeline", k)] = stats[k]
    if "degraded" in stats:
        out["pipeline.degraded"] = int(bool(stats["degraded"]))
    stage_s = stats.get("stage_s")
    if isinstance(stage_s, dict):
        for k, v in stage_s.items():
            out[f"pipeline.stage_s.{k}"] = v
    return out


def train_metrics(steps: int, idle_s: float, busy_s: float,
                  steps_per_s: float, idle_fraction: float) -> dict:
    """The consumer-side metrics under their canonical names."""
    return {"train.steps": steps, "train.idle_s": idle_s,
            "train.busy_s": busy_s, "train.steps_per_s": steps_per_s,
            "train.idle_fraction": idle_fraction}
