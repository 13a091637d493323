"""The port's telemetry layer (``repro_torch.obs``) against the reference's
``repro.obs``, on the CPU.

The reference's ``tests/test_obs.py``, case for case, on the port: the
registry's per-thread shards under concurrent increments, stable
histogram buckets, associative snapshot merging, closed and per-lane
ordered spans in the Perfetto export, the no-op fast path, the session's
install/close cycle, the canonical names and their compat shim, the
stats-tree flattening, and a pallas overlapped out-of-core run whose
trace and JSONL snapshots carry the reference's span, track and metric
names while its losses stay repr-equal to the telemetry-off run.  Then
what only a port needs: the canonical name table and key tuples equal
the reference's, ``flatten_stats`` gives equal dicts in both packages,
and the same spec traced through both packages' pipelines shows the same
span names, arguments and lanes.  Counters, names and losses are held
exactly; there is no tolerance in this file.
"""

import json
import sys
import threading

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.config as ref_config
from repro import obs as ref_obs
from repro.core import load_dataset as jload_dataset
from repro.obs import names as ref_names
from repro_torch import obs
from repro_torch.core import (GNNConfig, GraphSAGE, build_pipeline,
                              build_train_step, load_dataset, train_loop)
from repro_torch.core import config as port_config
from repro_torch.obs import names
from repro_torch.obs.metrics import (HIST_BUCKETS, HIST_EDGES,
                                     MetricsRegistry, bucket_index,
                                     idle_fraction, merge_snapshots)
from repro_torch.obs.tracer import SpanTracer
from repro_torch.optim import adamw


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_concurrent_increments_sum_exactly():
    """Increments from 6 threads, with the interpreter switching threads
    as often as it can, land exactly: per-thread shards lose no update,
    and the snapshot merge adds them all back up."""
    reg = MetricsRegistry()
    threads, per_thread = 6, 10_000

    def worker(k):
        for _ in range(per_thread):
            reg.inc("store.requests")
            reg.inc("store.bytes_fetched", 4096)
            if k % 2 == 0:
                reg.observe("pipeline.stage_latency_s", 1e-3)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker, args=(k,))
              for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    snap = reg.snapshot()
    assert snap["store.requests"] == threads * per_thread
    assert snap["store.bytes_fetched"] == threads * per_thread * 4096
    hist = snap["pipeline.stage_latency_s"]
    assert hist["count"] == (threads // 2) * per_thread
    assert sum(hist["buckets"]) == hist["count"]


def test_histogram_bucket_edges_stable():
    """Fixed log2 edges, the reference's: data-independent, index
    computable, monotone."""
    assert HIST_EDGES == ref_obs.HIST_EDGES
    assert len(HIST_EDGES) == HIST_BUCKETS - 1
    assert all(b == a * 2 for a, b in zip(HIST_EDGES, HIST_EDGES[1:]))
    for v in (0.0, 1e-9, 2 ** -20, 1e-3, 0.5, 1.0, 1.5, 2.0, 1e6, 1e30):
        i = bucket_index(v)
        assert i == bucket_index(v) == ref_obs.bucket_index(v)
        assert 0 <= i < HIST_BUCKETS
        if 0 < i < HIST_BUCKETS - 1:
            assert HIST_EDGES[i - 1] <= v < HIST_EDGES[i]
    assert bucket_index(HIST_EDGES[0]) == 1
    assert bucket_index(HIST_EDGES[10]) == 11
    a, b = MetricsRegistry(), MetricsRegistry()
    vals = [1e-6, 3e-4, 0.02, 0.02, 7.0]
    for v in vals:
        a.observe("h", v)
    for v in reversed(vals):
        b.observe("h", v)
    assert a.snapshot()["h"]["buckets"] == b.snapshot()["h"]["buckets"]


@settings(max_examples=50)
@given(st.lists(st.integers(0, 100), min_size=9, max_size=9))
def test_merge_snapshots_associative(vals):
    """(a + b) + c == a + (b + c) for counter and histogram entries, and
    the port's merge equals the reference's."""
    def mk(sub):
        # integer-valued floats: addition is exact, so the float sums in
        # the merged histograms are associative bit for bit
        h = {"buckets": [0] * HIST_BUCKETS, "count": 0, "sum": 0.0}
        for v in sub:
            h["buckets"][bucket_index(float(v))] += 1
            h["count"] += 1
            h["sum"] += float(v)
        return {"store.hits": sub[0], "store.misses": sub[1] * 2, "lat": h}

    a, b, c = mk(vals[0:3]), mk(vals[3:6]), mk(vals[6:9])
    left = merge_snapshots(merge_snapshots(a, b), c)
    right = merge_snapshots(a, merge_snapshots(b, c))
    assert left == right
    assert merge_snapshots(a, b) == merge_snapshots(b, a)
    assert left == ref_obs.merge_snapshots(ref_obs.merge_snapshots(a, b), c)


def test_idle_fraction_shared_helper():
    """The single copy both stats dataclasses delegate to."""
    from repro_torch.core.loader import RunStats
    from repro_torch.core.pipeline import PipelineStats
    assert idle_fraction(0.0, 0.0) == 0.0
    assert idle_fraction(1.0, 3.0) == 0.25
    rs = RunStats(steps=4, idle_s=1.0, busy_s=3.0, wall_s=4.0)
    ps = PipelineStats(batches=4, consumer_idle_s=1.0, consumer_busy_s=3.0)
    assert rs.idle_fraction == ps.idle_fraction == 0.25


# ---------------------------------------------------------------------------
# span tracer + Perfetto export
# ---------------------------------------------------------------------------

def test_exported_spans_closed_and_ordered(tmp_path):
    """Every exported span is a complete event and, per lane, timestamps
    are monotone with sibling spans disjoint (nested ones contained)."""
    tracer = SpanTracer()

    def lane(name, n):
        for i in range(n):
            with tracer.span("work", {"batch": i, "lane": name}):
                with tracer.span("inner", {"batch": i, "lane": name}):
                    pass

    ts = [threading.Thread(target=lane, args=(f"lane-{k}", 25))
          for k in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in ts)

    path = tmp_path / "trace.json"
    tracer.export(str(path))
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    metas = [e for e in events if e["ph"] == "M"]
    assert {e["ph"] for e in events} <= {"X", "M"}
    assert len(spans) == 4 * 25 * 2
    assert {m["args"]["name"] for m in metas} == {f"lane-{k}"
                                                  for k in range(4)}
    by_tid = {}
    for e in spans:
        assert e["dur"] >= 0 and e["ts"] >= 0
        by_tid.setdefault(e["tid"], []).append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        for prev, nxt in zip(evs, evs[1:]):
            assert nxt["ts"] >= prev["ts"]
            disjoint = nxt["ts"] >= prev["ts"] + prev["dur"]
            nested = nxt["ts"] + nxt["dur"] <= prev["ts"] + prev["dur"]
            assert disjoint or nested, (prev, nxt)


def test_trace_span_noop_when_uninstalled():
    assert obs.active_session() is None
    assert not obs.tracing()
    span = obs.trace_span("anything", batch=0)
    assert span is obs.NULL_SPAN                        # shared, no alloc
    with span:
        pass
    obs.tick()                                          # no-op, no error


def test_session_install_uninstall(tmp_path):
    s = obs.ObsSession(trace_path=str(tmp_path / "t.json"),
                       metrics_path=str(tmp_path / "m.jsonl"),
                       metrics_interval_s=60.0)
    obs.install(s)
    try:
        assert obs.tracing()
        with obs.trace_span("step", batch=7, lane="consumer"):
            obs.metric_inc("train.steps")
    finally:
        s.close()
    assert not obs.tracing()
    trace = json.loads((tmp_path / "t.json").read_text())
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 1 and xs[0]["name"] == "step"
    assert xs[0]["args"]["batch"] == 7
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert lines, "final snapshot missing"
    assert json.loads(lines[-1])["metrics"]["train.steps"] == 1
    s.close()                                           # idempotent


# ---------------------------------------------------------------------------
# canonical names
# ---------------------------------------------------------------------------

def test_canonical_names_single_source():
    """The emitters' key tuples are the canonical table's leaves."""
    from repro_torch.storage.store import IOContext
    assert IOContext.FAULT_KEYS == names.FAULT_KEYS
    assert IOContext.KEYS == names.STORE_IO_KEYS + names.FAULT_KEYS
    assert names.canonical("store", "hits") == "store.hits"
    assert names.canonical("store", "retries") == "store.faults.retries"
    assert names.canonical("devcache", "bytes_uploaded") == \
        "devcache.bytes_uploaded"


def test_legacy_key_compat_shim():
    assert names.legacy_key("store.faults.retries") == "retries"
    assert names.legacy_key("devcache.hits") == "hits"
    assert names.legacy_key("store.hit_rate") is None
    assert names.from_legacy("store", "io_errors") == \
        "store.faults.io_errors"


STATS = {
    "store": {"requests": 10, "block_fetches": 4, "bytes_fetched": 8192,
              "hits": 6, "misses": 4, "evictions": 1, "retries": 2,
              "io_errors": 1, "short_reads": 0, "corrupt_blocks": 0,
              "timeouts": 0, "kind": "disk"},
    "devcache": {"hits": 30, "misses": 10, "evictions": 5,
                 "preload_rows": 8, "bytes_uploaded": 4096, "policy": "lru"},
    "oracle": {"window": 4, "windows_built": 2, "batches_replayed": 8,
               "errors": 0, "timeouts": 0},
    "lane_stall_restarts": 1, "lane_failures": 0, "prefetched": 12,
    "degraded": False, "stage_s": {"sample": 0.5},
}


def test_flatten_stats_maps_tree_to_canonical():
    flat = names.flatten_stats(STATS)
    assert flat["store.requests"] == 10
    assert flat["store.faults.retries"] == 2
    assert flat["store.hit_rate"] == 0.6
    assert flat["devcache.hit_rate"] == 0.75
    assert flat["oracle.batches_replayed"] == 8
    assert flat["pipeline.lane_stall_restarts"] == 1
    assert flat["pipeline.degraded"] == 0
    assert flat["pipeline.stage_s.sample"] == 0.5
    assert "kind" not in json.dumps(list(flat))


def test_names_equal_reference():
    """The canonical name table, every key tuple, the tiers and the
    compat shim's map are the reference's."""
    assert names.CANONICAL_NAMES == ref_names.CANONICAL_NAMES
    for key in ("STORE_IO_KEYS", "FAULT_KEYS", "DEVCACHE_KEYS",
                "ORACLE_KEYS", "PIPELINE_KEYS", "TRAIN_KEYS", "ISP_KEYS",
                "TIERS"):
        assert getattr(names, key) == getattr(ref_names, key), key
    assert names._LEGACY == ref_names._LEGACY
    assert names.train_metrics(4, 1.0, 3.0, 2.0, 0.25) == \
        ref_names.train_metrics(4, 1.0, 3.0, 2.0, 0.25)
    assert obs.__all__ == ref_obs.__all__


ISP_STATS = {
    "store": {"kind": "isp", "transport": "unix", "window": 4,
              "isp": {"requests": 9, "bytes_tx": 900, "bytes_rx": 12345,
                      "disconnects": 0, "reconnects": 0},
              "server": dict(STATS["store"])},
    "edgecache": {"hits": 3, "misses": 1, "evictions": 0, "preload_rows": 0,
                  "bytes_uploaded": 512},
}


@pytest.mark.parametrize("stats", [STATS, ISP_STATS, {}, None],
                         ids=["local", "isp", "empty", "none"])
def test_flatten_stats_equals_reference(stats):
    assert names.flatten_stats(stats) == ref_names.flatten_stats(stats)
    flat = names.flatten_stats(stats)
    summary = obs.epoch_summary(flat)
    assert summary == ref_obs.epoch_summary(flat)
    assert summary.startswith("[obs] epoch summary")


# ---------------------------------------------------------------------------
# end to end: telemetry files from a real pipeline, bits unperturbed
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graph():
    return load_dataset("reddit")


def _run_spec(spec, g, steps=4):
    losses = []
    with build_pipeline(spec, g, device="cpu") as pipe:
        gnn = GraphSAGE(GNNConfig(feat_dim=g.feat_dim, hidden=16,
                                  n_classes=int(g.labels.max()) + 1,
                                  fanouts=spec.effective_fanouts),
                        device="cpu")
        opt = adamw(3e-3)
        step = build_train_step(pipe, gnn, opt)
        state = {"opt": opt.init(dict(gnn.named_parameters())), "step": 0}
        train_loop(pipe, step, state, steps=steps,
                   on_step=lambda i, s, m: losses.append(float(m["loss"])))
    return losses


def _overlap_spec(config, tmp_path, obs_spec):
    return config.PipelineSpec(
        backend=config.BackendSpec(name="pallas"),
        store=config.StoreSpec(kind="disk", path=str(tmp_path / "gs"),
                               io_threads=2),
        cache_tiers=(
            config.CacheTierSpec(tier="host", policy="lru", capacity_mb=0.5,
                                 arrays=()),
            config.CacheTierSpec.device(rows=48, policy="lru")),
        prefetch=config.PrefetchSpec(depth=2, overlap=True, stage_depth=2),
        batch_size=8, obs=obs_spec)


def test_pipeline_telemetry_end_to_end(graph, tmp_path):
    """A disk-backed pallas run with a device feature tier on the
    overlapped lanes, telemetry on: a Perfetto-loadable trace with the
    lanes', the consumer's, the device cache's and the disk reads' spans
    (preads attributed to batches) and JSONL snapshots with the per-tier
    counters; its losses are repr-equal to the telemetry-off twin's."""
    trace_path = tmp_path / "trace.json"
    metrics_path = tmp_path / "metrics.jsonl"
    on = _run_spec(_overlap_spec(port_config, tmp_path, port_config.ObsSpec(
        trace_path=str(trace_path), metrics_path=str(metrics_path),
        metrics_interval_s=0.05)), graph)
    off = _run_spec(_overlap_spec(port_config, tmp_path,
                                  port_config.ObsSpec()), graph)
    assert [repr(x) for x in on] == [repr(x) for x in off]
    assert obs.active_session() is None         # closed with the pipeline

    trace = json.loads(trace_path.read_text())
    assert {e["ph"] for e in trace["traceEvents"]} <= {"X", "M"}
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    for stage in ("sample", "resolve", "admit", "consume.step",
                  "devcache.plan", "disk.pread"):
        assert by_name.get(stage), f"no {stage} spans in {sorted(by_name)}"
    lanes = {m["args"]["name"] for m in trace["traceEvents"]
             if m["ph"] == "M"}
    assert {"overlap-sample", "overlap-resolve", "overlap-admit",
            "consumer"} <= lanes, lanes
    assert any(e.get("args", {}).get("batch") is not None
               for e in by_name["disk.pread"])

    lines = metrics_path.read_text().splitlines()
    assert lines
    snap = json.loads(lines[-1])["metrics"]
    for k in ("store.hits", "store.misses", "store.bytes_fetched",
              "store.hit_rate", "devcache.hit_rate", "store.faults.retries"):
        assert k in snap, (k, sorted(snap))
    assert snap["store.bytes_fetched"] > 0


def _names_and_lanes(path):
    trace = json.loads(path.read_text())
    spans = {}
    for e in trace["traceEvents"]:
        if e["ph"] == "X":
            spans.setdefault(e["name"], set()).update(e.get("args", {}))
    lanes = {m["args"]["name"] for m in trace["traceEvents"]
             if m["ph"] == "M" and m["args"]["name"].startswith("overlap-")}
    return spans, lanes


def test_trace_names_equal_reference(graph, tmp_path):
    """The same overlapped spec traced through both packages' pipelines
    (3 batches each): the same span names with the same argument keys,
    and the same lane tracks."""
    got = {}
    for tag, config, g in (("port", port_config, graph),
                           ("ref", ref_config, jload_dataset("reddit"))):
        d = tmp_path / tag
        d.mkdir()
        spec = _overlap_spec(config, d, config.ObsSpec(
            trace_path=str(d / "t.json")))
        kw = {"device": "cpu"} if tag == "port" else {}
        pipe = config.build_pipeline(spec, g, **kw)
        try:
            for i in range(3):
                pipe.get_batch(i)
        finally:
            pipe.close()
        got[tag] = _names_and_lanes(d / "t.json")
    assert got["port"] == got["ref"]
    spans, lanes = got["port"]
    assert lanes == {"overlap-sample", "overlap-resolve", "overlap-admit"}
    assert spans["disk.pread"] >= {"array", "block", "attempt"}
