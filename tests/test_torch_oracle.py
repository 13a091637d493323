"""The Belady oracle of the port (``repro_torch.storage.oracle``, the
``optimal`` policies of ``OracleCache``, the ``DiskStore`` and the device
caches) against the reference's ``repro.storage.oracle`` on the CPU.

``next_use_times`` equals the reference's and a naive scan; the
``OracleCache`` evicts the same victims in the same order under the same
access and schedule trace; the device feature and edge caches plan the
same slots and evictions; a ``DiskStore(policy="optimal")`` over 8
batches reads, maps and counts as the reference's.  On the
``smoke_pallas_optimal`` spec the store, devcache and edgecache counters
equal the reference's, every replayed stream equals the reference's
replay, the edge stream holds exactly the blocks the live path staged,
and the losses are bit-identical to the port's own ``lru`` twin.  Every
``optimal`` run reports replay errors and timeouts of 0.
"""

import dataclasses
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.config as ref_config
from repro.core import batch_targets as jbatch_targets
from repro.core import load_dataset as jload_dataset
from repro.core import sample_khop as jsample_khop
from repro.storage import DeviceEdgeBlockCache as JEdgeCache
from repro.storage import DeviceFeatureCache as JFeatureCache
from repro.storage import DiskStore as JDiskStore
from repro.storage import blockdev as jblockdev
from repro.storage import oracle as joracle
from repro.storage.faults import FaultSpec as JFaultSpec
from repro_torch.core import (GNNConfig, GraphSAGE, PipelineSpec,
                              PrefetchSpec, batch_targets, build_pipeline,
                              build_train_step, load_dataset, train_loop)
from repro_torch.core.sampler import sample_khop
from repro_torch.optim import adamw
from repro_torch.storage import (DeviceEdgeBlockCache, DeviceFeatureCache,
                                 DiskStore, FaultSpec, save_graph)
from repro_torch.storage import blockdev, oracle

SPEC_DIR = Path(__file__).resolve().parent.parent / "benchmarks" / "specs"
OPTIMAL = SPEC_DIR / "smoke_pallas_optimal.json"
LRU_TWIN = SPEC_DIR / "smoke_pallas_edgecache.json"
BATCH, FANOUTS = 8, (3, 2)
FAR = blockdev.FAR_NEXT_USE


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    jg, g = jload_dataset("reddit"), load_dataset("reddit")
    path = str(tmp_path_factory.mktemp("oracle-store"))
    save_graph(g, path)
    return jg, g, path


def _no_replay_faults(stats):
    assert stats["errors"] == 0 and stats["timeouts"] == 0, stats


# ---------------------------------------------------------------------------
# next_use_times and OracleCache
# ---------------------------------------------------------------------------

def _naive(pairs):
    out = {}
    for t, ids in pairs:
        nu = [next((u for u, uids in pairs if u > t and e in uids), FAR)
              for e in ids]
        out[t] = np.asarray(nu, np.int64)
    return out


@pytest.mark.parametrize("case", ["random", "sparse-ids", "empty-window",
                                  "empty-batches", "one-batch"])
def test_next_use_times_equal_reference_and_naive_scan(case):
    rng = np.random.default_rng(5)
    if case == "random":
        pairs = [(t, np.unique(rng.integers(0, 30, 12))) for t in range(6)]
    elif case == "sparse-ids":
        pairs = [(10 + 2 * t, np.unique(rng.integers(0, 2**40, 5)))
                 for t in range(4)]
        pairs[2] = (pairs[2][0], np.concatenate([pairs[0][1][:2],
                                                 pairs[2][1]]))
    elif case == "empty-window":
        pairs = []
    elif case == "empty-batches":
        pairs = [(0, np.empty(0, np.int64)), (1, np.array([4, 7])),
                 (2, np.empty(0, np.int64)), (3, np.array([7]))]
    else:
        pairs = [(3, np.array([1, 2, 9]))]
    got, want = oracle.next_use_times(pairs), joracle.next_use_times(pairs)
    assert got.keys() == want.keys()
    naive = _naive(pairs)
    for t in got:
        np.testing.assert_array_equal(got[t][0], want[t][0])
        np.testing.assert_array_equal(got[t][1], want[t][1])
        np.testing.assert_array_equal(got[t][1], naive[t])
        assert got[t][1].dtype == np.int64


def _drive_oracle_cache(mod, capacity, batches, sched, live):
    """Every victim of one access/schedule trace, in order, and the
    counters; ``live`` drives the payload path (get/peek/put_new), else
    the trace-replay path (access/access_run)."""
    cache = mod.OracleCache(capacity)
    victims = []
    for t, ids in enumerate(batches):
        if sched is not None and t in sched:
            cache.begin_batch(t, *sched[t])
        for b in ids:
            b = int(b)
            if live:
                if cache.get(b) is None:
                    assert cache.peek(b) is None
                    ev = cache.put_new(b, b)
                    if ev is not None:
                        victims.append(ev)
            else:
                before = set(cache._data)
                cache.access(b)
                victims.extend(sorted(before - set(cache._data)))
        if not live:
            cache.access_run(int(ids[0]), 3)
    return victims, cache.counters(), list(cache._data)


@pytest.mark.parametrize("capacity,live,scheduled", [
    (4, True, True), (4, False, True), (9, True, True), (1, True, True),
    (4, True, False), (2, False, True)])
def test_oracle_cache_equals_reference(capacity, live, scheduled):
    rng = np.random.default_rng(capacity)
    # enough pushes to cross the heap rebuild at max(1024, 16 * capacity)
    batches = [np.unique(rng.integers(0, 40, 14)) for _ in range(120)]
    sched = (oracle.next_use_times(list(enumerate(batches)))
             if scheduled else None)
    got = _drive_oracle_cache(blockdev, capacity, batches, sched, live)
    want = _drive_oracle_cache(jblockdev, capacity, batches, sched, live)
    assert got == want
    assert got[1]["evictions"] > 0


def test_oracle_cache_deferral_and_far_sentinel():
    c = blockdev.OracleCache(2)
    c.put_new(1, "a")
    c.put_new(2, "b")
    # batch 0 protects {1} at next use 0 and defers its true time (FAR)
    c.begin_batch(0, np.array([1]), np.array([FAR]))
    assert c._next_use_of(1) == 0 and c._next_use_of(2) == FAR
    assert c.put_new(3, "c") == (2, "b")
    c.begin_batch(1, np.array([3]), np.array([5]))
    assert c._next_use_of(1) == FAR and 1 not in c._nu
    assert c.put_new(4, "d") == (1, "a")


# ---------------------------------------------------------------------------
# the device caches under optimal
# ---------------------------------------------------------------------------

def _plan_record(plan):
    return [(ps.ids.tolist(), ps.miss_ids.tolist(), ps.slots.tolist(),
             ps.evict_ids.tolist(), ps.hits, ps.misses, ps.evictions)
            for ps in plan.segments]


@pytest.mark.parametrize("rows,fed", [(48, True), (24, True), (48, False)])
def test_feature_cache_optimal_plans_equal_reference(graphs, rows, fed):
    jg, g, _ = graphs
    port = DeviceFeatureCache(g, rows=rows, policy="optimal", device="cpu")
    ref = JFeatureCache(jg, rows=rows, policy="optimal")
    # two alternating hot sets plus one-shot cold rows: Belady keeps the
    # other hot set across its gap, LRU does not
    a, b = np.arange(16), np.arange(16, 32)
    batches = [np.unique(np.concatenate(
        [a if t % 2 == 0 else b, np.arange(100 + 16 * t, 116 + 16 * t)]))
        for t in range(8)]
    if fed:
        sched = oracle.next_use_times(list(enumerate(batches)))
        port.oracle_feed(sched)
        ref.oracle_feed(sched)
    for t, ids in enumerate(batches):
        port.oracle_begin_batch(t)
        ref.oracle_begin_batch(t)
        p_plan, r_plan = port.plan_rows(ids), ref.plan_rows(ids)
        assert _plan_record(p_plan) == _plan_record(r_plan), f"batch {t}"
        assert p_plan.counters == r_plan.counters
        rows_p = port.execute_plan(port.fetch_plan(p_plan))
        rows_r = ref.execute_plan(ref.fetch_plan(r_plan))
        np.testing.assert_array_equal(rows_p.numpy(), np.asarray(rows_r))
        np.testing.assert_array_equal(port._next_use, ref._next_use)
    np.testing.assert_array_equal(port.slot_of.numpy(),
                                  np.asarray(ref.slot_of))
    assert port.counters() == ref.counters()
    lru = DeviceFeatureCache(g, rows=rows, policy="lru", device="cpu")
    for ids in batches:
        lru.gather_rows(ids)
    got, base = port.counters(), lru.counters()
    assert got["hits"] + got["misses"] == base["hits"] + base["misses"]
    if fed and rows > 32:
        assert got["misses"] < base["misses"]
    else:
        # no schedule, or below one batch's 32 rows (the quantum): LRU
        assert got == base
    # the next-use mirror survives a reset, as in the reference
    nu = port._next_use.copy()
    port.reset()
    ref.reset()
    np.testing.assert_array_equal(port._next_use, nu)
    np.testing.assert_array_equal(port._next_use, ref._next_use)


def test_edge_cache_optimal_plans_equal_reference(graphs):
    jg, g, _ = graphs
    kw = dict(indptr=g.indptr, block_e=256, blocks=12, policy="optimal")
    port = DeviceEdgeBlockCache(g, device="cpu", **kw)
    ref = JEdgeCache(jg, **kw)
    rng = np.random.default_rng(2)
    frontiers = [rng.integers(0, g.num_nodes, 40) for _ in range(6)]

    def blocks_of(flat):
        b0 = np.minimum(g.indptr[flat] // 256, port.max_block)
        return np.unique(np.concatenate([b0, b0 + 1, [0, 1]]))

    sched = oracle.next_use_times([(t, blocks_of(f))
                                   for t, f in enumerate(frontiers)])
    port.oracle_feed(sched)
    ref.oracle_feed(sched)
    for t, flat in enumerate(frontiers):
        port.oracle_begin_batch(t)
        ref.oracle_begin_batch(t)
        p_chunks, r_chunks = port.plan(flat), ref.plan(flat)
        assert len(p_chunks) == len(r_chunks) > 1
        for (ps, pb), (rs, rb) in zip(p_chunks, r_chunks):
            assert ps == rs
            np.testing.assert_array_equal(pb, rb)
            port.resolve(pb)
            ref.resolve(rb)
            assert port.counters() == ref.counters()
            np.testing.assert_array_equal(port.slot_of.numpy(),
                                          np.asarray(ref.slot_of))
            np.testing.assert_array_equal(port.table.numpy(),
                                          np.asarray(ref.table))
    assert port.counters()["evictions"] > 0
    with pytest.raises(ValueError, match="oracle_feed"):
        DeviceEdgeBlockCache(g, device="cpu", indptr=g.indptr, block_e=256,
                             blocks=12).oracle_feed({})


# ---------------------------------------------------------------------------
# DiskStore(policy="optimal") over 8 batches
# ---------------------------------------------------------------------------

def _store_run(mod_store, sample, targets_fn, reader_cls, replayer_cls,
               path, policy):
    store = mod_store(path, cache_mb=0.25, policy=policy)
    log = []
    try:
        if policy == "optimal":
            raw = reader_cls(store)

            def replay(idx):
                t = targets_fn(store, idx, BATCH, 0)
                tr = sample(raw, t, FANOUTS, seed=idx)
                return {"pages": store.replay_block_ids(
                    feature_nodes=tr.subgraph_nodes,
                    edge_nodes=np.unique(tr.touched_nodes),
                    label_nodes=t)}

            rep = replayer_cls(replay, {"pages": store.oracle_feed},
                               window=4)
            store.oracle_attach(rep)
        for i in range(8):
            store.oracle_advance(i)
            t = targets_fn(store, i, BATCH, 0)
            tr = sample(store, t, FANOUTS, seed=i)
            for h in tr.hops:
                store.gather_features(h)
            store.gather_labels(t)
            log.append((tr.hops, tr.io, store.io_counters()))
        stats = rep.stats() if policy == "optimal" else None
    finally:
        store.close()
    return log, stats


def test_diskstore_optimal_counters_equal_reference(graphs):
    jg, g, path = graphs
    port, stats = _store_run(DiskStore, sample_khop, batch_targets,
                             oracle.RawDiskReader, oracle.OracleReplayer,
                             path, "optimal")
    ref, _ = _store_run(JDiskStore, jsample_khop, jbatch_targets,
                        joracle.RawDiskReader, joracle.OracleReplayer,
                        path, "optimal")
    lru, _ = _store_run(DiskStore, sample_khop, batch_targets, None, None,
                        path, "lru")
    _no_replay_faults(stats)
    assert stats["batches_replayed"] >= 8
    for i, ((ph, pio, pc), (rh, rio, rc), (lh, _, lc)) in enumerate(
            zip(port, ref, lru)):
        for a, b, c in zip(ph, rh, lh):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert pio == rio and pc == rc, f"batch {i}"
    last, base = port[-1][2], lru[-1][2]
    assert last["hits"] + last["misses"] == base["hits"] + base["misses"]
    assert last["misses"] <= base["misses"] and last["evictions"] > 0


def test_read_indices_at_and_replay_block_ids_equal_reference(graphs):
    jg, g, path = graphs
    port, ref = DiskStore(path, cache_mb=1.0), JDiskStore(path, cache_mb=1.0)
    try:
        rng = np.random.default_rng(2)
        pos = rng.integers(0, g.num_edges, (17, 15))
        io0 = port.io_counters()
        got = port.read_indices_at(pos)
        assert got.shape == pos.shape
        np.testing.assert_array_equal(got, ref.read_indices_at(pos))
        np.testing.assert_array_equal(got, g.indices[pos])
        assert port.io_counters() == io0        # billed nothing
        nodes = np.unique(rng.integers(0, g.num_nodes, 64))
        blocks = np.unique(rng.integers(0, 80, 20))
        for kw in (dict(feature_nodes=nodes), dict(edge_nodes=nodes),
                   dict(label_nodes=nodes),
                   dict(edge_blocks=blocks, block_e=256),
                   dict(feature_nodes=nodes, edge_nodes=nodes,
                        label_nodes=nodes, edge_blocks=blocks, block_e=256),
                   {}):
            np.testing.assert_array_equal(port.replay_block_ids(**kw),
                                          ref.replay_block_ids(**kw))
        with pytest.raises(ValueError, match="oracle_attach"):
            port.oracle_attach(None)
    finally:
        port.close()
        ref.close()


def test_replay_reads_keep_the_retry_policy(graphs):
    """``read_indices_at`` goes through ``_fetch``: injected faults are
    retried, the values stay exact, and the replay bills only the fault
    counters, as in the reference."""
    _, g, path = graphs
    kw = dict(seed=3, eio_rate=0.3, short_read_rate=0.2)
    port = DiskStore(path, faults=FaultSpec(**kw), verify=True)
    ref = JDiskStore(path, faults=JFaultSpec(**kw), verify=True)
    try:
        pos = np.arange(0, g.num_edges, 97)
        np.testing.assert_array_equal(port.read_indices_at(pos),
                                      g.indices[pos])
        ref.read_indices_at(pos)
        got, want = port.io_counters(), ref.io_counters()
        assert got == want
        assert got["retries"] > 0 and got["requests"] == got["misses"] == 0
    finally:
        port.close()
        ref.close()


# ---------------------------------------------------------------------------
# the smoke_pallas_optimal spec
# ---------------------------------------------------------------------------

def _io_fixed(io):
    return {"devcache": io["devcache"], "edgecache": io["edgecache"],
            "requests": io["requests"],
            "blocks_touched": io["hits"] + io["misses"]}


def test_optimal_spec_counters_and_streams_equal_reference(graphs,
                                                           monkeypatch):
    jg, g, _ = graphs
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_config.build_pipeline(
            ref_config.PipelineSpec.load(str(OPTIMAL)), jg)
    port = build_pipeline(PipelineSpec.load(str(OPTIMAL)), g, device="cpu")
    ec = port.loader.edgecache
    staged = {}
    resolve = ec.resolve

    def record(blocks):
        staged.setdefault(cur[0], set()).update(int(b) for b in blocks)
        return resolve(blocks)

    cur = [0]
    monkeypatch.setattr(ec, "resolve", record)
    try:
        for idx in range(5):
            cur[0] = idx
            got, want = port.get_batch(idx), ref.get_batch(idx)
            for x, y in zip(got.hop_ids + got.hop_feats + [got.labels],
                            want.hop_ids + want.hop_feats + [want.labels]):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
            assert got.trace.io == want.trace.io, f"batch {idx}"
            # the replayed streams equal the reference's replay, and the
            # edge stream is exactly the blocks the live path staged
            p = port.loader._oracle._replay(idx)
            r = ref.loader._oracle._replay(idx)
            assert p.keys() == r.keys() == {"features", "edge_blocks",
                                            "pages"}
            for k in p:
                np.testing.assert_array_equal(p[k], r[k])
            assert set(p["edge_blocks"].tolist()) == staged[idx]
            np.testing.assert_array_equal(p["features"],
                                          got.trace.subgraph_nodes)
        ps, rs = port.stats(), ref.stats()
        for tier in ("store", "devcache", "edgecache"):
            keys = ("hits", "misses", "evictions", "policy")
            assert {k: ps[tier][k] for k in keys} == \
                {k: rs[tier][k] for k in keys}, tier
        assert port.store.io_counters() == ref.store.io_counters()
        _no_replay_faults(ps["oracle"])
        _no_replay_faults(rs["oracle"])
    finally:
        port.close()
        ref.close()


def _train(spec, g, steps=4):
    pipe = build_pipeline(spec, g, device="cpu")
    try:
        torch.manual_seed(0)
        model = GraphSAGE(GNNConfig(feat_dim=g.feat_dim, hidden=16,
                                    n_classes=int(g.labels.max()) + 1,
                                    fanouts=FANOUTS), device="cpu",
                          compute_dtype=torch.float32)
        opt = adamw(1e-2)
        state = {"opt": opt.init(dict(model.named_parameters())), "step": 0}
        losses = []
        train_loop(pipe, build_train_step(pipe, model, opt), state,
                   steps=steps,
                   on_step=lambda i, s, m: losses.append(repr(float(
                       m["loss"]))))
        return losses, pipe.stats()
    finally:
        pipe.close()


def test_optimal_losses_bit_identical_to_lru_twin(graphs):
    _, g, _ = graphs
    lru, lru_stats = _train(PipelineSpec.load(str(LRU_TWIN)), g)
    opt, opt_stats = _train(PipelineSpec.load(str(OPTIMAL)), g)
    assert opt == lru
    for tier in ("devcache", "edgecache"):
        a, b = lru_stats[tier], opt_stats[tier]
        assert a["hits"] + a["misses"] == b["hits"] + b["misses"], tier
        assert b["misses"] <= a["misses"], tier
    _no_replay_faults(opt_stats["oracle"])
    assert opt_stats["oracle"]["batches_replayed"] >= 4


def test_overlapped_optimal_with_a_stall_equals_sync(graphs):
    _, g, _ = graphs
    base = PipelineSpec.load(str(OPTIMAL))
    over = base.replace(
        prefetch=PrefetchSpec(depth=2, overlap=True, stage_depth=2,
                              lane_timeout_s=1.0, max_lane_restarts=4),
        store=dataclasses.replace(base.store, faults=FaultSpec(
            lane_stall_batch=2, lane_stall_s=2.5)))
    a = build_pipeline(over, g, device="cpu")
    b = build_pipeline(base, g, device="cpu")
    try:
        for i in range(6):
            x, y = a.get_batch(i, timeout=60.0), b.get_batch(i)
            for s, t in zip(x.hop_ids + x.hop_feats + [x.labels],
                            y.hop_ids + y.hop_feats + [y.labels]):
                assert torch.equal(s, t), f"batch {i}"
        s = a.stats()
        assert s["lane_stall_restarts"] >= 1 and not s["degraded"]
        _no_replay_faults(s["oracle"])
        _no_replay_faults(b.stats()["oracle"])
    finally:
        a.close()
        b.close()


def test_replay_failure_falls_back_to_lru_with_one_warning(graphs,
                                                           monkeypatch):
    """The soft failure: a replay that raises marks its window ready with
    no schedule; the caches then choose as LRU does, the values stay
    exact, and ``errors`` counts it (which every optimal run above
    asserts is 0)."""
    _, g, _ = graphs
    from repro_torch.core import sampler as sampler_mod

    def broken(*a, **kw):
        raise RuntimeError("replay broke")

    monkeypatch.setattr(sampler_mod, "replay_khop_jax_ids", broken)
    with pytest.warns(UserWarning, match="fall back to LRU"):
        opt, stats = _train(PipelineSpec.load(str(OPTIMAL)), g, steps=3)
    lru, lru_stats = _train(PipelineSpec.load(str(LRU_TWIN)), g, steps=3)
    assert opt == lru
    assert stats["oracle"]["errors"] >= 1
    assert stats["devcache"]["misses"] == lru_stats["devcache"]["misses"]
    assert stats["edgecache"]["misses"] == lru_stats["edgecache"]["misses"]
