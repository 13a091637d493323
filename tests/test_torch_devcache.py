"""The port's device caches (``repro_torch.storage.devcache``, on CPU
tensors) against the reference's (jnp arrays, Pallas in interpret mode).

After the same id sequences the two caches hold the same ``table`` and
``slot_of`` bit for bit, return the same rows and report the same
counters, for lru and pinned placement, a one-row cache, duplicate ids,
staged admission and the edge-block planner's chunk split.
"""

import numpy as np
import pytest
import torch

from repro.core import load_dataset as jload_dataset
from repro.kernels import ops as jops
from repro.kernels.neighbor_sample import edge_block_count as jblock_count
from repro.kernels.neighbor_sample import edge_pad as jedge_pad
from repro.storage import DeviceEdgeBlockCache as JEdgeCache
from repro.storage import DeviceFeatureCache as JFeatureCache
from repro.storage.devcache import pad_pow2 as jpad_pow2
from repro_torch.core import load_dataset
from repro_torch.kernels import ops
from repro_torch.kernels.neighbor_sample import edge_block_count, edge_pad
from repro_torch.storage import (DeviceEdgeBlockCache, DeviceFeatureCache,
                                 StaleAdmissionPlan, pad_pow2)


@pytest.fixture(scope="module")
def graphs():
    return jload_dataset("reddit"), load_dataset("reddit")


def _same_state(port, ref):
    np.testing.assert_array_equal(port.table.numpy(), np.asarray(ref.table))
    np.testing.assert_array_equal(port.slot_of.numpy(),
                                  np.asarray(ref.slot_of))
    assert port.counters() == ref.counters()
    assert port.stats() == ref.stats()


def _id_batches(n, seed, count=5, size=40):
    rng = np.random.default_rng(seed)
    # skewed toward low ids, so batches share rows and hits happen
    return [np.minimum(rng.zipf(1.3, size), n) - 1 for _ in range(count)]


@pytest.mark.parametrize("rows,policy", [(24, "lru"), (24, "pinned"),
                                         (1, "lru"), (64, "pinned")])
def test_feature_cache_equals_reference(graphs, rows, policy):
    jg, g = graphs
    ref = JFeatureCache(jg, rows=rows, policy=policy)
    port = DeviceFeatureCache(g, rows=rows, policy=policy, device="cpu")
    _same_state(port, ref)                       # pinned preload
    for ids in _id_batches(g.num_nodes, rows):
        uniq = np.unique(ids)
        padded = pad_pow2(uniq, uniq[-1])
        want = ref.gather_rows(padded, n_valid=uniq.size)
        got = port.gather_rows(padded, n_valid=uniq.size)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy()[:uniq.size],
                                      g.features[uniq])
        _same_state(port, ref)


def test_feature_cache_duplicate_ids_install_once(graphs):
    jg, g = graphs
    ref = JFeatureCache(jg, rows=6, policy="lru")
    port = DeviceFeatureCache(g, rows=6, policy="lru", device="cpu")
    for ids in (np.array([5, 5, 9, 5, 9, 2]), np.array([2, 2, 2, 7]),
                np.array([11, 12, 13, 14, 15, 16, 17, 11, 12])):
        want = ref.gather_rows(ids)
        got = port.gather_rows(ids)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), g.features[ids])
        _same_state(port, ref)


def test_staged_admission_and_reset_equal_reference(graphs):
    jg, g = graphs
    ref = JFeatureCache(jg, rows=10, policy="pinned")
    port = DeviceFeatureCache(g, rows=10, policy="pinned", device="cpu")
    for ids in _id_batches(g.num_nodes, 3, count=3, size=30):
        uniq = np.unique(ids)
        plans = [c.plan_rows(pad_pow2(uniq, uniq[-1]), n_valid=uniq.size)
                 for c in (ref, port)]
        assert plans[1].counters == plans[0].counters
        assert len(plans[1].segments) == len(plans[0].segments)
        for a, b in zip(plans[1].segments, plans[0].segments):
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.slots, b.slots)
            np.testing.assert_array_equal(a.evict_ids, b.evict_ids)
        ref.fetch_plan(plans[0])
        port.fetch_plan(plans[1])
        np.testing.assert_array_equal(port.execute_plan(plans[1]).numpy(),
                                      np.asarray(ref.execute_plan(plans[0])))
        _same_state(port, ref)
    ref.plan_rows(np.array([1, 2, 3]))           # planning counts
    stale = port.plan_rows(np.array([1, 2, 3]))
    port.reset()
    ref.reset()
    _same_state(port, ref)
    assert port.resets == 1
    with pytest.raises(StaleAdmissionPlan):
        port.install_plan(stale)


def test_edge_block_cache_equals_reference(graphs):
    jg, g = graphs
    block_e = ops.edge_block_size(int(g.degrees().max()))
    assert block_e == jops.edge_block_size(int(jg.degrees().max()))
    for policy, blocks in (("lru", 8), ("pinned", 12)):
        ref = JEdgeCache(jg, indptr=jg.indptr, block_e=block_e,
                         blocks=blocks, policy=policy)
        port = DeviceEdgeBlockCache(g, indptr=g.indptr, block_e=block_e,
                                    blocks=blocks, policy=policy,
                                    device="cpu")
        assert (port.num_blocks, port.max_block) == (ref.num_blocks,
                                                     ref.max_block)
        _same_state(port, ref)
        rng = np.random.default_rng(blocks)
        for _ in range(4):
            b = rng.integers(0, port.num_blocks, 6)
            ref.resolve(b)
            port.resolve(b)
            _same_state(port, ref)


@pytest.mark.parametrize("blocks,policy", [(5, "lru"), (6, "lru"),
                                           (10, "pinned"), (40, "lru")])
def test_edge_block_plan_splits_like_reference(graphs, blocks, policy):
    """The frontier planner's chunks (slices and block sets) equal the
    reference's, including the one-chunk fast path and the padding pair
    (0, 1) in every chunk."""
    jg, g = graphs
    block_e = 128                        # small blocks: many per frontier
    ref = JEdgeCache(jg, indptr=jg.indptr, block_e=block_e, blocks=blocks,
                     policy=policy)
    port = DeviceEdgeBlockCache(g, indptr=g.indptr, block_e=block_e,
                                blocks=blocks, policy=policy, device="cpu")
    targets = np.random.default_rng(blocks).integers(0, g.num_nodes, 60)
    want, got = ref.plan(targets), port.plan(targets)
    assert len(got) == len(want)
    if blocks < 40:
        assert len(got) > 1
    for (sg, bg), (sw, bw) in zip(got, want):
        assert sg == sw
        np.testing.assert_array_equal(bg, bw)
        assert 0 in bg and 1 in bg


def test_pad_rules_and_refusals_equal_reference():
    for n, fill in ((1, 7), (5, 3), (8, 1), (9, 0)):
        a = np.arange(n)
        np.testing.assert_array_equal(pad_pow2(a, fill), jpad_pow2(a, fill))
    rows = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(pad_pow2(rows, rows[-1]),
                                  jpad_pow2(rows, rows[-1]))
    for e, b in ((0, 128), (127, 128), (128, 128), (1000, 256), (21002, 128)):
        assert edge_pad(e, b) == jedge_pad(e, b)
        assert edge_block_count(e, b) == jblock_count(e, b)


def test_cache_construction_refusals(graphs):
    g = graphs[1]
    opt = DeviceFeatureCache(g, rows=8, policy="optimal", device="cpu")
    assert opt.stats()["policy"] == "optimal"
    with pytest.raises(ValueError, match="unknown device-cache policy"):
        DeviceFeatureCache(g, rows=8, policy="mru", device="cpu")
    with pytest.raises(ValueError, match="capacity >= 2"):
        DeviceFeatureCache(g, rows=1, policy="pinned", device="cpu")
    with pytest.raises(ValueError, match=">= 4 non-pinned"):
        DeviceEdgeBlockCache(g, indptr=g.indptr, block_e=256, blocks=6,
                             policy="pinned", device="cpu")
    dc = DeviceFeatureCache(g, rows=4, policy="lru", device="cpu")
    assert dc.table.dtype == torch.float32 and dc.slot_of.dtype == torch.int32
    assert dc.gather_rows(np.empty(0, np.int64)).shape == (0, g.feat_dim)
