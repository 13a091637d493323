"""The port's kernel wrappers on CPU tensors (their plain versions) against
the reference's Pallas kernels in interpret mode.

Sampled ids and gathered rows must be bit-equal.  The fanout mean agrees
within 1e-6 relative: the port and the Pallas body sum ``row / K`` in k
order, ``jnp.mean`` sums before it divides.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rmat_graph
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.feature_gather import feature_gather_cached as cached_pl
from repro.kernels.feature_gather import feature_gather_mean as gather_pl
from repro.kernels.feature_gather import feature_gather_rows as rows_pl
from repro.kernels.neighbor_sample import neighbor_sample as sample_pl
from repro.kernels.neighbor_sample import \
    neighbor_sample_cached as sample_cached_pl
from repro_torch import kernels
from repro_torch.kernels import ops, ref
from repro_torch.kernels.neighbor_sample import edge_block_count


def _block_e(indptr):
    return max(128, int(-(-int(np.diff(indptr).max()) // 128) * 128))


def _sample_both(indptr, indices, targets, rand, **pl_kw):
    """(port on CPU, reference Pallas kernel) for the same numpy inputs."""
    got = ops.neighbor_sample(torch.from_numpy(indptr.astype(np.int32)),
                              torch.from_numpy(indices),
                              torch.from_numpy(targets),
                              torch.from_numpy(rand),
                              max_degree=int(np.diff(indptr).max()))
    expect = sample_pl(jnp.asarray(indptr, jnp.int32), jnp.asarray(indices),
                       jnp.asarray(targets), jnp.asarray(rand),
                       block_e=_block_e(indptr), interpret=True, **pl_kw)
    return got.numpy(), np.asarray(expect)


@pytest.mark.parametrize("n,e,M,S", [(64, 512, 8, 4), (256, 2048, 32, 10),
                                     (1024, 8192, 16, 25)])
def test_neighbor_sample_sweep(n, e, M, S):
    g = rmat_graph(n, e, seed=n)
    rng = np.random.default_rng(0)
    targets = rng.integers(0, n, M).astype(np.int32)
    rand = rng.integers(0, 2**31 - 1, (M, S)).astype(np.int32)
    got, expect = _sample_both(g.indptr, g.indices, targets, rand)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("M,S,tile_m", [(1, 4, 8), (7, 1, 3), (8, 10, 8),
                                        (70, 4, 16)])
def test_neighbor_sample_tile_boundaries(M, S, tile_m):
    """Row counts below, at and off the reference kernel's tile size."""
    g = rmat_graph(128, 1024, seed=7)
    rng = np.random.default_rng(M * 31 + S * 7 + tile_m)
    targets = rng.integers(0, g.num_nodes, M).astype(np.int32)
    rand = rng.integers(0, 2**31 - 1, (M, S)).astype(np.int32)
    got, expect = _sample_both(g.indptr, g.indices, targets, rand,
                               tile_m=tile_m)
    np.testing.assert_array_equal(got, expect)


def test_neighbor_sample_list_spanning_two_blocks():
    """A max-degree list that straddles a 128-entry edge-block boundary."""
    degs = [100, 128, 56]              # node 1's list occupies [100, 228)
    indptr = np.zeros(len(degs) + 1, np.int64)
    np.cumsum(degs, out=indptr[1:])
    rng = np.random.default_rng(5)
    indices = rng.integers(0, len(degs), indptr[-1]).astype(np.int32)
    targets = np.array([1, 1, 0, 2, 1], np.int32)
    rand = rng.integers(0, 2**31 - 1, (5, 9)).astype(np.int32)
    got, expect = _sample_both(indptr, indices, targets, rand, tile_m=2)
    np.testing.assert_array_equal(got, expect)


def test_neighbor_sample_degree0_at_block_aligned_end():
    """A degree-0 node whose offset is the end of a block-aligned edge
    array samples itself."""
    degs = [128, 128, 0]
    indptr = np.zeros(len(degs) + 1, np.int64)
    np.cumsum(degs, out=indptr[1:])
    rng = np.random.default_rng(11)
    indices = rng.integers(0, len(degs), indptr[-1]).astype(np.int32)
    targets = np.array([2, 1, 2, 0], np.int32)
    rand = rng.integers(0, 2**31 - 1, (4, 6)).astype(np.int32)
    got, expect = _sample_both(indptr, indices, targets, rand, tile_m=4)
    np.testing.assert_array_equal(got, expect)
    assert (got[0] == 2).all()


def test_neighbor_sample_negative_rand_is_floor_mod():
    """``rand % deg`` is a floor-mod, as jnp takes it."""
    g = rmat_graph(64, 512, seed=3)
    rng = np.random.default_rng(2)
    targets = rng.integers(0, 64, 12).astype(np.int32)
    rand = rng.integers(-2**31, 2**31 - 1, (12, 5)).astype(np.int32)
    got = ref.neighbor_sample(torch.from_numpy(g.indptr.astype(np.int32)),
                              torch.from_numpy(g.indices),
                              torch.from_numpy(targets),
                              torch.from_numpy(rand))
    expect = jref.neighbor_sample(jnp.asarray(g.indptr, jnp.int32),
                                  jnp.asarray(g.indices),
                                  jnp.asarray(targets), jnp.asarray(rand))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feature_gather_rows_single_call_nd(dtype):
    """n-d hop tensors in one call, bit-equal to the reference kernel."""
    rng = np.random.default_rng(3)
    table = rng.standard_normal((50, 17)).astype(np.float32)
    ids = rng.integers(0, 50, (7, 3, 2)).astype(np.int32)
    got = ops.feature_gather_rows(
        torch.from_numpy(table).to(getattr(torch, dtype)),
        torch.from_numpy(ids))
    expect = jops.feature_gather_rows(
        jnp.asarray(table, getattr(jnp, dtype)), jnp.asarray(ids))
    assert tuple(got.shape) == (7, 3, 2, 17)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(expect, np.float32))


@pytest.mark.parametrize("R", [1, 63, 130])
def test_feature_gather_rows_matches_pallas(R):
    rng = np.random.default_rng(R)
    table = rng.standard_normal((96, 602)).astype(np.float32)
    ids = rng.integers(0, 96, R).astype(np.int32)
    got = ops.feature_gather_rows(torch.from_numpy(table),
                                  torch.from_numpy(ids))
    expect = rows_pl(jnp.asarray(table), jnp.asarray(ids), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("M,K,F,N", [(8, 4, 32, 64), (16, 10, 128, 256),
                                     (1, 1, 8, 8), (32, 25, 602, 300)])
def test_feature_gather_mean_sweep(M, K, F, N):
    rng = np.random.default_rng(M * K)
    table = rng.standard_normal((N, F)).astype(np.float32)
    ids = rng.integers(0, N, (M, K)).astype(np.int32)
    got = ops.feature_gather_mean(torch.from_numpy(table),
                                  torch.from_numpy(ids)).numpy()
    kernel = np.asarray(gather_pl(jnp.asarray(table), jnp.asarray(ids),
                                  interpret=True))
    mean = np.asarray(jref.feature_gather_mean(jnp.asarray(table),
                                               jnp.asarray(ids)))
    for expect in (kernel, mean):
        np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-6)


def test_cpu_path_counts_no_launch_and_kernels_refuse_cpu_tensors():
    """The plain CPU path launches nothing; the CUDA wrappers take CUDA
    tensors only and say so."""
    from repro_torch.kernels.feature_gather import feature_gather_rows
    from repro_torch.kernels.neighbor_sample import neighbor_sample
    kernels.reset_launches()
    table = torch.zeros(4, 6)
    ids = torch.tensor([0, 3], dtype=torch.int32)
    ops.feature_gather_rows(table, ids)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        feature_gather_rows(table, ids)
    i32 = torch.zeros(3, dtype=torch.int32)
    rand = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        neighbor_sample(i32, i32, i32[:2], rand)
    from repro_torch.kernels.feature_gather import feature_gather_cached
    from repro_torch.kernels.neighbor_sample import neighbor_sample_cached
    with pytest.raises(ValueError, match="CUDA"):
        feature_gather_cached(table, i32, ids)
    with pytest.raises(ValueError, match="CUDA"):
        neighbor_sample_cached(i32, i32, i32[:2], rand,
                               torch.zeros((2, 4), dtype=torch.int32),
                               block_e=4, max_block=0)


def test_kernel_modules_import_without_triton_or_nvcc():
    """Importing every kernel module builds nothing and needs neither
    ``triton`` nor ``nvcc``."""
    import importlib
    for mod in ("ops", "_build", "neighbor_sample", "feature_gather", "ref"):
        importlib.import_module(f"repro_torch.kernels.{mod}")
    from repro_torch.kernels import _build
    assert "triton" not in sys.modules
    assert not _build._FUNCS


# ---------------------------------------------------------------------------
# the cached kernels: reads through a device cache's slot table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,C,F", [(1, 4, 8), (13, 16, 602), (70, 32, 33)])
def test_feature_gather_cached_matches_pallas(R, C, F):
    """Rows at permuted slots, an unresolved id (slot -1) among them that
    reads slot 0, as both the Pallas kernel and its jnp oracle clamp."""
    rng = np.random.default_rng(R * C)
    N = 3 * C
    cache = rng.standard_normal((C, F)).astype(np.float32)
    slot_of = np.full(N + 1, -1, np.int32)
    resident = rng.choice(N, C, replace=False)
    slot_of[resident] = rng.permutation(C)
    ids = rng.choice(resident, R).astype(np.int32)
    ids[R // 2] = np.flatnonzero(slot_of[:N] < 0)[0]       # unresolved
    got = ops.feature_gather_cached(torch.from_numpy(cache),
                                    torch.from_numpy(slot_of),
                                    torch.from_numpy(ids))
    for expect in (cached_pl(jnp.asarray(cache), jnp.asarray(slot_of),
                             jnp.asarray(ids), interpret=True),
                   jref.feature_gather_cached(jnp.asarray(cache),
                                              jnp.asarray(slot_of),
                                              jnp.asarray(ids))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    np.testing.assert_array_equal(got.numpy()[R // 2], cache[0])


def test_feature_gather_cached_ops_wrapper_shapes():
    cache = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    slot_of = torch.tensor([2, 0, 1, -1], dtype=torch.int32)
    ids = torch.tensor([[0, 1], [2, 0]], dtype=torch.int32)
    got = ops.feature_gather_cached(cache, slot_of, ids)
    assert tuple(got.shape) == (2, 2, 4)
    np.testing.assert_array_equal(got[0, 0].numpy(), cache[2].numpy())
    empty = ops.feature_gather_cached(cache, slot_of,
                                      torch.zeros((2, 0), dtype=torch.int32))
    assert tuple(empty.shape) == (2, 0, 4) and empty.dtype == torch.float32
    kernels.reset_launches()
    ops.feature_gather_cached(cache, slot_of, ids)
    assert kernels.LAUNCHES["feature_gather_cached"] == 0     # plain path


def _block_cache(indptr, indices, block_e, rng, drop=()):
    """Every block of the padded edge array resident at a permuted slot of
    a cache with spare capacity; the blocks in ``drop`` left at -1."""
    nb = edge_block_count(indices.shape[0], block_e)
    padded = np.zeros(nb * block_e, np.int32)
    padded[:indices.shape[0]] = indices
    C = nb + 3
    slots = rng.permutation(C)[:nb].astype(np.int32)
    cache = rng.integers(-9, 0, (C, block_e)).astype(np.int32)   # spare
    cache[slots] = padded.reshape(nb, block_e)
    block_slots = np.full(nb + 1, -1, np.int32)
    block_slots[:nb] = slots
    block_slots[list(drop)] = -1
    return cache, block_slots, nb - 2


def _sample_cached_both(indptr, indices, targets, rand, block_e, drop=(),
                        seed=0):
    rng = np.random.default_rng(seed)
    cache, block_slots, max_block = _block_cache(indptr, indices, block_e,
                                                 rng, drop)
    ip32 = indptr.astype(np.int32)
    got = ops.neighbor_sample_cached(
        torch.from_numpy(ip32), torch.from_numpy(cache),
        torch.from_numpy(block_slots), torch.from_numpy(targets),
        torch.from_numpy(rand), block_e=block_e, max_block=max_block)
    args = (jnp.asarray(ip32), jnp.asarray(block_slots), jnp.asarray(targets),
            jnp.asarray(rand), jnp.asarray(cache))
    kernel = sample_cached_pl(*args, block_e=block_e, max_block=max_block,
                              tile_m=4, interpret=True)
    oracle = jref.neighbor_sample_cached(*args, block_e=block_e,
                                         max_block=max_block)
    return got.numpy(), np.asarray(kernel), np.asarray(oracle)


@pytest.mark.parametrize("n,e,M,S", [(64, 512, 8, 4), (256, 2048, 37, 10),
                                     (1024, 8192, 16, 25)])
def test_neighbor_sample_cached_matches_pallas(n, e, M, S):
    """Ids through the block cache equal the Pallas cached kernel, its jnp
    oracle and the uncached kernel's."""
    g = rmat_graph(n, e, seed=n + 1)
    rng = np.random.default_rng(n)
    targets = rng.integers(0, n, M).astype(np.int32)
    rand = rng.integers(0, 2**31 - 1, (M, S)).astype(np.int32)
    block_e = _block_e(g.indptr)
    got, kernel, oracle = _sample_cached_both(g.indptr, g.indices, targets,
                                              rand, block_e, seed=M)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, kernel)
    np.testing.assert_array_equal(got, oracle)
    uncached, _ = _sample_both(g.indptr, g.indices, targets, rand)
    np.testing.assert_array_equal(got, uncached)


def test_neighbor_sample_cached_degree0_tail_and_unresolved_slot():
    """A degree-0 target at the end of a block-aligned edge array (its
    base block clamped to ``max_block``) samples itself; a list inside one
    block never reads its unresolved (-1) neighbour block; a target whose
    own block is unresolved reads slot 0, as the kernels clamp it."""
    degs = [100, 128, 28, 0, 0]         # lists end at 256 = 2 blocks
    indptr = np.zeros(len(degs) + 1, np.int64)
    np.cumsum(degs, out=indptr[1:])
    rng = np.random.default_rng(11)
    indices = rng.integers(0, len(degs), indptr[-1]).astype(np.int32)
    targets = np.array([4, 2, 3, 0, 1, 4], np.int32)
    rand = rng.integers(0, 2**31 - 1, (6, 7)).astype(np.int32)
    block_e = 128
    nb = edge_block_count(indices.shape[0], block_e)
    assert 256 // block_e > nb - 2      # nodes 3, 4: base block clamped
    # the last block holds no edge and no sampled entry reads it
    got, kernel, oracle = _sample_cached_both(indptr, indices, targets, rand,
                                              block_e, drop=(nb - 1,))
    np.testing.assert_array_equal(got, kernel)
    np.testing.assert_array_equal(got, oracle)
    assert (got[0] == 4).all() and (got[2] == 3).all()
    uncached, _ = _sample_both(indptr, indices, targets, rand)
    np.testing.assert_array_equal(got, uncached)
    # the lists of nodes 1 and 2 reach into block 1; with block 1
    # unresolved both packages read slot 0 in its place
    got, kernel, oracle = _sample_cached_both(indptr, indices, targets, rand,
                                              block_e, drop=(1,))
    np.testing.assert_array_equal(got, kernel)
    np.testing.assert_array_equal(got, oracle)


def test_neighbor_sample_cached_empty_frontier():
    z = torch.zeros(0, dtype=torch.int32)
    out = ops.neighbor_sample_cached(
        torch.tensor([0, 1], dtype=torch.int32),
        torch.zeros((2, 128), dtype=torch.int32),
        torch.tensor([0, 1, -1], dtype=torch.int32), z,
        torch.zeros((0, 5), dtype=torch.int32), block_e=128, max_block=0)
    assert tuple(out.shape) == (0, 5) and out.dtype == torch.int32
