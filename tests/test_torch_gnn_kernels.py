"""Host-side parts of the cached GNN kernels' wrappers, on the CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` phase
3); what they take from the host is checked here: the multipliers that
replace the sampler's divisions (exhaustively over the ranges the kernel
uses), the choice between its shared-memory and global slot-table
instances, the argument checks at unpadded lengths, and the gather's
vector width.  The kernel's index arithmetic, emulated in numpy with those
multipliers, equals the plain version and the reference's oracle.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rmat_graph
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.feature_gather import _vec_width
from repro_torch.kernels.neighbor_sample import (SLOT_BUDGET,
                                                 cached_launch_params,
                                                 check_cached_args,
                                                 edge_block_count,
                                                 fast_divisor)

LIMIT = 1 << 31          # every numerator of the kernel lies below this


def _div(n, d):
    """The kernel's quotient: (n * mul) >> shift in 64 bits."""
    mul, shift = fast_divisor(d)
    assert 0 < mul < 1 << 32 and shift < 64
    return (np.asarray(n, np.uint64) * np.uint64(mul)) >> np.uint64(shift)


def _check_div(n, d):
    n = np.asarray(n, np.int64)
    q = _div(n, d).astype(np.int64)
    np.testing.assert_array_equal(q, n // d)
    np.testing.assert_array_equal(n - q * d, n % d)


def _top_and_multiples(d, rng):
    """Numerators where a quotient changes, near the top of the range,
    and a random sample of it."""
    q = np.arange(max(LIMIT // d - 4096, 0), LIMIT // d + 1, dtype=np.int64)
    edges = np.concatenate([q * d - 1, q * d, q * d + d - 1])
    top = np.arange(LIMIT - 4096, LIMIT, dtype=np.int64)
    n = np.concatenate([edges, top, rng.integers(0, LIMIT, 4096)])
    return n[(n >= 0) & (n < LIMIT)]


@pytest.mark.parametrize("fanouts", [range(1, 17), range(17, 33),
                                     range(33, 49), range(49, 65)])
def test_fanout_divisor_exact(fanouts):
    """i // S and i % S for every fanout up to 64: every output index
    below 2**17, and the top of the range and every quotient step near it
    (the kernel's i < M * S < 2**31)."""
    rng = np.random.default_rng(0)
    low = np.arange(1 << 17, dtype=np.int64)
    for S in fanouts:
        _check_div(low, S)
        _check_div(_top_and_multiples(S, rng), S)


def test_block_divisor_exact_below_two_blocks():
    """pos // block_e and pos % block_e for every block width that
    ``edge_block_size`` yields up to 2**16, over every numerator below 2 *
    block_e (the reference's pair of blocks)."""
    widths = sorted({ops.edge_block_size(deg) for deg in range(1, 1 << 16)})
    assert widths[0] == 128 and widths[-1] == 1 << 16 and len(widths) == 512
    for block_e in widths:
        _check_div(np.arange(2 * block_e, dtype=np.int64), block_e)


@pytest.mark.parametrize("block_e", [128, 1280, 38016, 1 << 16])
def test_block_divisor_exact_up_to_the_edge_array(block_e):
    """The kernel divides the absolute position pos = start + r < E <
    2**31: the top of that range and the quotient steps near it."""
    _check_div(_top_and_multiples(block_e, np.random.default_rng(block_e)),
               block_e)


def test_fast_divisor_refuses_what_it_cannot_divide():
    for d in (0, -3, LIMIT):
        with pytest.raises(ValueError, match="divisor"):
            fast_divisor(d)
    assert fast_divisor(1) == (1 << 31, 31)       # n * 2**31 >> 31 == n


def test_slot_table_instance_at_the_budget_edge():
    """Up to SLOT_BUDGET entries the table is staged in shared memory;
    one more and the kernel reads it from global memory.  The kernel's
    kSlotBudget is the same number."""
    assert cached_launch_params(113, 10, SLOT_BUDGET, 1280)["staged"]
    assert cached_launch_params(1, 1, SLOT_BUDGET - 1, 128)["staged"]
    assert not cached_launch_params(113, 10, SLOT_BUDGET + 1, 1280)["staged"]
    src = (_build.CSRC / "neighbor_sample.cu").read_text()
    m = re.search(r"constexpr int64_t kSlotBudget = (\d+);", src)
    assert m and int(m.group(1)) == SLOT_BUDGET


@pytest.mark.parametrize("M", [1, 3, 113])
def test_launch_params_and_checks_at_unpadded_lengths(M):
    """Any number of targets goes through unpadded: the checks take M =
    1, 3 and 113 with one rand row each, and refuse a rand of another
    length, a cache of another width and a strided rand."""
    S, block_e = 10, 128
    i32 = dict(dtype=torch.int32)
    args = dict(indptr=torch.zeros(6, **i32), block_slots=torch.zeros(4, **i32),
                targets=torch.zeros(M, **i32), rand=torch.zeros((M, S), **i32),
                cache=torch.zeros((2, block_e), **i32))
    check_cached_args(*args.values(), block_e=block_e, max_block=1)
    p = cached_launch_params(M, S, 4, block_e)
    assert p["total"] == M * S and p["staged"]
    assert p["fanout"] == fast_divisor(S)
    assert p["block_e"] == fast_divisor(block_e)
    bad = [dict(args, rand=torch.zeros((M + 1, S), **i32)),
           dict(args, cache=torch.zeros((2, 2 * block_e), **i32)),
           dict(args, rand=torch.zeros((M, 2 * S), **i32)[:, ::2]),
           dict(args, targets=torch.zeros(M, dtype=torch.int64))]
    for b in bad:
        with pytest.raises(ValueError, match="neighbor_sample_cached"):
            check_cached_args(*b.values(), block_e=block_e, max_block=1)
    with pytest.raises(ValueError, match="max_block"):
        check_cached_args(*args.values(), block_e=block_e, max_block=3)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        cached_launch_params(1 << 16, 1 << 15, 4, block_e)


def _emulate_cached_kernel(indptr, block_slots, targets, rand, cache,
                           block_e, staged):
    """neighbor_sample_cached as the CUDA kernel computes it: one output
    per i, t = targets[i // S], pos = start + rand mod deg (32-bit floor
    mod), block pos // block_e and offset pos % block_e by the host's
    multipliers, slot -1 read as slot 0, degree-0 targets themselves; the
    staged instance reads a copy of the slot table."""
    M, S = rand.shape
    p = cached_launch_params(M, S, block_slots.shape[0], block_e)
    assert p["staged"] == staged
    i = np.arange(p["total"], dtype=np.int64)
    t = targets[_div(i, S).astype(np.int64)].astype(np.int64)
    start = indptr[t].astype(np.int64)
    deg = indptr[t + 1].astype(np.int64) - start
    rnd = rand.reshape(-1).astype(np.int64)
    r = np.fmod(rnd, np.maximum(deg, 1))                # C's %, then +deg
    r = np.where(r < 0, r + deg, r)
    pos = start + r
    blk = _div(np.where(deg > 0, pos, 0), block_e).astype(np.int64)
    off = pos - blk * block_e
    table = block_slots.copy() if staged else block_slots
    slot = np.maximum(table[np.where(deg > 0, blk, 0)], 0)
    picked = cache.reshape(-1)[np.where(deg > 0, slot * block_e + off, 0)]
    return np.where(deg > 0, picked, t).astype(np.int32).reshape(M, S)


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("M,S", [(1, 1), (3, 25), (113, 10)])
def test_kernel_index_arithmetic_equals_the_plain_version(M, S, staged):
    """The kernel's arithmetic (pos // block_e, no max_block) picks the
    entry the reference's pair-of-blocks rule picks, on an R-MAT graph
    with every block at a permuted slot, negative rand included, with a
    table padded past the budget for the global instance."""
    g = rmat_graph(512, 4096, seed=M)
    rng = np.random.default_rng(M * S)
    indptr = g.indptr.astype(np.int32)
    block_e = ops.edge_block_size(int(np.diff(g.indptr).max()))
    nb = edge_block_count(g.indices.shape[0], block_e)
    padded = np.zeros(nb * block_e, np.int32)
    padded[:g.indices.shape[0]] = g.indices
    slots = rng.permutation(nb).astype(np.int32)
    cache = np.zeros((nb, block_e), np.int32)
    cache[slots] = padded.reshape(nb, block_e)
    block_slots = np.full(nb + 1 if staged else SLOT_BUDGET + 1, -1, np.int32)
    block_slots[:nb] = slots
    targets = rng.integers(0, 512, M).astype(np.int32)
    rand = rng.integers(-2**31, 2**31 - 1, (M, S)).astype(np.int32)
    got = _emulate_cached_kernel(indptr, block_slots, targets, rand, cache,
                                 block_e, staged)
    want = ref.neighbor_sample_cached(
        *map(torch.from_numpy, (indptr, block_slots, targets, rand, cache)),
        block_e=block_e, max_block=nb - 2).numpy()
    oracle = jref.neighbor_sample_cached(
        *map(jnp.asarray, (indptr, block_slots, targets, rand, cache)),
        block_e=block_e, max_block=nb - 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(oracle))


def test_kernel_index_arithmetic_degree0_tail_and_unresolved_slot():
    """Degree-0 targets at a block-aligned end (their base block clamped
    by the reference) sample themselves, and an unresolved block reads
    slot 0, in the emulation as in the plain version."""
    degs = [100, 128, 28, 0, 0]
    indptr = np.zeros(len(degs) + 1, np.int32)
    np.cumsum(degs, out=indptr[1:])
    rng = np.random.default_rng(11)
    block_e, nb = 128, edge_block_count(256, 128)
    cache = rng.integers(0, 5, (nb, block_e)).astype(np.int32)
    block_slots = np.append(rng.permutation(nb), -1).astype(np.int32)
    block_slots[1] = -1
    targets = np.array([4, 2, 3, 0, 1, 4], np.int32)
    rand = rng.integers(-2**31, 2**31 - 1, (6, 7)).astype(np.int32)
    got = _emulate_cached_kernel(indptr, block_slots, targets, rand, cache,
                                 block_e, True)
    want = ref.neighbor_sample_cached(
        *map(torch.from_numpy, (indptr, block_slots, targets, rand, cache)),
        block_e=block_e, max_block=nb - 2).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 4).all() and (got[2] == 3).all()


@pytest.mark.parametrize("F,vec", [(602, 2), (100, 4), (7, 1), (8, 4)])
def test_gather_vector_width(F, vec):
    """The gather's instance: the widest vector dividing F with both base
    pointers aligned to it (float2 for reddit's 602 features); a base
    pointer 4 bytes off its alignment takes the scalar instance."""
    cache = torch.zeros((4, F))
    out = torch.zeros((3, F))
    assert _vec_width(cache, out) == vec
    shifted = torch.zeros(4 * F + 1)[1:].view(4, F)
    assert _vec_width(shifted, out) == 1
