"""Host-side parts of the in-memory GNN kernels, on the CPU.

The CUDA kernels ``neighbor_sample`` and the fanout mean of
``feature_gather`` run only on the card (``chip_smoke.py`` phase 3); here
their index arithmetic and summation order, emulated in numpy as the
kernels compute them, are held against the plain versions and the
reference's Pallas kernels in interpret mode:

- the sampler: ``i // S`` by the host's ``fast_divisor`` multiplier, the
  32-bit floor-mod of ``rand`` (negative included), the position clamped
  to ``E - 1`` and degree-0 targets sampling themselves; its launch
  parameters refuse what 32-bit indexing cannot hold;
- the mean: each output row's K ids held one a lane and shuffled out (a
  run of 32 at a time), each source row read whole in segments of
  ``MEAN_LANE_FLOATS`` floats a lane, and ``acc += v / K`` in k order in
  float32, bit for bit.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rmat_graph
from repro.kernels import ref as jref
from repro.kernels.feature_gather import feature_gather_mean as gather_pl
from repro.kernels.neighbor_sample import neighbor_sample as sample_pl
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import feature_gather as fg
from repro_torch.kernels import neighbor_sample as ns
from repro_torch.kernels.neighbor_sample import fast_divisor, launch_params


def _emulate_sampler(indptr, indices, targets, rand):
    """neighbor_sample as the CUDA kernel computes it: one output per i <
    M * S, t = targets[i // S] by (i * mul) >> shift, pos = start + rand
    mod deg (C's truncating % in int32, then + deg when negative),
    clamped to E - 1, and degree-0 targets themselves."""
    M, S = rand.shape
    p = launch_params(M, S, indices.shape[0])
    mul, shift = p["fanout"]
    i = np.arange(p["total"], dtype=np.uint64)
    q = ((i * np.uint64(mul)) >> np.uint64(shift)).astype(np.int64)
    t = targets[q].astype(np.int32)
    rnd = rand.reshape(-1).astype(np.int32)
    start = indptr[t]
    deg = indptr[t + 1] - start
    live = deg > 0
    r = np.fmod(rnd, np.where(live, deg, 1)).astype(np.int32)
    r = np.where(r < 0, r + deg, r).astype(np.int32)
    pos = start + r                       # < indptr[t + 1]: no overflow
    assert pos.dtype == np.int32
    pos = np.minimum(pos, np.int32(indices.shape[0] - 1))
    picked = indices[np.where(live, pos, 0)]
    return np.where(live, picked, t).astype(np.int32).reshape(M, S)


def _check_sampler(indptr, indices, targets, rand, pallas=True):
    got = _emulate_sampler(indptr, indices, targets, rand)
    want = ref.neighbor_sample(
        *map(torch.from_numpy, (indptr, indices, targets, rand))).numpy()
    np.testing.assert_array_equal(got, want)
    oracle = jref.neighbor_sample(*map(jnp.asarray, (indptr, indices,
                                                     targets, rand)))
    np.testing.assert_array_equal(got, np.asarray(oracle))
    if pallas:
        block_e = ops.edge_block_size(int(np.diff(indptr).max()))
        kernel = sample_pl(*map(jnp.asarray, (indptr, indices, targets,
                                              rand)), block_e=block_e,
                           interpret=True)
        np.testing.assert_array_equal(got, np.asarray(kernel))
    return got


@pytest.mark.parametrize("n,e,M,S", [(256, 2048, 1, 1), (512, 4096, 113, 10),
                                     (1024, 8192, 33, 25),
                                     (300, 3000, 129, 7)])
def test_sampler_arithmetic_matches_plain_and_pallas(n, e, M, S):
    """R-MAT graphs, rand over all of int32 (negative included), output
    counts that no block size divides (1, 1130, 825, 903)."""
    g = rmat_graph(n, e, seed=n + M)
    rng = np.random.default_rng(M * S)
    targets = rng.integers(0, n, M).astype(np.int32)
    rand = rng.integers(-2**31, 2**31 - 1, (M, S)).astype(np.int32)
    rand[0, 0] = -2**31                  # the most negative draw
    _check_sampler(g.indptr.astype(np.int32), g.indices.astype(np.int32),
                   targets, rand)


def test_sampler_degree0_at_block_aligned_end_and_clamp():
    """Degree-0 targets whose offset is the end of a block-aligned edge
    array sample themselves; an edge array shorter than indptr says
    clamps the position to E - 1, in the emulation as in both
    references."""
    degs = [128, 128, 0, 0]
    indptr = np.zeros(len(degs) + 1, np.int32)
    np.cumsum(degs, out=indptr[1:])
    rng = np.random.default_rng(11)
    indices = rng.integers(0, len(degs), 256).astype(np.int32)
    targets = np.array([2, 1, 3, 0, 2], np.int32)
    rand = rng.integers(-2**31, 2**31 - 1, (5, 6)).astype(np.int32)
    got = _check_sampler(indptr, indices, targets, rand)
    assert (got[0] == 2).all() and (got[2] == 3).all()
    short = indices[:200].copy()
    got = _check_sampler(indptr, short, targets, rand, pallas=False)
    assert (got[1] == short[np.minimum(128 + np.mod(rand[1], 128), 199)]).all()


def test_launch_params_refuse_what_32_bits_cannot_index():
    """Fewer than 2**31 outputs and edges: the wrapper says so before it
    launches."""
    p = launch_params(1 << 16, (1 << 15) - 1, (1 << 31) - 1)
    assert p["total"] == (1 << 16) * ((1 << 15) - 1)
    assert p["fanout"] == fast_divisor((1 << 15) - 1)
    assert launch_params(3, 0, 5)["fanout"] == fast_divisor(1)
    with pytest.raises(ValueError, match="neighbor_sample: .*2\\*\\*31"):
        launch_params(1 << 16, 1 << 15, 10)
    with pytest.raises(ValueError, match="edges.*2\\*\\*31"):
        launch_params(10, 10, 1 << 31)


def _c_params(source: str, symbol: str) -> int:
    src = (_build.CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    assert m, symbol
    return len(m.group(1).split(","))


def test_ctypes_signatures_match_the_entry_points():
    """The wrappers' ctypes argument lists have as many entries as the C
    entry points have parameters."""
    assert _c_params("neighbor_sample.cu", "neighbor_sample_launch") == len(
        ns._ARGTYPES)
    assert _c_params("feature_gather.cu", "feature_gather_launch") == len(
        fg._ARGTYPES)


def test_mean_lane_floats_is_the_kernels():
    src = (_build.CSRC / "feature_gather.cu").read_text()
    m = re.search(r"constexpr int kMeanFloats = (\d+);", src)
    assert m and int(m.group(1)) == fg.MEAN_LANE_FLOATS


def _emulate_mean(table, ids, vec):
    """feature_gather_mean as the CUDA kernel computes it, a warp per
    output row, all rows at once: lane k holds id k of its row's run of
    32 (ids past 32 loaded a run at a time) and the walk shuffles id j
    from lane j % 32; each source row is read in segments of C =
    MEAN_LANE_FLOATS / vec vectors a lane (lane l, slot u: vector s0 + l
    + 32 u), and every float is summed as ``acc += v / K`` in k order, in
    float32."""
    M, K = ids.shape
    F = table.shape[1]
    C = fg.MEAN_LANE_FLOATS // vec
    nv = F // vec
    rows = table.reshape(table.shape[0], nv, vec)
    out = np.zeros((M, nv, vec), np.float32)
    lane = np.arange(32)
    k = np.float32(K)
    for s0 in range(0, nv, 32 * C):
        col = s0 + lane[:, None] + 32 * np.arange(C)[None, :]   # (32, C)
        live = col < nv
        acc = np.zeros((M, 32, C, vec), np.float32)
        held = None
        for j in range(K):
            if j % 32 == 0:              # a run of 32 ids, lane k holds k
                run = j
                held = np.where(lane[None, :] < K - run,
                                ids[:, np.minimum(run + lane, K - 1)], 0)
            rid = held[:, j % 32]                                # shuffle
            v = rows[rid][:, np.where(live, col, 0)]        # (M, 32, C, vec)
            acc = np.where(live[None, :, :, None], acc + v / k, acc)
        out[:, col[live]] = acc[:, live]
    return out.reshape(M, F)


@pytest.mark.parametrize("K", [0, 1, 7, 10, 25, 32, 33, 70])
@pytest.mark.parametrize("F,vec", [(602, 2), (100, 4), (7, 1), (1282, 2)])
def test_mean_emulation_bit_equal_to_plain(K, F, vec):
    """K below, at and past a run of 32 ids (the reload), F in one segment
    and in three (1,282 floats: 641 float2 vectors, 320 a segment), the
    float4 and scalar instances; column 0 of the table is -0.0, whose mean
    is +0.0."""
    rng = np.random.default_rng(K * 1000 + F)
    table = rng.standard_normal((97, F)).astype(np.float32)
    table[:, 0] = -0.0
    ids = rng.integers(0, 97, (13, K)).astype(np.int32)
    got = _emulate_mean(table, ids, vec)
    want = ref.feature_gather_mean(torch.from_numpy(table),
                                   torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got[:, 0].view(np.int32) == 0).all()


@pytest.mark.parametrize("M,K,F", [(17, 7, 602), (9, 10, 602), (5, 25, 100),
                                   (3, 33, 7)])
def test_mean_emulation_against_pallas(M, K, F):
    """Within 1e-6 of the reference's Pallas kernel in interpret mode,
    which sums the same terms (its interpret run may round a few of them
    apart by an ulp)."""
    rng = np.random.default_rng(M * K)
    table = rng.standard_normal((64, F)).astype(np.float32)
    ids = rng.integers(0, 64, (M, K)).astype(np.int32)
    got = _emulate_mean(table, ids, fg._vec_width(
        torch.from_numpy(table), torch.empty((M, F))))
    kernel = np.asarray(gather_pl(jnp.asarray(table), jnp.asarray(ids),
                                  interpret=True))
    np.testing.assert_allclose(got, kernel, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("K", [3, 10, 25])
def test_plain_mean_divides_as_before_on_the_cpu(K):
    """The plain mean divides by a 0-dim tensor (the card's ATen would
    multiply by the reciprocal of a Python scalar); on the CPU that is
    bit-equal to dividing by K."""
    rng = np.random.default_rng(K)
    table = torch.from_numpy(rng.standard_normal((50, 602)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 50, (31, K)).astype(np.int32))
    before = torch.zeros(31, 602)
    for k in range(K):
        before += table[ids[:, k].long()] / K
    got = ref.feature_gather_mean(table, ids)
    assert torch.equal(got.view(torch.int32), before.view(torch.int32))
