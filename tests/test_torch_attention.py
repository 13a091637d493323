"""The port's attention on CPU tensors (the plain versions of the flash
forward and decode kernels, and the chunked path) against the reference's
Pallas kernels in interpret mode and its jnp path.

Inputs are numpy-seeded bf16 (float32 where the point is the algorithm).
Tolerances: both sides compute in float32 and differ only in the order of
the online-softmax sums, so a bf16 output may round one ulp apart (2e-2
absolute at |out| < 4) and the float32 logsumexp agrees within 1e-5; the
float32 chunked path within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import _flash_fwd
from repro.models.attention import mha_chunked as jmha_chunked
from repro_torch import kernels
from repro_torch.kernels import decode_attention as dec_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import decode_attention_local, mha_chunked

BF16_TOL = 2e-2
LSE_TOL = 1e-5


def _inputs(seed, *shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _bf16(a):
    """numpy float32 -> (jax bf16, torch bf16) holding the same values."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,bq,bk",
                         [(1, 64, 2, 2, 16, 32, 32),     # group 1
                          (2, 64, 4, 2, 64, 16, 32),     # group 2
                          (1, 64, 7, 1, 16, 32, 16),     # group 7
                          (1, 32, 14, 2, 64, 32, 32)])   # qwen2's heads
def test_flash_fwd_plain_matches_pallas(B, S, Hq, Hkv, D, bq, bk, causal):
    q, k, v = _inputs(S * Hq + D, (B, S, Hq, D), (B, S, Hkv, D),
                      (B, S, Hkv, D))
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    out, lse = ref.flash_attention_fwd(tq, tk, tv, causal=causal)
    jt = [jnp.swapaxes(x, 1, 2) for x in (jq, jk, jv)]
    jout, jlse = _flash_fwd(*jt, bq=bq, bk=bk, causal=causal,
                            scale=1.0 / D ** 0.5, interpret=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert out.shape == (B, S, Hq, D) and lse.shape == (B, Hq, S)
    np.testing.assert_allclose(_f32(out), _f32(jnp.swapaxes(jout, 1, 2)),
                               atol=BF16_TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _f32(jlse), atol=LSE_TOL,
                               rtol=LSE_TOL)


@pytest.mark.parametrize("S", [48, 100])
def test_flash_fwd_plain_any_length_matches_chunked(S):
    """S not a multiple of any tile: the plain forward still equals the
    reference's chunked path (one chunk) in float32."""
    q, k, v = _inputs(S, (2, S, 7, 16), (2, S, 1, 16), (2, S, 1, 16))
    out, _ = ops.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    pos = jnp.arange(S)
    want = jmha_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_positions=pos, k_positions=pos, chunk_q=S,
                        chunk_k=S)
    np.testing.assert_allclose(out.numpy(), _f32(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("valid_len,window",
                         [(1, 0), (256, 0), (200, 0), (200, 64), (256, 64),
                          (1, 16)])
@pytest.mark.parametrize("B,Hq,Hkv,D", [(2, 4, 4, 16), (2, 8, 4, 64),
                                        (1, 14, 2, 64), (2, 7, 1, 16)])
def test_decode_plain_matches_pallas(B, Hq, Hkv, D, valid_len, window):
    S = 256
    q, k, v = _inputs(Hq * D + valid_len, (B, Hq, D), (B, S, Hkv, D),
                      (B, S, Hkv, D))
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    got = ref.decode_attention(tq, tk, tv, valid_len, window)
    want = jops.decode_attention(jq, jk, jv, valid_len, window)
    assert got.dtype == torch.bfloat16 and got.shape == (B, Hq, D)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=BF16_TOL, rtol=0)


def test_decode_plain_odd_cache_length():
    """A cache length that is no block multiple (the reference pads it)."""
    q, k, v = _inputs(9, (1, 4, 32), (1, 300, 2, 32), (1, 300, 2, 32))
    got = ops.decode_attention(*map(torch.from_numpy, (q, k, v)), 300, 0)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), 300, 0)
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("S,chunk", [(32, 8), (32, 32), (48, 16)])
def test_mha_chunked_matches_reference(S, chunk, window):
    q, k, v = _inputs(S + window, (2, S, 6, 16), (2, S, 2, 16),
                      (2, S, 2, 16))
    pos = np.arange(S, dtype=np.int32)
    got = mha_chunked(*map(torch.from_numpy, (q, k, v)),
                      q_positions=torch.from_numpy(pos),
                      k_positions=torch.from_numpy(pos), window=window,
                      chunk_q=chunk, chunk_k=chunk)
    want = jmha_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_positions=jnp.asarray(pos),
                        k_positions=jnp.asarray(pos), window=window,
                        chunk_q=chunk, chunk_k=chunk)
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    q, k, v = map(torch.from_numpy, _inputs(1, (1, 16, 2, 16),
                                            (1, 16, 1, 16), (1, 16, 1, 16)))
    kernels.reset_launches()
    out = ops.flash_attention_bshd(q, k, v, causal=True)
    assert torch.equal(out, ref.flash_attention_fwd(q, k, v)[0])
    dec = decode_attention_local(q[:, 3], k, v, 4, window=2)
    assert torch.equal(dec, ref.decode_attention(q[:, 3], k, v, 4, 2))
    assert kernels.LAUNCHES["flash_attention_fwd"] == 0
    assert kernels.LAUNCHES["decode_attention"] == 0


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_head_dims():
    q = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention_fwd(q, q[:, :, :1], q[:, :, :1])
    with pytest.raises(ValueError, match="CUDA"):
        dec_kernel.decode_attention(q[:, 0], q, q, 8)
    for D in (8, 24, 272):
        with pytest.raises(ValueError, match="head dim"):
            flash_kernel.check_head_dim(D, "flash_attention_fwd")
    for D in (16, 64, 128, 256):
        flash_kernel.check_head_dim(D, "flash_attention_fwd")


@pytest.mark.parametrize("S,valid_len,window,lo,hi",
                         [(2112, 1, 0, 0, 1), (2112, 1000, 512, 488, 1000),
                          (2112, 2112, 0, 0, 2112), (100, 150, 0, 0, 100),
                          (2112, 300, 512, 0, 300)])
def test_decode_valid_range(S, valid_len, window, lo, hi):
    assert dec_kernel.valid_range(S, valid_len, window) == (lo, hi)


@pytest.mark.parametrize("n_keys", [1, 63, 64, 65, 512, 1000, 2112, 32768])
@pytest.mark.parametrize("blocks", [1, 16, 64, 1024])
def test_decode_split_plan_covers_the_keys(n_keys, blocks):
    """Whole tiles per slice, no empty slice, every key in one slice, and
    between half and all of the slices wanted for BLOCKS_PER_SM blocks
    per SM of a 132-SM card, where the keys allow that many."""
    split_len, nsplit = dec_kernel.split_plan(n_keys, blocks, 132)
    assert split_len % dec_kernel.TILE == 0
    assert (nsplit - 1) * split_len < n_keys <= nsplit * split_len
    tiles = -(-n_keys // dec_kernel.TILE)
    want = min(tiles, -(-dec_kernel.BLOCKS_PER_SM * 132 // blocks))
    assert want / 2 <= nsplit <= want


@pytest.mark.parametrize("valid_len,window", [(1, 0), (200, 0), (200, 64),
                                              (256, 300), (77, 16)])
def test_decode_on_the_valid_range_alone_is_exact(valid_len, window):
    """The kernel reads only the keys ``valid_range`` leaves: attention
    over that slice, unmasked, equals the masked attention over the whole
    cache (masked scores add exp(-1e30 - m) = 0 once any key is valid)."""
    q, k, v = map(torch.from_numpy, _inputs(valid_len, (2, 8, 32),
                                            (2, 256, 2, 32),
                                            (2, 256, 2, 32)))
    lo, hi = dec_kernel.valid_range(256, valid_len, window)
    whole = ref.decode_attention(q, k, v, valid_len, window)
    part = ref.decode_attention(q, k[:, lo:hi], v[:, lo:hi], hi - lo, 0)
    np.testing.assert_allclose(part.numpy(), whole.numpy(), atol=1e-6,
                               rtol=1e-6)


LOG2E = 1.4426950408889634


def emulate_decode(q, k, v, valid_len, window, *, round_p=True):
    """The decode kernel's arithmetic in torch: the valid keys cut by
    ``split_plan`` (for a 132-SM card) into slices of 64-key tiles; in each
    slice 4 warps own 16 keys of every tile, each with its own online max
    and sum in log2 units (masked keys past the slice give p = 0), P
    rounded to bf16 for P.V and l summed from the float32 P; the warps'
    (m, l, acc) merged into the slice's partial, the partials merged into
    out = sum acc 2^(m - M) / max(sum l 2^(m - M), 1e-30)."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    qg = q.float().reshape(B, Hkv, Hq // Hkv, D)
    kf, vf = k.float(), v.float()
    sl2 = LOG2E / D ** 0.5
    lo, hi = dec_kernel.valid_range(S, valid_len, window)
    split_len, nsplit = dec_kernel.split_plan(hi - lo, B * Hkv, 132)
    tile = dec_kernel.TILE

    def merge(parts):
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp2(m - M) for m, _, _ in parts]
        return (M, sum(l * x for (_, l, _), x in zip(parts, w)),
                sum(a * x[..., None] for (_, _, a), x in zip(parts, w)))

    slices = []
    for i in range(nsplit):
        s0 = lo + i * split_len
        s1 = min(hi, s0 + split_len)
        warps = []
        for w in range(4):
            m = torch.full(qg.shape[:-1], ref.NEG_INF)
            l = torch.zeros_like(m)
            acc = torch.zeros(qg.shape)
            for t0 in range(s0, s1, tile):
                keys = torch.arange(t0 + 16 * w, t0 + 16 * w + 16)
                ok = keys < s1
                kk = keys.clamp_max(S - 1)
                x = torch.einsum("bhgd,bshd->bhgs", qg, kf[:, kk]) * sl2
                x = x.masked_fill(~ok, ref.NEG_INF)
                m_new = torch.maximum(m, x.amax(-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(x - m_new[..., None]).masked_fill(~ok, 0.0)
                l = l * corr + p.sum(-1)
                pv = p.to(torch.bfloat16).float() if round_p else p
                acc = acc * corr[..., None] + torch.einsum(
                    "bhgs,bshd->bhgd", pv, vf[:, kk])
                m = m_new
            warps.append((m, l, acc))
        slices.append(merge(warps))
    _, l, acc = merge(slices)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Hq, D).to(q.dtype)


@pytest.mark.parametrize("valid_len,window", [(1, 0), (1, 100), (700, 0),
                                              (700, 100)])
@pytest.mark.parametrize("group", [1, 5, 7, 20])
def test_decode_kernel_emulation_matches_the_reference(group, valid_len,
                                                       window):
    """The single-launch kernel's slices, warps, bf16 P and (m, l, acc)
    combine: within BF16_TOL (chip_smoke's ATTN_OUT_TOL) of the plain
    version in bf16, and within 1e-6 in float32, where only the order of
    the sums differs."""
    B, S, Hkv, D = 2, 777, 2, 64
    q, k, v = _inputs(group * 31 + valid_len + window, (B, group * Hkv, D),
                      (B, S, Hkv, D), (B, S, Hkv, D))
    t32 = [torch.from_numpy(x) for x in (q, k, v)]
    t16 = [x.to(torch.bfloat16) for x in t32]
    got = emulate_decode(*t16, valid_len, window)
    want = ref.decode_attention(*t16, valid_len, window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=BF16_TOL, rtol=0)
    got = emulate_decode(*t32, valid_len, window, round_p=False)
    want = ref.decode_attention(*t32, valid_len, window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_decode_workspace_is_kept_per_stream_and_grown(monkeypatch):
    """The kernel's partials and tickets: one pair per (device, stream),
    reused while a launch fits, replaced by larger ones (new tickets
    zeroed) when it does not."""
    monkeypatch.setattr(dec_kernel, "_WORK", {})
    cpu = torch.device("cpu")
    work, tick = dec_kernel._workspace(cpu, 7, 100, 4)
    assert work.numel() == 100 and tick.dtype == torch.int32
    assert torch.equal(tick, torch.zeros(4, dtype=torch.int32))
    again = dec_kernel._workspace(cpu, 7, 50, 2)
    assert again[0] is work and again[1] is tick
    other = dec_kernel._workspace(cpu, 8, 50, 2)
    assert other[0] is not work and other[1] is not tick
    grown = dec_kernel._workspace(cpu, 7, 200, 16)
    assert grown[0].numel() == 200 and grown[1].numel() == 16
    assert torch.equal(grown[1], torch.zeros(16, dtype=torch.int32))
    assert dec_kernel._workspace(cpu, 7, 10, 1)[1] is grown[1]
