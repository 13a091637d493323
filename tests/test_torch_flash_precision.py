"""The precision of the tensor-core flash kernels, emulated on the CPU.

``csrc/flash_attention.cu`` and the dQ and dK/dV kernels of
``csrc/flash_attention_bwd.cu`` take bf16 products on the tensor cores.
Their rounding points, emulated here in torch:
- the forward: scores of the bf16 inputs summed in float32, the online
  softmax over 64-key tiles in float32, P rounded to bf16 before P.V (a
  float32 sum), the row sum l taken from the float32 P, out rounded to
  bf16;
- dK/dV: S^T and dP^T of the bf16 inputs summed in float32, P^T and dS^T
  computed in float32 and rounded to bf16 before the dV and dK products
  (float32 sums), dK and dV rounded to bf16;
- dQ: S and dP likewise, P and dS in float32, dS rounded to bf16 before
  dS.K (a float32 sum), dq rounded to bf16; delta = rowsum(dO * O) of the
  bf16 inputs summed in float32 (no rounding).
The emulation is held to the plain float32 versions (``ref``) within the
tolerances ``chip_smoke.py`` phase 3 holds the kernels to on the card:
out within 2e-2 (a few bf16 ulps at |out| < 4), lse within 1e-3 (P's
rounding does not reach it), dq, dK and dV within 1 % of the largest
entry (rounding P^T, dS^T or dS to bf16 costs about 2^-9 of it, the final
bf16 rounding up to 2^-8 more), delta within 1e-4 of its largest entry.
So these tolerances hold for the rounding the design adds before any card
time is spent.  Without the bf16 rounding the emulation is the reference's
arithmetic in another order: within 1e-4.
Inputs are numpy-seeded standard normals in bf16, as phase 3 draws them.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

ATTN_OUT_TOL, LSE_TOL, GRAD_REL_TOL, DELTA_REL_TOL = 2e-2, 1e-3, 1e-2, 1e-4
F32_TOL = 1e-4
TILE = 64   # keys per tile of the forward kernel

# (B, S, Hq, Hkv, D, causal): qwen2-0.5b's heads and head dim at S 512, head
# dims 128 and 256, a full (non-causal) case and a ragged S
CASES = [(1, 512, 14, 2, 64, True), (1, 256, 4, 1, 128, True),
         (1, 256, 2, 1, 256, True), (1, 256, 14, 2, 64, False),
         (2, 200, 14, 2, 64, True)]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _inputs(B, S, Hq, Hkv, D):
    rng = np.random.default_rng(S * Hq + D)
    shapes = [(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, Hq, D)]
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(torch.bfloat16) for s in shapes]


def _scores(qf, kf, D, causal, k0=0):
    """(B, Hkv, g, S, keys) float32 scores of the grouped queries against
    keys k0 .., masked to ref.NEG_INF."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) / math.sqrt(D)
    if causal:
        qpos = torch.arange(qf.shape[1])
        kpos = torch.arange(k0, k0 + kf.shape[1])
        s = s.masked_fill(qpos[:, None] < kpos[None, :], ref.NEG_INF)
    return s


def emulate_fwd(q, k, v, *, causal, round_p=True):
    """The forward kernel's arithmetic: (out in q's dtype, lse float32)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qf = q.float().reshape(B, S, Hkv, Hq // Hkv, D)
    m = torch.full((B, Hkv, Hq // Hkv, S), ref.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, Hq // Hkv, S, D)
    for k0 in range(0, S, TILE):
        s = _scores(qf, k[:, k0:k0 + TILE].float(), D, causal, k0)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        pv = _bf16(p) if round_p else p
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", pv, v[:, k0:k0 + TILE].float())
        m = m_new
    lc = l.clamp_min(1e-30)
    out = (acc / lc[..., None]).permute(0, 3, 1, 2, 4).reshape(q.shape)
    return out.to(q.dtype), (m + torch.log(lc)).reshape(B, Hq, S)


def emulate_dkv(q, k, v, out, lse, do, *, causal, round_p=True):
    """The dK/dV kernel's arithmetic (the transposed products computed as
    their untransposed equals): (dk, dv) in k's dtype, summed over the
    group."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    grouped = (B, S, Hkv, Hq // Hkv, D)
    qf, dof = q.float().reshape(grouped), do.float().reshape(grouped)
    p = torch.exp(_scores(qf, k.float(), D, causal)
                  - lse.reshape(B, Hkv, Hq // Hkv, S, 1))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    delta = (dof * out.float().reshape(grouped)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) / math.sqrt(D)
    r = _bf16 if round_p else (lambda x: x)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", r(ds), qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", r(p), dof)
    return dk.to(k.dtype), dv.to(k.dtype)


def emulate_dq(q, k, v, out, lse, do, *, causal, round_ds=True):
    """The dQ kernel's arithmetic: (dq in q's dtype, delta (B, Hq, S)
    float32)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    grouped = (B, S, Hkv, Hq // Hkv, D)
    qf, dof = q.float().reshape(grouped), do.float().reshape(grouped)
    delta = (dof * out.float().reshape(grouped)).sum(-1)   # (B, S, Hkv, g)
    p = torch.exp(_scores(qf, k.float(), D, causal)
                  - lse.reshape(B, Hkv, Hq // Hkv, S, 1))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) / math.sqrt(D)
    r = _bf16 if round_ds else (lambda x: x)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", r(ds), k.float())
    return (dq.reshape(q.shape).to(q.dtype),
            delta.reshape(B, S, Hq).transpose(1, 2))


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", CASES)
def test_forward_rounding_within_phase3_tolerances(B, S, Hq, Hkv, D, causal):
    q, k, v, _ = _inputs(B, S, Hq, Hkv, D)
    out, lse = emulate_fwd(q, k, v, causal=causal)
    want, want_lse = ref.flash_attention_fwd(q, k, v, causal=causal)
    err = float((out.float() - want.float()).abs().max())
    lse_err = float((lse - want_lse).abs().max())
    assert err <= ATTN_OUT_TOL and lse_err <= LSE_TOL, (err, lse_err)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", CASES)
def test_dkv_rounding_within_phase3_tolerances(B, S, Hq, Hkv, D, causal):
    q, k, v, do = _inputs(B, S, Hq, Hkv, D)
    out, lse = ref.flash_attention_fwd(q, k, v, causal=causal)
    dk, dv = emulate_dkv(q, k, v, out, lse, do, causal=causal)
    want_dk, want_dv = ref.flash_attention_bwd_dkv(q, k, v, out, lse, do,
                                                   causal=causal)
    errs = _rel(dk, want_dk), _rel(dv, want_dv)
    assert max(errs) <= GRAD_REL_TOL, errs


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", CASES)
def test_emulation_without_rounding_is_the_reference(B, S, Hq, Hkv, D,
                                                     causal):
    """The emulation's structure (tiles, online softmax, transposed sums)
    is the reference's arithmetic: with P and dS kept in float32, the
    float32 results agree within F32_TOL."""
    q, k, v, do = (x.float() for x in _inputs(B, S, Hq, Hkv, D))
    out, lse = emulate_fwd(q, k, v, causal=causal, round_p=False)
    want, want_lse = ref.flash_attention_fwd(q, k, v, causal=causal)
    np.testing.assert_allclose(out.float().numpy(), want.numpy(),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    got = emulate_dkv(q, k, v, want, want_lse, do, causal=causal,
                      round_p=False)
    for g, w in zip(got, ref.flash_attention_bwd_dkv(q, k, v, want, want_lse,
                                                     do, causal=causal)):
        assert _rel(g, w) <= F32_TOL


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", CASES)
def test_dq_rounding_within_phase3_tolerances(B, S, Hq, Hkv, D, causal):
    q, k, v, do = _inputs(B, S, Hq, Hkv, D)
    out, lse = ref.flash_attention_fwd(q, k, v, causal=causal)
    dq, delta = emulate_dq(q, k, v, out, lse, do, causal=causal)
    want = ref.flash_attention_bwd_dq(q, k, v, out, lse, do, causal=causal)
    want_delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    errs = _rel(dq, want), _rel(delta, want_delta)
    assert errs[0] <= GRAD_REL_TOL and errs[1] <= DELTA_REL_TOL, errs


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", CASES)
def test_dq_emulation_without_rounding_is_the_reference(B, S, Hq, Hkv, D,
                                                        causal):
    """With dS kept in float32 the dQ emulation is the reference's float32
    arithmetic in another order: dq within F32_TOL."""
    q, k, v, do = (x.float() for x in _inputs(B, S, Hq, Hkv, D))
    out, lse = ref.flash_attention_fwd(q, k, v, causal=causal)
    dq, _ = emulate_dq(q, k, v, out, lse, do, causal=causal, round_ds=False)
    want = ref.flash_attention_bwd_dq(q, k, v, out, lse, do, causal=causal)
    assert _rel(dq, want) <= F32_TOL
