"""The precision of the tensor-core SSD kernel, emulated on the CPU.

``csrc/ssd_chunk_scan.cu`` takes its four products on the TF32 tensor
cores in 3xTF32: each operand v splits into hi = v rounded to TF32 (to
nearest, ties away, as ``cvt.rna.tf32.f32``) and lo = v - hi, of which the
tensor core reads the TF32 part (the low 13 bits are ignored: lo is
truncated), and a.b is hi.hi + hi.lo + lo.hi summed in float32.  Its
rounding points, emulated here in torch (products of the TF32 parts exact,
their sums in float64, everything else in float32):
- the states grid: cs = cumsum(dt * A); w = exp(min(cs_last - cs, 0)) * dt
  and x o w formed in float32 and split; the chunk's products added to the
  carried state after it is scaled by exp(cs_last), rounded once;
- the output grid: S = C.B^T rounded to float32; W = S * exp(min(cs_i -
  cs_k, 0)) where k <= i (0 elsewhere) formed in float32 and split, and
  dt x formed in float32 and split; C.prev^T rounded, scaled by
  exp(cs_i), then W.(dt x) added, rounded once.
The emulation is held to the plain float32 version (``ref``) within the
tolerance ``chip_smoke.py`` phase 3 holds the kernel to on the card (1e-4
of the largest entry of y and of the final state), over
``tests/test_torch_ssd.py``'s sweep, over bf16-valued inputs at
mamba2-370m's head shape (p 64, n 128) and hymba-1.5b's (p 64, n 16) cut to
small b and s, over phase 3's group case and its ragged cases.  With one
TF32 product instead of three (hi.hi alone) the same inputs miss 1e-4:
that is why the kernel splits.  So the tolerance holds for the rounding
the design adds before any card time is spent.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref

REL_TOL = 1e-4   # chip_smoke.py's SSD_REL_TOL

# (b, s, h, p, g, n, chunk): tests/test_torch_ssd.py's SWEEP, on its draws
SWEEP = [(1, 32, 2, 4, 1, 8, 8), (2, 64, 4, 8, 2, 16, 16),
         (1, 128, 8, 16, 8, 32, 32), (2, 48, 2, 8, 1, 4, 16)]
# mamba2-370m's and hymba-1.5b's heads (p 64; n 128 and 16) at chunk 256,
# cut to b 1, s 512 and a few heads, bf16-valued as the mixer hands them
MODEL_SHAPES = {"mamba2": (1, 512, 4, 64, 1, 128, 256),
                "hymba": (1, 512, 4, 64, 1, 16, 256)}
# chip_smoke.py phase 3's group case and its ragged cases (p, n and chunk
# not tile multiples; the second past 64 in p and n) on random float32
# inputs
RANDOM_SHAPES = {"group": (1, 512, 8, 64, 2, 64, 256),
                 "ragged": (2, 96, 6, 24, 3, 40, 32),
                 "ragged-wide": (1, 300, 4, 100, 2, 72, 100)}


def _sweep_inputs(seed, b, s, h, p, g, n, dt_scale=0.1):
    """The reference sweep's draws: x, dt = |N| * dt_scale, A = -|N|, B,
    C."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, s, h))) * dt_scale).astype(
        np.float32)
    A = -np.abs(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return [torch.from_numpy(t) for t in (x, dt, A, B, C)]


def _model_inputs(seed, b, s, h, p, g, n):
    """As the mixer hands them to the kernel: x, B and C bf16 values cast
    to float32, dt = softplus of a bf16 projection (plus the zero-init
    bias) in float32, A = -exp(A_log) = -1 (A_log's init)."""
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        t = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        return t.to(torch.bfloat16).float()

    x, B, C = bf16(b, s, h, p), bf16(b, s, g, n), bf16(b, s, g, n)
    dt = F.softplus(bf16(b, s, h))
    return [x, dt, -torch.ones(h), B, C]


def _tf32(v):
    """v rounded to TF32's 10-bit mantissa, to nearest, ties away."""
    return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(v):
    """v's TF32 part as the tensor core reads it: the low 13 bits
    dropped."""
    return (v.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _product(eq, a, b, terms):
    """einsum(eq, a, b) as the tensor cores take it, in float64: 3xTF32
    (hi.hi + hi.lo + lo.hi, lo = v - hi truncated), 1xTF32 (hi.hi) or,
    with terms 0, the float32 operands unrounded."""
    if terms == 0:
        return torch.einsum(eq, a.double(), b.double())
    ahi, bhi = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ahi.double(), bhi.double())
    if terms == 3:
        alo, blo = _tf32_truncated(a - ahi), _tf32_truncated(b - bhi)
        out = (out + torch.einsum(eq, ahi.double(), blo.double())
               + torch.einsum(eq, alo.double(), bhi.double()))
    return out


def emulate(x, dt, A, B, C, *, chunk, terms=3):
    """The kernel's arithmetic: (y (b, s, h, p), final_state (b, h, p, n))
    float32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc, rep = s // chunk, h // g
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Cc = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    cs = torch.cumsum(dtc * A, dim=2)                         # (b,nc,q,h)

    # the states grid
    w = torch.exp(torch.clamp(cs[:, :, -1:] - cs, max=0)) * dtc
    own = _product("bcqhp,bcqhn->bchpn", xc * w[..., None], Bc, terms)
    decay = torch.exp(torch.clamp(cs[:, :, -1], max=0))       # (b,nc,h)
    state = torch.zeros(b, h, p, n)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = ((state * decay[:, c, :, None, None]).double()
                 + own[:, c]).float()

    # the output grid
    S = _product("bcihn,bckhn->bcikh", Cc, Bc, terms).float()
    seg = torch.clamp(cs[:, :, :, None] - cs[:, :, None], max=0)
    lower = torch.ones(chunk, chunk, dtype=torch.bool).tril()[:, :, None]
    W = torch.where(lower, S * torch.exp(seg), torch.zeros(()))
    inter = _product("bcihn,bchpn->bcihp", Cc, torch.stack(prev, 1),
                     terms).float()
    inter = inter * torch.exp(torch.clamp(cs, max=0))[..., None]
    y = (inter.double()
         + _product("bcikh,bckhp->bcihp", W, xc * dtc[..., None], terms))
    return y.float().reshape(b, s, h, p), state


def _rel_errors(args, chunk, terms):
    """Each output's max abs error over its largest entry, emulation
    against ref."""
    got = emulate(*args, chunk=chunk, terms=terms)
    want = ref.ssd_chunk_scan(*args, chunk=chunk)
    return [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(got, want)]


def _cases():
    cases = [pytest.param(_sweep_inputs, (s * h,) + shape,
                          id=f"sweep-{'x'.join(map(str, shape))}")
             for shape in SWEEP for s, h in [shape[1:3]]]
    cases += [pytest.param(_model_inputs, (i,) + shape, id=name)
              for i, (name, shape) in enumerate(MODEL_SHAPES.items())]
    cases += [pytest.param(_sweep_inputs, (7,) + shape, id=name)
              for name, shape in RANDOM_SHAPES.items()]
    return cases


@pytest.mark.parametrize("make,shape", _cases())
def test_3xtf32_within_the_kernel_tolerance(make, shape):
    seed, *dims = shape
    args = make(seed, *dims[:6])
    errs = _rel_errors(args, dims[6], terms=3)
    assert max(errs) <= REL_TOL, errs


@pytest.mark.parametrize("make,shape", _cases())
def test_1xtf32_misses_the_tolerance(make, shape):
    """One TF32 product (operands rounded to 10 bits) is off by more than
    1e-4 of the largest entry on the same inputs."""
    seed, *dims = shape
    args = make(seed, *dims[:6])
    errs = _rel_errors(args, dims[6], terms=1)
    assert max(errs) > REL_TOL, errs


@pytest.mark.parametrize("make,shape", _cases())
def test_emulation_without_rounding_is_the_reference(make, shape):
    """The emulation's structure (the two grids, the clamped decays, the
    carried state) is the reference's arithmetic: with the operands
    unrounded it agrees within float32's rounding."""
    seed, *dims = shape
    args = make(seed, *dims[:6])
    errs = _rel_errors(args, dims[6], terms=0)
    assert max(errs) <= REL_TOL / 10, errs


def test_tf32_rounds_to_nearest_ties_away():
    """_tf32 keeps 10 mantissa bits and rounds halfway cases away from zero
    (cvt.rna); hi + truncated lo carries v within 2^-21 of itself."""
    one_ulp = 2.0 ** -10
    v = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4,
                      1 + 3 * one_ulp / 4])
    assert _tf32(v).tolist() == [1 + one_ulp, -(1 + one_ulp), 1.0,
                                 1 + one_ulp]
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    hi = _tf32(r)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    err = ((hi.double() + _tf32_truncated(r - hi).double())
           - r.double()).abs()
    assert float((err / r.double().abs()).max()) <= 2.0 ** -21
