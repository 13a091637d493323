"""The port's M-RoPE (``repro_torch.models.layers.apply_mrope``) against the
reference's ``repro.models.layers.apply_mrope``, on the CPU.

Inputs are drawn from seeded numpy generators.  Both rotate float32 halves
by float32 angles (each frequency's position taken from its section's row)
and cast back; ``sin`` and ``cos`` of the same float32 angles round apart
by an ulp between XLA and PyTorch, so float32 outputs (|x| < 5, positions
below 4096) agree within 1e-6 relative to the largest entry and bf16
outputs within one bf16 ulp of it.  With the three rows equal, as the LM
passes them, the result equals the port's ``apply_rope`` bit for bit (the
same float32 products).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import apply_mrope as japply_mrope
from repro_torch.models.layers import apply_mrope, apply_rope

F32_TOL = 1e-6       # of the largest |entry|
BF16_TOL = 2 ** -7   # one bf16 ulp of the largest |entry|

# (sections, batch, seq, heads): the reduced config's and qwen2-vl-7b's
CASES = [((2, 3, 3), 2, 16, 4), ((16, 24, 24), 2, 64, 3)]


def _inputs(sections, B, S, H, seed, distinct=True):
    rng = np.random.default_rng(seed)
    D = 2 * sum(sections)
    x = rng.normal(size=(B, S, H, D)).astype(np.float32)
    if distinct:
        # (t, h, w) rows as a vision frontend lays out a patch grid: time
        # steps, rows and columns of different ranges
        pos3 = np.stack([rng.integers(0, 4096, (B, S)),
                         rng.integers(0, 64, (B, S)),
                         rng.integers(0, 64, (B, S))]).astype(np.int32)
    else:
        pos3 = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S))
    return x, np.ascontiguousarray(pos3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sections,B,S,H", CASES)
def test_mrope_matches_the_reference(sections, B, S, H, dtype):
    x, pos3 = _inputs(sections, B, S, H, seed=len(sections) + S)
    want = np.asarray(japply_mrope(jnp.asarray(x, getattr(jnp, dtype)),
                                   jnp.asarray(pos3), sections, 1e6),
                      np.float32)
    got = apply_mrope(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(pos3), sections, 1e6)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sections,B,S,H", CASES)
def test_equal_rows_are_rope_bit_for_bit(sections, B, S, H, dtype):
    x, pos3 = _inputs(sections, B, S, H, seed=7, distinct=False)
    x = torch.from_numpy(x).to(dtype)
    pos3 = torch.from_numpy(pos3)
    got = apply_mrope(x, pos3, sections, 1e6)
    assert torch.equal(got, apply_rope(x, pos3[0], 1e6))


def test_sections_must_cover_half_the_head():
    with pytest.raises(ValueError, match="sum to"):
        apply_mrope(torch.zeros(1, 2, 1, 16), torch.zeros(3, 1, 2,
                                                          dtype=torch.int32),
                    (2, 3, 2))
