"""The port's flash-attention backward on CPU tensors: the plain version of
the dQ and dK/dV kernels against the reference's Pallas ``_flash_bwd`` in
interpret mode, and ``ops.FlashAttention`` against autograd of the plain
forward.

Inputs are numpy-seeded.  Tolerances: in float32 both sides compute the
same recompute and differ only in the order of their sums (the port sums
dk and dv over the group inside one product, the reference per query head
and then over the group), within 1e-4 as the reference's own gradient
test (``tests/test_kernels.py``) holds its kernels to autodiff; bf16
outputs within one bf16 ulp of the largest entry (1 %: two roundings of
the same float32 value to bf16 differ by at most one ulp, 2**-7 of it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _flash_bwd, _flash_fwd
from repro_torch import kernels
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import ops, ref

F32_TOL = 1e-4
BF16_REL_TOL = 1e-2


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _swap(x):
    """(B, S, H, D) <-> (B, H, S, D)."""
    return jnp.swapaxes(x, 1, 2)


def _pallas_bwd(q, k, v, do, *, bq, bk, causal, dtype):
    """The reference's forward then ``_flash_bwd`` in interpret mode, on
    (B, S, H, D) numpy arrays cast to ``dtype``; returns (out, lse, dq,
    dk, dv) as numpy float32, out and the gradients in (B, S, H, D)."""
    jq, jk, jv, jdo = (_swap(jnp.asarray(x, dtype)) for x in (q, k, v, do))
    scale = 1.0 / q.shape[-1] ** 0.5
    out, lse = _flash_fwd(jq, jk, jv, bq=bq, bk=bk, causal=causal,
                          scale=scale, interpret=True)
    dq, dk, dv = _flash_bwd(jq, jk, jv, out, lse, jdo, bq=bq, bk=bk,
                            causal=causal, scale=scale, interpret=True)
    return [np.array(x, np.float32) for x in
            (_swap(out), lse, _swap(dq), _swap(dk), _swap(dv))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,bq,bk",
                         [(1, 64, 2, 2, 16, 32, 32),     # group 1
                          (2, 64, 4, 2, 32, 16, 32),     # group 2
                          (1, 32, 7, 1, 16, 16, 16)])    # group 7
def test_flash_bwd_plain_matches_pallas(B, S, Hq, Hkv, D, bq, bk, causal,
                                        dtype):
    q, k, v, do = _inputs(S * Hq + D, (B, S, Hq, D), (B, S, Hkv, D),
                          (B, S, Hkv, D), (B, S, Hq, D))
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    out, lse, *want = _pallas_bwd(q, k, v, do, bq=bq, bk=bk, causal=causal,
                                  dtype=jdtype)
    # the same forward residuals, as the reference's backward takes them
    args = [torch.from_numpy(x).to(tdtype) for x in (q, k, v, out)]
    got = ref.flash_attention_bwd(*args, torch.from_numpy(lse),
                                  torch.from_numpy(do).to(tdtype),
                                  causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdtype and g.shape == w.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=name)
        else:
            np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                       atol=BF16_REL_TOL * np.abs(w).max(),
                                       err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [48, 100])
def test_flash_bwd_plain_any_length_matches_autograd(S, causal):
    """S that divides no Pallas block: the plain backward (and its dq and
    dk/dv halves) against autograd of the port's plain forward, float32."""
    q, k, v, do = map(torch.from_numpy, _inputs(S, (2, S, 7, 16),
                                                (2, S, 1, 16), (2, S, 1, 16),
                                                (2, S, 7, 16)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = ref.flash_attention_fwd(*leaves, causal=causal)
    want = torch.autograd.grad(out, leaves, do)
    res = (q, k, v, out.detach(), lse.detach(), do)
    got = ref.flash_attention_bwd(*res, causal=causal)
    halves = (ref.flash_attention_bwd_dq(*res, causal=causal),
              *ref.flash_attention_bwd_dkv(*res, causal=causal))
    for g, h, w in zip(got, halves, want):
        assert torch.equal(g, h)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_on_cpu_gives_plain_gradients(causal):
    """``FlashAttention`` on CPU tensors: the plain forward's output and
    autograd's gradients through it, with no kernel launch counted."""
    q, k, v, w = map(torch.from_numpy, _inputs(3, (2, 40, 4, 16),
                                               (2, 40, 2, 16), (2, 40, 2, 16),
                                               (2, 40, 4, 16)))
    a = [x.clone().requires_grad_() for x in (q, k, v)]
    b = [x.clone().requires_grad_() for x in (q, k, v)]
    kernels.reset_launches()
    out = ops.flash_attention_bshd(*a, causal=causal)
    got = torch.autograd.grad((out * w).sin().sum(), a)
    plain = ref.flash_attention_fwd(*b, causal=causal)[0]
    want = torch.autograd.grad((plain * w).sin().sum(), b)
    assert torch.equal(out, plain)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), x.numpy(), rtol=F32_TOL,
                                   atol=F32_TOL)
    assert all(kernels.LAUNCHES[n] == 0 for n in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv"))


def test_flash_function_under_no_grad_is_the_forward():
    q, k, v = map(torch.from_numpy, _inputs(4, (1, 16, 2, 16),
                                            (1, 16, 1, 16), (1, 16, 1, 16)))
    with torch.no_grad():
        out = ops.flash_attention_bshd(q, k, v)
    assert torch.equal(out, ref.flash_attention_fwd(q, k, v)[0])


def test_bwd_wrappers_refuse_cpu_tensors_and_bad_head_dims():
    x = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    kv = x[:, :, :1]
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention_bwd_dq(x, kv, kv, x, lse, x)
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention_bwd_dkv(x, kv, kv, x, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention_bwd(x, kv, kv, x, lse, x)
    for D in (8, 24, 272):
        with pytest.raises(ValueError, match="head dim"):
            flash_kernel.check_head_dim(D, "flash_attention_bwd_dq")


@pytest.mark.parametrize("shape,strides,copied",
                         [((1, 8, 2, 16), None, False),
                          ((1, 8, 2, 16), (0, 0, 0, 1), False),
                          ((1, 2, 8, 16), "transposed", False),
                          ((1, 8, 2, 16), (0, 0, 16, 0), True)])
def test_incoming_gradient_rows_aligned(shape, strides, copied):
    """dO is passed as it is when its rows are 16-byte aligned (an
    expanded or head-major gradient too) and copied otherwise."""
    x = torch.zeros(shape, dtype=torch.bfloat16)
    if strides == "transposed":
        x = x.transpose(1, 2)
    elif strides is not None:
        x = torch.as_strided(x, x.shape, strides)
    got = flash_kernel._rows_aligned(x)
    assert (got is not x) == copied
    assert got.shape == x.shape and torch.equal(got, x)
