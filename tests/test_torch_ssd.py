"""The port's plain SSD chunked scan (``kernels.ref.ssd_chunk_scan``, the
CPU path of ``ops.ssd_chunk_scan`` and the comparison for the CUDA kernel)
against the reference: its Pallas ``ssd_chunk_scan`` in interpret mode,
its ``models.ssm.ssd_chunked`` (the Pallas kernel's oracle), the naive
per-step recurrence, and its padding dispatcher.

Inputs are numpy-seeded float32, as the reference's own sweep
(``tests/test_kernels.py``) makes them.  Tolerances: y and the final state
within rtol = atol = 1e-4, the reference's own for its kernel against
``ssd_chunked`` (both sides compute in float32 and differ in the order of
their sums); the naive recurrence within 2e-3, the reference's own
(the chunked form reassociates every product).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ssd_chunk_scan import ssd_chunk_scan as ssd_pl
from repro.models.ssm import ssd_chunked as jssd_chunked
from repro_torch import kernels
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk_scan as ssd_kernel

TOL = 1e-4
NAIVE_TOL = 2e-3
SWEEP = [(1, 32, 2, 4, 1, 8, 8), (2, 64, 4, 8, 2, 16, 16),
         (1, 128, 8, 16, 8, 32, 32), (2, 48, 2, 8, 1, 4, 16)]


def _inputs(seed, b, s, h, p, g, n, dt_scale=0.1):
    """The reference sweep's draws: x, dt = |N| * dt_scale, A = -|N|, B,
    C."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, s, h))) * dt_scale).astype(
        np.float32)
    A = -np.abs(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


def _port(args, chunk, fn=ref.ssd_chunk_scan):
    y, st = fn(*map(torch.from_numpy, args), chunk=chunk)
    return y.numpy(), st.numpy()


def _assert_close(got, want, tol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SWEEP)
def test_plain_scan_matches_pallas(b, s, h, p, g, n, chunk):
    args = _inputs(s * h, b, s, h, p, g, n)
    want = ssd_pl(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    _assert_close(_port(args, chunk), want, TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SWEEP)
def test_plain_scan_matches_ssd_chunked(b, s, h, p, g, n, chunk):
    args = _inputs(s * h + 1, b, s, h, p, g, n)
    want = jssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    _assert_close(_port(args, chunk), want, TOL)


def test_plain_scan_matches_sequential_recurrence():
    """The chunked form equals the naive per-step SSM recurrence."""
    b, s, h, p, n = 1, 24, 2, 4, 8
    x, dt, A, B, C = _inputs(3, b, s, h, p, 1, n, dt_scale=0.2)
    st = np.zeros((b, h, p, n), np.float32)
    ys = np.zeros((b, s, h, p), np.float32)
    for t in range(s):
        decay = np.exp(dt[:, t] * A[None, :])
        upd = np.einsum("bh,bn,bhp->bhpn", dt[:, t], B[:, t, 0], x[:, t])
        st = st * decay[:, :, None, None] + upd
        ys[:, t] = np.einsum("bn,bhpn->bhp", C[:, t, 0], st)
    _assert_close(_port((x, dt, A, B, C), 8), (ys, st), NAIVE_TOL)


def test_plain_scan_stays_finite_over_long_decays():
    """cs falls by ~chunk * dt * |A| within a chunk (far below the float32
    exponent's range at chunk 256): only differences with i >= j are
    exponentiated, so nothing overflows, and the result equals the
    reference's (which masks its infs with a select) within 1e-4 of the
    largest entry (dt * x grows with dt, and with it the float32 sums'
    rounding)."""
    args = list(_inputs(5, 1, 512, 2, 8, 1, 8, dt_scale=2.0))
    args[2] = args[2] * 4 - 1
    got = _port(args, 256)
    assert all(np.isfinite(a).all() for a in got)
    want = jssd_chunked(*map(jnp.asarray, args), chunk=256)
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL * np.abs(b).max())


@pytest.mark.parametrize("s,chunk", [(48, 16), (48, 32), (48, 64), (40, 256)])
def test_dispatcher_pads_like_the_reference(s, chunk):
    """``ops.ssd_chunk_scan`` cuts a chunk longer than a sequence it
    divides, and otherwise pads the sequence (dt = 0) to a chunk multiple
    and cuts y back, as the reference's dispatcher (its Pallas path in
    interpret mode)."""
    args = _inputs(s + chunk, 2, s, 4, 8, 2, 16)
    kernels.reset_launches()
    got = _port(args, chunk, fn=ops.ssd_chunk_scan)
    assert kernels.LAUNCHES["ssd_chunk_scan"] == 0
    assert got[0].shape == (2, s, 4, 8) and got[1].shape == (2, 4, 8, 16)
    want = jops.ssd_chunk_scan(*map(jnp.asarray, args), chunk=chunk)
    _assert_close(got, want, TOL)


def test_padded_steps_leave_the_state_alone():
    """dt = 0 steps (the prompt's padding) neither emit nor move the
    state: the final state of s steps padded to a chunk multiple equals
    that of the s steps scanned at a chunk that divides s."""
    x, dt, A, B, C = _inputs(7, 1, 20, 2, 4, 1, 8)
    _, st = _port((x, dt, A, B, C), 16, fn=ops.ssd_chunk_scan)
    _, want = _port((x, dt, A, B, C), 20)
    np.testing.assert_allclose(st, want, rtol=TOL, atol=TOL)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    x, dt, A, B, C = map(torch.from_numpy, _inputs(0, 1, 16, 2, 4, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_chunk_scan(x, dt, A, B, C, chunk=8)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_chunk_scan(x.double(), dt, A, B, C, chunk=8)
