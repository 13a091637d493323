"""The Mamba-2 (SSD) mixer: parameters, the prefill path and the one-token
decode step.

The port of the reference's ``repro/models/ssm.py`` with its dtypes: the
projections and the depthwise causal conv in the activations' bf16 (the
conv as the same sum over ``d_conv`` shifted products, in the same order),
``dt``, ``A``, the scan and ``D`` in float32, the prefill's final state
cast to bf16 for the cache and the decode step's new state computed in
float32 and stored as bf16.  The prefill's scan goes through
``kernels.ops.ssd_chunk_scan``: on a CUDA tensor the hand-written SSD
kernel, on a CPU tensor its plain version ``ssd_chunked`` (the
reference's oracle, which its Pallas kernel is held to).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunk_scan as ssd_chunked
from repro_torch.models.params import ParamDef

__all__ = ["ssm_defs", "ssd_chunked", "ssm_scan_inputs", "apply_ssm",
           "apply_ssm_decode"]


def ssm_defs(d_model: int, d_inner: int, n_heads: int, d_state: int,
             d_conv: int, layers: int, n_groups: int = 1):
    conv_dim = d_inner + 2 * n_groups * d_state
    d_in_proj = 2 * d_inner + 2 * n_groups * d_state + n_heads
    return {
        "in_proj": ParamDef((layers, d_model, d_in_proj)),
        "conv_w": ParamDef((layers, d_conv, conv_dim)),
        "conv_b": ParamDef((layers, conv_dim), init="zeros"),
        "A_log": ParamDef((layers, n_heads), init="zeros"),
        "D": ParamDef((layers, n_heads), init="ones"),
        "dt_bias": ParamDef((layers, n_heads), init="zeros"),
        "norm": ParamDef((layers, d_inner), init="ones"),
        "out_proj": ParamDef((layers, d_inner, d_model)),
    }


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _silu(x):
    """``jax.nn.silu`` as XLA computes it: x * 1 / (1 + exp(-x)), each
    operation rounded to x's dtype (``F.silu`` rounds once)."""
    return x * (1 / (1 + torch.exp(-x)))


def _gated_rmsnorm(y, z, scale, eps=1e-6):
    """RMS norm of y * silu(z), silu in float32 cast to y's dtype.  The
    product stays float32: the reference casts it to float32 right after
    computing it in bf16, and XLA drops that round trip."""
    g = y.float() * _silu(z.float()).to(y.dtype).float()
    var = g.square().mean(dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _split_xbc(xBC, d_inner: int, n_groups: int, d_state: int):
    return torch.split(xBC, [d_inner, n_groups * d_state,
                             n_groups * d_state], dim=-1)


def ssm_scan_inputs(p, x, *, n_heads: int, d_state: int, d_conv: int,
                    n_groups: int = 1):
    """The mixer up to its scan: x (B, S, d_model) -> (z, xBC_raw, xs, B,
    C, dt, A), with xs (B, S, H, P), B and C (B, S, g, N) in x's dtype, dt
    (B, S, H) and A (H,) float32."""
    Bsz, S, _ = x.shape
    d_inner = p["out_proj"].shape[0]
    conv_dim = d_inner + 2 * n_groups * d_state
    proj = x @ p["in_proj"].to(x.dtype)
    z, xBC_raw, dt_raw = torch.split(proj, [d_inner, conv_dim, n_heads],
                                     dim=-1)
    # depthwise causal conv over (x, B, C), kernel width d_conv
    w = p["conv_w"].to(x.dtype)                        # (d_conv, conv_dim)
    pad = F.pad(xBC_raw, (0, 0, d_conv - 1, 0))
    conv = sum(pad[:, i:i + S, :] * w[i] for i in range(d_conv))
    xBC = _silu(conv + p["conv_b"].to(x.dtype))
    xs, Bmat, Cmat = _split_xbc(xBC, d_inner, n_groups, d_state)
    dt = _softplus(dt_raw.float() + p["dt_bias"].float())       # (B,S,H)
    A = -torch.exp(p["A_log"].float())                           # (H,)
    return (z, xBC_raw, xs.reshape(Bsz, S, n_heads, d_inner // n_heads),
            Bmat.reshape(Bsz, S, n_groups, d_state),
            Cmat.reshape(Bsz, S, n_groups, d_state), dt, A)


def apply_ssm(p, x, *, n_heads: int, d_state: int, d_conv: int,
              chunk: int = 256, n_groups: int = 1):
    """The full mixer, prefill path.  p: one layer's slice of
    ``ssm_defs``; x: (B, S, d_model).  Returns (out, (final_state bf16 (B,
    H, P, N), conv_tail (B, d_conv - 1, conv_dim))) for the cache."""
    Bsz, S, _ = x.shape
    d_inner = p["out_proj"].shape[0]
    z, xBC_raw, xs, Bmat, Cmat, dt, A = ssm_scan_inputs(
        p, x, n_heads=n_heads, d_state=d_state, d_conv=d_conv,
        n_groups=n_groups)
    # pad the sequence up to a chunk multiple; padded steps get dt = 0, so
    # they neither emit output nor move the carried state (decay 1)
    padlen = -S % chunk
    seq4 = (0, 0, 0, 0, 0, padlen)
    y, final_state = ops.ssd_chunk_scan(
        F.pad(xs, seq4).float(), F.pad(dt, (0, 0, 0, padlen)), A,
        F.pad(Bmat, seq4).float(), F.pad(Cmat, seq4).float(), chunk=chunk)
    y = y[:, :S] + xs.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm"])
    out = y @ p["out_proj"].to(x.dtype)
    # decode resumes the conv from the raw (pre-conv) projections of the
    # last d_conv - 1 positions
    conv_tail = F.pad(xBC_raw, (0, 0, d_conv - 1, 0))[:, S:S + d_conv - 1]
    return out, (final_state.to(x.dtype), conv_tail)


def apply_ssm_decode(p, x, state, conv_cache, *, n_heads: int, d_state: int,
                     d_conv: int, n_groups: int = 1):
    """One-token recurrent step.  x: (B, 1, d_model); state (B, H, P, N);
    conv_cache (B, d_conv - 1, conv_dim).  Returns (out, new_state in x's
    dtype, new_conv_cache)."""
    Bsz = x.shape[0]
    d_inner = p["out_proj"].shape[0]
    conv_dim = d_inner + 2 * n_groups * d_state
    proj = x @ p["in_proj"].to(x.dtype)
    z, xBC, dt_raw = torch.split(proj, [d_inner, conv_dim, n_heads], dim=-1)
    hist = torch.cat([conv_cache, xBC], dim=1)        # (B, d_conv, conv_dim)
    # one float32 dot per channel, rounded once (the reference's einsum)
    conv = torch.einsum("bkc,kc->bc", hist.float(),
                        p["conv_w"].to(x.dtype).float()).to(x.dtype)
    xBC = _silu(conv[:, None, :] + p["conv_b"].to(x.dtype))
    xs, Bmat, Cmat = _split_xbc(xBC, d_inner, n_groups, d_state)
    rep = n_heads // n_groups
    xs = xs.reshape(Bsz, n_heads, d_inner // n_heads).float()
    Bmat = Bmat.reshape(Bsz, n_groups, d_state).repeat_interleave(rep, 1)
    Cmat = Cmat.reshape(Bsz, n_groups, d_state).repeat_interleave(rep, 1)
    dt = _softplus(dt_raw[:, 0, :].float() + p["dt_bias"].float())  # (B,H)
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A[None, :])
    upd = torch.einsum("bh,bhn,bhp->bhpn", dt, Bmat.float(), xs)
    new_state = state.float() * decay[:, :, None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", Cmat.float(), new_state)
    y = y + xs * p["D"].float()[None, :, None]
    y = y.reshape(Bsz, 1, d_inner).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm"])
    out = y @ p["out_proj"].to(x.dtype)
    return out, new_state.to(x.dtype), hist[:, 1:]
