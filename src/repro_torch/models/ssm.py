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

import functools

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import take_groups
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
        "in_proj": ParamDef((layers, d_model, d_in_proj),
                            logical_axes=("layers", "embed", None)),
        "conv_w": ParamDef((layers, d_conv, conv_dim),
                           logical_axes=("layers", "conv", None)),
        "conv_b": ParamDef((layers, conv_dim), init="zeros",
                           logical_axes=("layers", None)),
        "A_log": ParamDef((layers, n_heads), init="zeros",
                          logical_axes=("layers", "ssm_head")),
        "D": ParamDef((layers, n_heads), init="ones",
                      logical_axes=("layers", "ssm_head")),
        "dt_bias": ParamDef((layers, n_heads), init="zeros",
                            logical_axes=("layers", "ssm_head")),
        "norm": ParamDef((layers, d_inner), init="ones",
                         logical_axes=("layers", None)),
        "out_proj": ParamDef((layers, d_inner, d_model),
                             logical_axes=("layers", "mlp", "embed")),
    }


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _silu(x):
    """``jax.nn.silu`` as XLA computes it: x * 1 / (1 + exp(-x)), each
    operation rounded to x's dtype (``F.silu`` rounds once)."""
    return x * (1 / (1 + torch.exp(-x)))


def _gated_rmsnorm(y, z, scale, eps=1e-6, tp=None):
    """RMS norm of y * silu(z), silu in float32 cast to y's dtype.  The
    product stays float32: the reference casts it to float32 right after
    computing it in bf16, and XLA drops that round trip.  The mean is
    over the whole ``d_inner``: where ``tp`` splits the heads, y and z are
    this rank's channels and the sum of squares is summed over the ranks
    before the ``rsqrt`` (and its gradient, as each rank's channels use
    it)."""
    g = y.float() * _silu(z.float()).to(y.dtype).float()
    if tp is None or not tp.sharded("A_log"):
        var = g.square().mean(dim=-1, keepdim=True)
    else:
        ss = g.square().sum(dim=-1, keepdim=True)
        var = tp.enter(tp.exit(ss)) / (g.shape[-1] * tp.size)
    return (g * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _split_xbc(xBC, d_inner: int, n_groups: int, d_state: int):
    return torch.split(xBC, [d_inner, n_groups * d_state,
                             n_groups * d_state], dim=-1)


class _Heads:
    """The SSM heads a rank runs: all of them, or its block where ``tp``
    splits ``ssm_head`` (the ``A_log`` leaf): the channels of z, x and
    dt it takes out of the whole ``in_proj`` product, the conv channels
    (its x channels and every group's B and C) and the groups its heads
    read (``TensorParallel.group_pick``)."""

    def __init__(self, tp, n_heads: int, d_inner: int, n_groups: int,
                 d_state: int):
        self.tp = tp
        self.split = tp is not None and tp.sharded("A_log")
        P = d_inner // n_heads
        gn = n_groups * d_state
        h0, h1 = tp.span(n_heads) if self.split else (0, n_heads)
        self.heads, self.d_inner, self.groups = h1 - h0, (h1 - h0) * P, None
        if not self.split:
            return
        ar = functools.partial(torch.arange, dtype=torch.int64)
        c0, c1 = h0 * P, h1 * P
        self.conv_cols = torch.cat([ar(c0, c1),
                                    ar(d_inner, d_inner + 2 * gn)])
        self.proj_cols = torch.cat([
            ar(c0, c1), ar(d_inner + c0, d_inner + c1),
            ar(2 * d_inner, 2 * d_inner + 2 * gn),
            ar(2 * d_inner + 2 * gn + h0, 2 * d_inner + 2 * gn + h1)])
        self.groups = tp.group_pick(n_heads, n_groups)

    def proj(self, proj):
        """The rank's columns of the whole ``in_proj`` product (whose
        gradient each rank's heads take a part of)."""
        if not self.split:
            return proj
        return self.tp.enter(proj).index_select(
            -1, self.proj_cols.to(proj.device))

    def conv(self, w):
        """The conv weight or bias at the rank's conv channels."""
        if not self.split:
            return w
        return self.tp.enter(w).index_select(-1, self.conv_cols.to(w.device))

    def pick_groups(self, m):
        """B or C (..., g, N) at the groups the rank's heads read."""
        return take_groups(m, self.groups, -2)


def ssm_scan_inputs(p, x, *, n_heads: int, d_state: int, d_conv: int,
                    n_groups: int = 1, tp=None):
    """The mixer up to its scan: x (B, S, d_model) -> (z, xBC_raw, xs, B,
    C, dt, A), with xs (B, S, H, P), B and C (B, S, g, N) in x's dtype, dt
    (B, S, H) and A (H,) float32: on the rank's heads where ``tp`` splits
    them (``_Heads``)."""
    Bsz, S, _ = x.shape
    d_inner = p["norm"].shape[-1]
    hd = _Heads(tp, n_heads, d_inner, n_groups, d_state)
    gn = n_groups * d_state
    proj = hd.proj(x @ p["in_proj"].to(x.dtype))
    z, xBC_raw, dt_raw = torch.split(
        proj, [hd.d_inner, hd.d_inner + 2 * gn, hd.heads], dim=-1)
    # depthwise causal conv over (x, B, C), kernel width d_conv
    w = hd.conv(p["conv_w"]).to(x.dtype)                # (d_conv, conv_dim)
    pad = F.pad(xBC_raw, (0, 0, d_conv - 1, 0))
    conv = sum(pad[:, i:i + S, :] * w[i] for i in range(d_conv))
    xBC = _silu(conv + hd.conv(p["conv_b"]).to(x.dtype))
    xs, Bmat, Cmat = _split_xbc(xBC, hd.d_inner, n_groups, d_state)
    dt = _softplus(dt_raw.float() + p["dt_bias"].float())       # (B,S,H)
    A = -torch.exp(p["A_log"].float())                           # (H,)
    return (z, xBC_raw,
            xs.reshape(Bsz, S, hd.heads, hd.d_inner // hd.heads),
            hd.pick_groups(Bmat.reshape(Bsz, S, n_groups, d_state)),
            hd.pick_groups(Cmat.reshape(Bsz, S, n_groups, d_state)), dt, A)


def _ssm_out(p, y, z, tp):
    """The gated norm of the scan's output and ``out_proj``, row-parallel
    where ``tp`` splits its ``mlp`` dim (``d_inner``): the rank's channels
    of y times its rows of ``out_proj``, summed over the ranks."""
    split = tp is not None and tp.sharded("A_log")
    # the whole norm scale at the rank's channels (its gradient a part)
    scale = tp.enter(p["norm"])[..., _chan(tp, p)] if split else p["norm"]
    y = _gated_rmsnorm(y, z, scale, tp=tp)
    w = p["out_proj"].to(y.dtype)
    if tp is None or not tp.sharded("out_proj"):
        return y @ w
    if y.shape[-1] != w.shape[0]:      # whole heads: the rank's channels
        y = tp.enter(y)[..., _chan(tp, p)]
    return tp.exit(y @ w)


def _chan(tp, p) -> slice:
    """The rank's block of the ``d_inner`` channels."""
    lo, hi = tp.span(p["norm"].shape[-1])
    return slice(lo, hi)


def apply_ssm(p, x, *, n_heads: int, d_state: int, d_conv: int,
              chunk: int = 256, n_groups: int = 1, tp=None):
    """The full mixer, prefill path.  p: one layer's slice of
    ``ssm_defs`` (the ``ssm_head`` leaves and ``out_proj`` the rank's
    shards where ``tp`` splits them); x: (B, S, d_model).  Returns (out,
    (final_state bf16 (B, H, P, N), conv_tail (B, d_conv - 1,
    conv_dim))) for the cache, on the rank's heads and conv channels."""
    Bsz, S, _ = x.shape
    z, xBC_raw, xs, Bmat, Cmat, dt, A = ssm_scan_inputs(
        p, x, n_heads=n_heads, d_state=d_state, d_conv=d_conv,
        n_groups=n_groups, tp=tp)
    # pad the sequence up to a chunk multiple; padded steps get dt = 0, so
    # they neither emit output nor move the carried state (decay 1)
    padlen = -S % chunk
    seq4 = (0, 0, 0, 0, 0, padlen)
    y, final_state = ops.ssd_chunk_scan(
        F.pad(xs, seq4).float(), F.pad(dt, (0, 0, 0, padlen)), A,
        F.pad(Bmat, seq4).float(), F.pad(Cmat, seq4).float(), chunk=chunk)
    y = y[:, :S] + xs.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(Bsz, S, -1).to(x.dtype)
    out = _ssm_out(p, y, z, tp)
    # decode resumes the conv from the raw (pre-conv) projections of the
    # last d_conv - 1 positions
    conv_tail = F.pad(xBC_raw, (0, 0, d_conv - 1, 0))[:, S:S + d_conv - 1]
    return out, (final_state.to(x.dtype), conv_tail)


def apply_ssm_decode(p, x, state, conv_cache, *, n_heads: int, d_state: int,
                     d_conv: int, n_groups: int = 1, tp=None):
    """One-token recurrent step.  x: (B, 1, d_model); state (B, H, P, N);
    conv_cache (B, d_conv - 1, conv_dim) (the rank's heads and conv
    channels where ``tp`` splits the heads).  Returns (out, new_state in
    x's dtype, new_conv_cache)."""
    Bsz = x.shape[0]
    d_inner = p["norm"].shape[-1]
    hd = _Heads(tp, n_heads, d_inner, n_groups, d_state)
    gn = n_groups * d_state
    proj = hd.proj(x @ p["in_proj"].to(x.dtype))
    z, xBC, dt_raw = torch.split(
        proj, [hd.d_inner, hd.d_inner + 2 * gn, hd.heads], dim=-1)
    hist = torch.cat([conv_cache, xBC], dim=1)        # (B, d_conv, conv_dim)
    # one float32 dot per channel, rounded once (the reference's einsum)
    conv = torch.einsum("bkc,kc->bc", hist.float(),
                        hd.conv(p["conv_w"]).to(x.dtype).float()
                        ).to(x.dtype)
    xBC = _silu(conv[:, None, :] + hd.conv(p["conv_b"]).to(x.dtype))
    xs, Bmat, Cmat = _split_xbc(xBC, hd.d_inner, n_groups, d_state)
    H = hd.heads
    xs = xs.reshape(Bsz, H, hd.d_inner // H).float()
    Bmat = hd.pick_groups(Bmat.reshape(Bsz, n_groups, d_state))
    Cmat = hd.pick_groups(Cmat.reshape(Bsz, n_groups, d_state))
    rep = H // Bmat.shape[1]
    Bmat = Bmat.repeat_interleave(rep, 1)
    Cmat = Cmat.repeat_interleave(rep, 1)
    dt = _softplus(dt_raw[:, 0, :].float() + p["dt_bias"].float())  # (B,H)
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A[None, :])
    upd = torch.einsum("bh,bhn,bhp->bhpn", dt, Bmat.float(), xs)
    new_state = state.float() * decay[:, :, None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", Cmat.float(), new_state)
    y = y + xs * p["D"].float()[None, :, None]
    y = y.reshape(Bsz, 1, hd.d_inner).to(x.dtype)
    out = _ssm_out(p, y, z, tp)
    return out, new_state.to(x.dtype), hist[:, 1:]
