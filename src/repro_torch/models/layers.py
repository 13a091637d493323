"""Shared layer primitives of the LM: norms, activations, RoPE and
M-RoPE, embeddings.

The port of the reference's ``repro/models/layers.py``.  Same
arithmetic: the RMS norm runs in float32 and casts back, RoPE and M-RoPE
rotate split halves (not interleaved pairs) with float32 angles, and gelu
is the tanh approximation that ``jax.nn.gelu`` defaults to.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef


def rmsnorm_def(dim: int, layers: int | None = None) -> ParamDef:
    if layers is None:
        return ParamDef((dim,), init="ones")
    return ParamDef((layers, dim), init="ones")


def rmsnorm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


def activation(name: str):
    return {"silu": F.silu, "gelu": functools.partial(F.gelu,
                                                      approximate="tanh"),
            "relu": F.relu}[name]


def rope_frequencies(head_dim: int, theta: float, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (head_dim/2,)


def apply_rope(x, positions, theta: float = 1e4):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def _rotate(x, angles):
    """x (..., seq, heads, head_dim) rotated by float32 ``angles`` (...,
    seq, head_dim/2), split halves, cast back to x's dtype."""
    angles = angles[..., None, :]                    # broadcast heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, sections, theta: float = 1e4):
    """Multimodal RoPE (Qwen2-VL): the rotary frequencies split into (t,
    h, w) sections, each taking its position from its own row.

    x: (..., seq, heads, head_dim); positions3: (3, ..., seq) int;
    sections: 3 ints summing to head_dim // 2.  With the three rows equal
    it is ``apply_rope`` bit for bit (the same float32 products)."""
    head_dim = x.shape[-1]
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"head_dim // 2 = {head_dim // 2}")
    freqs = rope_frequencies(head_dim, theta, device=x.device)
    sec_ids = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device))     # (hd/2,)
    pos = positions3.movedim(0, -1)[..., sec_ids]    # (..., seq, hd/2)
    return _rotate(x, pos.float() * freqs)


def embed_def(vocab: int, d_model: int) -> ParamDef:
    # scaled by 1/sqrt(d_model) so tied-embedding logits start at unit
    # variance, as in the reference
    return ParamDef((vocab, d_model), init="normal", fan_in_axes=(1,))


def unembed_def(d_model: int, vocab: int) -> ParamDef:
    return ParamDef((d_model, vocab))


def embed_lookup(table, token_ids, compute_dtype):
    return F.embedding(token_ids, table.to(compute_dtype))
