"""Shared layer primitives of the LM: norms, activations, RoPE, embeddings.

The port of the reference's ``repro/models/layers.py`` for the dense
family (M-RoPE waits for the multimodal slice).  Same arithmetic: the
RMS norm runs in float32 and casts back, RoPE rotates split halves (not
interleaved pairs) with float32 angles, and gelu is the tanh
approximation that ``jax.nn.gelu`` defaults to.
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
    angles = positions[..., None].float() * freqs   # (..., seq, hd/2)
    angles = angles[..., None, :]                    # broadcast heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_def(vocab: int, d_model: int) -> ParamDef:
    # scaled by 1/sqrt(d_model) so tied-embedding logits start at unit
    # variance, as in the reference
    return ParamDef((vocab, d_model), init="normal", fan_in_axes=(1,))


def unembed_def(d_model: int, vocab: int) -> ParamDef:
    return ParamDef((d_model, vocab))


def embed_lookup(table, token_ids, compute_dtype):
    return F.embedding(token_ids, table.to(compute_dtype))
