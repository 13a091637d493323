"""Attention of the LM: chunked prefill attention and decode attention.

The port of the reference's ``repro/models/attention.py`` on one card.

``mha_chunked`` is the reference's own jnp path in plain PyTorch: a
double-chunked online softmax with GQA, a causal mask and a sliding
window, the path JAX also takes for ``attn_impl="chunked"`` and for the
window archs, differentiable for training (with the reference's
``attn_remat`` as a checkpoint per KV step).  ``decode_attention_local``
is one token's attention over the KV cache; it goes through
``kernels.ops.decode_attention``, which on a CUDA tensor launches the
hand-written decode kernel (the swap-in the reference names for
hardware) and on a CPU tensor takes its plain version.  The mesh's
``sharded_decode_attention`` is not ported.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops

NEG_INF = -1e30


def _chunk_scores_mask(q_pos, k_pos, window: int, causal: bool):
    """(cq, ck) boolean mask; ``window`` <= 0 means unlimited."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok = ok & (diff >= 0)
    if window > 0:
        ok = ok & (diff < window)
    return ok


def _kv_step(m, l, o, q_blk, k_blk, v_blk, mask, scale: float,
             scores_bf16: bool):
    """One KV chunk of the online softmax: (m, l, o) updated by the
    (cq, ck) score block of ``q_blk`` against ``k_blk``."""
    work = torch.bfloat16 if scores_bf16 else torch.float32
    s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk.to(work),
                     k_blk.to(work)) * scale
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                          device=s.device))
    m_new = torch.maximum(m, s.amax(dim=-1).float())
    p = torch.exp(s.float() - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = p.to(torch.bfloat16) if scores_bf16 else p
    o_new = o * corr[..., None] + torch.einsum(
        "bhgqk,bkhd->bhgqd", pv, v_blk.to(pv.dtype)).float()
    return m_new, l_new, o_new


def mha_chunked(q, k, v, *, q_positions, k_positions, window: int = 0,
                causal: bool = True, chunk_q: int = 2048,
                chunk_k: int = 1024, scale: float | None = None,
                remat_chunks: bool = False, scores_bf16: bool = False):
    """Chunked multi-head attention with GQA, differentiable by autograd
    (no op works in place).

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); q_positions: (Sq,) and
    k_positions: (Sk,) int; window: sliding-window size (<= 0 = full).
    ``remat_chunks`` checkpoints each KV step (``torch.utils.checkpoint``,
    the reference's ``jax.checkpoint`` of its scan body): the backward
    recomputes the (cq, ck) score block instead of keeping it.  Returns
    (B, Sq, Hq, D) in q.dtype.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    window = int(window)
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    assert Sq % cq == 0 and Sk % ck == 0, (Sq, cq, Sk, ck)

    outs = []
    for q0 in range(0, Sq, cq):
        q_blk = q[:, q0:q0 + cq].reshape(B, cq, Hkv, group, D)
        qpos = q_positions[q0:q0 + cq]
        m = torch.full((B, Hkv, group, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros((B, Hkv, group, cq, D), dtype=torch.float32,
                        device=q.device)
        for k0 in range(0, Sk, ck):
            mask = _chunk_scores_mask(qpos, k_positions[k0:k0 + ck], window,
                                      causal)
            args = (m, l, o, q_blk, k[:, k0:k0 + ck], v[:, k0:k0 + ck], mask,
                    scale, scores_bf16)
            if remat_chunks:
                m, l, o = checkpoint(_kv_step, *args, use_reentrant=False)
            else:
                m, l, o = _kv_step(*args)
        o = o / torch.clamp(l, min=1e-30)[..., None]
        # (B, Hkv, g, cq, D) -> (B, cq, Hkv * g, D)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, cq, Hq, D))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention_local(q, cache_k, cache_v, valid_len: int, *,
                           window: int = 0):
    """Single-token attention over a KV cache: q (B, Hq, D), cache_k/v
    (B, S, Hkv, D), ``valid_len`` and ``window`` host ints (key ``s``
    attends iff ``s < valid_len`` and, for ``window > 0``, ``s >=
    valid_len - window``).  Returns (B, Hq, D) in q.dtype."""
    return ops.decode_attention(q, cache_k, cache_v, int(valid_len),
                                int(window))
