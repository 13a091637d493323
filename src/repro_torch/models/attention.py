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
hardware) and on a CPU tensor takes its plain version.

``sharded_decode_attention`` is the reference's near-data decode on a
process mesh: the KV cache is split on its sequence dim over the
``model`` ranks, each rank reduces over its own slice to online-softmax
partials (max, sum, weighted V) in float32, plain torch ops as the
reference's jnp ones, and only those O(B x Hq x D) partials cross the
link (``distributed.collectives.online_softmax_combine``).  A rank whose
slice lies wholly past the current position gets the max ``NEG_INF``
(finite, so its scale ``exp(m - m_global)`` is 0, not NaN) and adds
nothing.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.collectives import (group_of,
                                                 online_softmax_combine)
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


def _decode_partials(q, k_slice, v_slice, kpos, valid_len: int,
                     window: int, scale: float):
    """One rank's online-softmax partials over its KV slice: q (B, Hq, D),
    k/v_slice (B, s, Hkv, D), kpos (s,) the slice's global positions.
    Returns (m, l, o): (B, Hkv, g), (B, Hkv, g), (B, Hkv, g, D) float32."""
    B, Hq, D = q.shape
    Hkv = k_slice.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_slice.float()) * scale
    ok = kpos < valid_len
    if window > 0:
        ok = ok & (kpos >= valid_len - window)
    s = torch.where(ok[None, None, None], s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bhgs,bshd->bhgd", p, v_slice.float())
    return m, p.sum(dim=-1), o


def sharded_decode_attention(mesh, *, seq_axis: str = "model"):
    """The near-data decode attention with the in-place cache update, on
    a ``DeviceMesh`` whose ``seq_axis`` ranks each hold one slice of the
    cache's S (the reference's ``sharded_decode_attention``; the batch
    stays whole on every rank).

    Returns ``fn(q, new_k, new_v, cache_k, cache_v, position, window) ->
    out``: q (B, Hq, D), new_k/v (B, 1, Hkv, D), cache_k/v this rank's
    (B, S / n, Hkv, D) slice, written in place at ``position`` by the
    rank that owns it; ``position`` and ``window`` host ints.  ``out``
    (B, Hq, D) in q's dtype."""
    group = group_of((mesh, seq_axis))
    idx = mesh.get_local_rank(seq_axis)

    def fn(q, new_k, new_v, cache_k, cache_v, position: int, window: int):
        B, shard_len, _, D = cache_k.shape
        start = idx * shard_len
        local = position - start
        if 0 <= local < shard_len:
            cache_k[:, local] = new_k[:, 0]
            cache_v[:, local] = new_v[:, 0]
        kpos = start + torch.arange(shard_len, device=q.device)
        m, l, o = _decode_partials(q, cache_k, cache_v, kpos, position + 1,
                                   int(window), 1.0 / math.sqrt(D))
        out = online_softmax_combine(m, l, o, group)
        return out.reshape(B, q.shape[1], D).to(q.dtype)

    return fn
