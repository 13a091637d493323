"""Plain PyTorch versions of the port's kernels.

Each function is the specification its CUDA kernel must match, with the
reference's semantics (``repro/kernels/ref.py`` and the Pallas bodies).
The CPU path of ``kernels.ops`` runs these; on the card they serve only
as the comparison in ``chip_smoke.py``.
"""

from __future__ import annotations

import math

import torch


def neighbor_sample(indptr, indices, targets, rand):
    """CSR fanout sampling with explicit randomness.

    indptr: (N+1,) int32; indices: (E,) int32; targets: (M,) int32;
    rand: (M, S) int32.  Returns (M, S) int32 with ``out[m, s] =
    indices[indptr[t] + rand[m, s] mod deg(t)]`` for ``t = targets[m]``
    (a floor-mod, as ``jnp`` takes it, and the position clamped to
    ``E - 1``); degree-0 targets sample themselves."""
    t = targets.long()
    start = indptr[t].long()
    deg = indptr[t + 1].long() - start
    r = torch.remainder(rand.long(), deg.clamp_min(1)[:, None])
    if indices.shape[0] == 0:
        picked = torch.zeros_like(r)
    else:
        picked = indices[(start[:, None] + r).clamp_max(indices.shape[0] - 1)]
    return torch.where(deg[:, None] > 0, picked.long(),
                       t[:, None]).to(torch.int32)


def feature_gather_mean(table, ids):
    """table: (N, F); ids: (M, K) int -> (M, F) fanout mean, accumulated
    in float32 as ``acc += row_k / K`` in k order (the Pallas body's
    order) and cast to the table's type.  The divisor is a tensor on the
    table's device: ATen divides a CUDA tensor by a Python scalar as a
    multiply by its reciprocal, which is not the true division."""
    K = ids.shape[1]
    acc = torch.zeros(ids.shape[0], table.shape[1], dtype=torch.float32,
                      device=table.device)
    div = torch.tensor(float(K), dtype=torch.float32, device=table.device)
    for k in range(K):
        acc += table[ids[:, k].long()].float() / div
    return acc.to(table.dtype)


def feature_gather_rows(table, ids):
    """table: (N, F); ids: (R,) int -> (R, F), the exact row copy
    ``table[ids]`` (the K = 1 case of the mean)."""
    return table[ids.long()]


def feature_gather_cached(cache, slot_of, ids):
    """cache: (C, F); slot_of: (N+1,) int node -> slot indirection; ids:
    (R,) int resident node ids -> (R, F) gathered cache rows.  An
    unresolved slot (-1) reads slot 0, as the kernels clamp it."""
    return cache[slot_of[ids.long()].long().clamp_min(0)]


def neighbor_sample_cached(indptr, block_slots, targets, rand, cache, *,
                           block_e: int, max_block: int):
    """Fanout sampling through an edge-block cache.

    indptr: (N+1,) int32; block_slots: (NB+1,) int32 block id -> cache
    slot; cache: (C, block_e) int32 resident edge blocks; targets: (M,)
    int32; rand: (M, S) int32.  The sampled entry sits at ``local =
    start - b * block_e + rand mod deg`` in the pair of blocks (b, b+1),
    ``b = min(start // block_e, max_block)``; it is read from block ``b +
    local // block_e`` of the cache, an unresolved slot (-1) reading slot
    0.  Degree-0 targets sample themselves.  Returns (M, S) int32, equal
    to ``neighbor_sample`` over the uncached edge array when every
    dereferenced block is resident."""
    t = targets.long()
    start = indptr[t].long()
    deg = indptr[t + 1].long() - start
    b = torch.clamp(start // block_e, max=max_block)
    r = torch.remainder(rand.long(), deg.clamp_min(1)[:, None])
    local = (start - b * block_e)[:, None] + r
    slot = block_slots[b[:, None] + local // block_e].long().clamp_min(0)
    picked = cache[slot, local % block_e]
    return torch.where(deg[:, None] > 0, picked.long(),
                       t[:, None]).to(torch.int32)


NEG_INF = -1e30


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """Causal or full GQA attention forward with the per-row logsumexp.

    q: (B, S, Hq, D); k, v: (B, S, Hkv, D), the model's layout; query head
    ``h`` reads kv head ``h // (Hq // Hkv)``.  Scores in float32 with
    scale ``1/sqrt(D)``, masked (``qpos < kpos`` when causal) to
    ``NEG_INF = -1e30``.  Returns ``out`` (B, S, Hq, D) in q.dtype, equal
    to ``(P @ V) / max(l, 1e-30)``, and ``lse = m + log(max(l, 1e-30))``
    (B, Hq, S) float32: what the reference's ``_fwd_kernel`` writes.  The
    (B, Hq, S, S) score matrix is materialized whole."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, S, Hkv, group, D).float()
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[:, None] < pos[None, :], NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()) / \
        l.permute(0, 3, 1, 2)[..., None]
    lse = (m + torch.log(l)).reshape(B, Hq, S)
    return o.reshape(B, S, Hq, D).to(q.dtype), lse


def _bwd_recompute(q, k, v, out, lse, do, causal: bool):
    """The recompute of the reference's ``_flash_bwd`` in float32, per
    query head: p = exp(s - lse) with s masked to ``NEG_INF``, delta =
    rowsum(dO * O), ds = p * (dp - delta) * scale.  Returns the float32
    q, k and dO (grouped as (B, S, Hkv, g, D) where per query head), p and
    ds (B, Hkv, g, S, S)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, S, Hkv, group, D)
    kf = k.float()
    dof = do.float().reshape(B, S, Hkv, group, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[:, None] < pos[None, :], NEG_INF)
    p = torch.exp(s - lse.float().reshape(B, Hkv, group, S, 1))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    delta = (dof * out.float().reshape(B, S, Hkv, group, D)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale
    return qf, kf, dof, p, ds


def flash_attention_bwd_dq(q, k, v, out, lse, do, *, causal: bool = True):
    """dq of the flash backward (the reference's ``_bwd_dq_kernel`` with
    its delta): q, out, do (B, S, Hq, D); k, v (B, S, Hkv, D); lse (B, Hq,
    S) float32 from the forward.  Returns dq = ds . k (B, S, Hq, D) in
    q.dtype.  The (B, Hq, S, S) matrices are materialized whole."""
    _, kf, _, _, ds = _bwd_recompute(q, k, v, out, lse, do, causal)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf)
    return dq.reshape(q.shape).to(q.dtype)


def flash_attention_bwd_dkv(q, k, v, out, lse, do, *, causal: bool = True):
    """dk = ds^T . q and dv = p^T . dO of the flash backward (the
    reference's ``_bwd_dkv_kernel`` and its wrapper's group sum), each
    summed over the group's query heads to (B, S, Hkv, D) in k's and v's
    dtype.  Arguments as ``flash_attention_bwd_dq``."""
    qf, _, dof, p, ds = _bwd_recompute(q, k, v, out, lse, do, causal)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True):
    """The flash backward (the reference's ``_flash_bwd``) in the model's
    layout: (dq, dk, dv) as ``flash_attention_bwd_dq`` and
    ``flash_attention_bwd_dkv`` give them, from one recompute."""
    qf, kf, dof, p, ds = _bwd_recompute(q, k, v, out, lse, do, causal)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(q.shape)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention(q, k, v, valid_len: int, window: int = 0):
    """Single-token GQA attention over a KV cache (the reference's
    ``ref.decode_attention``).

    q: (B, Hq, D); k, v: (B, S, Hkv, D); key ``s`` is valid iff ``s <
    valid_len`` and, when ``window > 0``, ``s >= valid_len - window``;
    invalid scores are ``NEG_INF``.  Returns (B, Hq, D) in q.dtype."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    group = Hq // Hkv
    qg = q.reshape(B, Hkv, group, D).float()
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * scale
    kpos = torch.arange(S, device=q.device)
    ok = kpos < valid_len
    if window > 0:
        ok = ok & (kpos >= valid_len - window)
    s = s.masked_fill(~ok, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(B, Hq, D).to(q.dtype)


def ssd_chunk_scan(x, dt, A, B, C, *, chunk: int):
    """The Mamba-2 SSD chunked scan (the reference's ``ref.ssd_chunk_scan``,
    which is ``models/ssm.ssd_chunked``).

    x: (b, s, h, p); dt: (b, s, h) post-softplus step sizes; A: (h,)
    negative decay rates; B, C: (b, s, g, n), head ``j`` reading group ``j //
    (h // g)``; ``s`` a multiple of ``chunk``.  Within a chunk, ``cs =
    cumsum(dt * A)`` and ``y_i = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j)
    dt_j x_j + exp(cs_i) C_i . prev``; across chunks the (p, n) state runs
    ``state = exp(cs_last) state + sum_q exp(cs_last - cs_q) dt_q x_q B_q``
    from zero.  The decay ``exp(cs_i - cs_j)`` is taken only where ``i >=
    j`` (the exponent is -inf elsewhere), so no inf is formed.  Returns y
    (b, s, h, p) and final_state (b, h, p, n), in x's dtype (float32).
    The (b, s/chunk, chunk, chunk, h) decay and score tensors are
    materialized whole."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    rep = h // g

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Cc = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    dA_cs = torch.cumsum(dtc * A, dim=2)                      # (b,nc,q,h)
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]   # (b,nc,q,q,h)
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).tril()
    L = torch.exp(seg.masked_fill(~lower[:, :, None], -math.inf))
    CB = torch.einsum("bcqhn,bckhn->bcqkh", Cc, Bc)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", CB * L,
                           xc * dtc[..., None])

    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)     # (b,nc,q,h)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bc, decay_to_end * dtc,
                          xc)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])               # (b,nc,h)
    state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):                   # the state before each chunk
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Cc,
                           torch.stack(prev, dim=1), torch.exp(dA_cs))
    return (y_intra + y_inter).reshape(b, s, h, p), state
