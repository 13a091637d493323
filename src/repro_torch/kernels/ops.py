"""Public wrappers for the port's kernels, dispatched by device.

A CUDA tensor launches the hand-written kernel (``kernels.neighbor_sample``,
``kernels.feature_gather``, each with its cached variant that reads
through a device cache's slot table; ``kernels.flash_attention`` and
``kernels.decode_attention`` for the LM, the forward under an autograd
``FlashAttention`` whose backward is the flash backward kernels;
``kernels.ssd_chunk_scan`` for the SSM mixer, under an autograd
``SSDChunkScan`` whose backward is autograd of the plain scan on either
device), which raises on what it does not take; a CPU tensor takes the
plain version in ``kernels.ref``.
There is no switch and no fallback between the two: the device of the
data decides.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import feature_gather as _fg
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import neighbor_sample as _ns
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk_scan as _ssd


def edge_block_size(max_degree: int) -> int:
    """The reference kernels' edge-block width: 128-aligned and >= the
    max neighbour-list length.  The CUDA kernel reads each sampled entry
    directly and needs no blocks; kept so callers size things alike."""
    return max(128, int(-(-max_degree // 128) * 128))


def neighbor_sample(indptr, indices, targets, rand, *, max_degree: int):
    """CSR fanout sample: (N+1,), (E,), (M,), (M, S) -> (M, S) int32.
    ``max_degree`` is kept for the reference's signature; no degree
    limit applies."""
    args = [x.to(torch.int32).contiguous()
            for x in (indptr, indices, targets, rand)]
    if targets.is_cuda:
        return _ns.neighbor_sample(*args)
    return ref.neighbor_sample(*args)


def neighbor_sample_cached(indptr, cache, block_slots, targets, rand, *,
                           block_e: int, max_block: int):
    """Fanout sample through the (C, block_e) edge-block cache and its
    ``block_slots`` indirection instead of the full edge array.
    Residency is the caller's contract (``DeviceEdgeBlockCache`` resolves
    the planned block set before the call); the ids then equal
    ``neighbor_sample``'s."""
    args = [x.to(torch.int32).contiguous()
            for x in (indptr, block_slots, targets, rand, cache)]
    if targets.is_cuda:
        return _ns.neighbor_sample_cached(*args, block_e=block_e,
                                          max_block=max_block)
    return ref.neighbor_sample_cached(*args, block_e=block_e,
                                      max_block=max_block)


def sample_khop_kernel(indptr, indices, targets, fanouts, *, key,
                       max_degree: int):
    """K-hop GraphSAGE sampling through ``neighbor_sample``.

    Per hop: fold the hop index into ``key`` (an ``rng`` key pair), draw
    int32 bits in ``[0, 2**31 - 1)`` shaped like the frontier + fanout on
    the frontier's device, flatten the frontier, and sample.  The bits
    equal the reference's ``jax.random`` stream, so both packages sample
    the same ids.  Returns [(M,), (M, f1), (M, f1, f2), ...] int32."""
    hops = [targets.to(torch.int32)]
    frontier = hops[0]
    for i, f in enumerate(fanouts):
        rand = rng.randint(rng.fold_in(key, i), tuple(frontier.shape) + (f,),
                           0, 2**31 - 1, device=frontier.device)
        flat = frontier.reshape(-1)
        nxt = neighbor_sample(indptr, indices, flat,
                              rand.reshape(flat.shape[0], f),
                              max_degree=max_degree)
        frontier = nxt.reshape(tuple(frontier.shape) + (f,))
        hops.append(frontier)
    return hops


def feature_gather_rows(table, ids):
    """(N, F), ids (...,) -> (..., F) row gather, one launch per call."""
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    if table.is_cuda:
        out = _fg.feature_gather_rows(table, flat)
    else:
        out = ref.feature_gather_rows(table, flat)
    return out.reshape(tuple(ids.shape) + (table.shape[1],))


def feature_gather_mean(table, ids):
    """(N, F), (M, K) -> (M, F) fanout mean of gathered rows."""
    ids = ids.to(torch.int32).contiguous()
    if table.is_cuda:
        return _fg.feature_gather_mean(table, ids)
    return ref.feature_gather_mean(table, ids)


def feature_gather_cached(cache, slot_of, ids):
    """(C, F) row cache, (N+1,) slot table, ids (...,) -> (..., F): the
    device feature cache's read path, one launch per call.  Every id must
    be resident (``DeviceFeatureCache`` resolves misses before the
    call)."""
    F = cache.shape[1]
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    if flat.shape[0] == 0:
        return torch.zeros(tuple(ids.shape) + (F,), dtype=cache.dtype,
                           device=cache.device)
    slot_of = slot_of.to(torch.int32).contiguous()
    if cache.is_cuda:
        out = _fg.feature_gather_cached(cache, slot_of, flat)
    else:
        out = ref.feature_gather_cached(cache, slot_of, flat)
    return out.reshape(tuple(ids.shape) + (F,))


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """Causal or full GQA attention forward in the model's layout: q (B,
    S, Hq, D), k and v (B, S, Hkv, D) -> (out (B, S, Hq, D) in q.dtype,
    lse (B, Hq, S) float32).  The kernel takes bf16 and any S."""
    if q.is_cuda:
        return _fa.flash_attention_fwd(q, k, v, causal=causal)
    return ref.flash_attention_fwd(q, k, v, causal=causal)


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True):
    """The flash backward in the model's layout: q, ``out`` and ``do`` (B,
    S, Hq, D), k and v (B, S, Hkv, D), ``lse`` (B, Hq, S) float32 from the
    forward -> (dq, dk, dv) in q's, k's and v's dtypes, dk and dv summed
    over each KV head's group.  On the card the dQ kernel (which also
    computes delta = rowsum(do * out)) and then the dK/dV kernel."""
    if q.is_cuda:
        return _fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    return ref.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward, the reference's ``custom_vjp``
    (``flash_attention``): the forward saves (q, k, v, out, lse), the
    backward recomputes the probabilities from ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_bshd(q, k, v, *, causal: bool = True):
    """The LM's flash path (``cfg.attn_impl == "flash"``), prefill and
    training alike: the forward's output, differentiable through
    ``FlashAttention``.  The kernels pick their own tiles, so the
    reference's ``block_q``/``block_k`` (clipped to divisors of S there)
    are not taken."""
    return FlashAttention.apply(q, k, v, causal)


def decode_attention(q, k, v, valid_len: int, window: int = 0):
    """One token's GQA attention over a KV cache: q (B, Hq, D), k and v
    (B, S, Hkv, D), ``valid_len`` and ``window`` host ints -> (B, Hq, D)
    in q.dtype.  Any cache length S; the reference's padding of S to a
    block multiple is not needed."""
    if q.is_cuda:
        return _da.decode_attention(q, k, v, valid_len, window)
    return ref.decode_attention(q, k, v, valid_len, window)


def _ssd_scan(x, dt, A, B, C, chunk: int):
    if x.is_cuda:
        return _ssd.ssd_chunk_scan(x, dt, A, B, C, chunk=chunk)
    return ref.ssd_chunk_scan(x, dt, A, B, C, chunk=chunk)


class SSDChunkScan(torch.autograd.Function):
    """The SSD scan with a backward: the forward is the kernel (on a CPU
    tensor its plain version), the backward recomputes the plain
    ``ref.ssd_chunk_scan`` on the saved inputs and takes its
    vector-Jacobian product, as the reference trains its SSM (autodiff of
    the plain ``ssd_chunked``; its Pallas kernel has no VJP).  On the
    CPU that is autograd of the plain scan, bit for bit."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        y, state = _ssd_scan(x, dt, A, B, C, chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, state = ref.ssd_chunk_scan(*inputs, chunk=ctx.chunk)
        outs, grads_out = [], []
        for out, g in ((y, dy), (state, dstate)):
            if g is not None:
                outs.append(out)
                grads_out.append(g)
        grads = torch.autograd.grad(outs, inputs, grads_out,
                                    allow_unused=True)
        return (*grads, None)


def ssd_chunk_scan(x, dt, A, B, C, *, chunk: int = 128):
    """The Mamba-2 SSD chunked scan: x (b, s, h, p), dt (b, s, h)
    post-softplus, A (h,) negative, B and C (b, s, g, n) -> (y (b, s, h,
    p), final_state (b, h, p, n)), float32.  The reference dispatcher's
    rule: a chunk longer than a sequence it divides is cut to the
    sequence, and otherwise the sequence is padded (dt = 0) up to a chunk
    multiple and y cut back (outside ``SSDChunkScan``, so autograd takes
    the padding).  Through ``SSDChunkScan`` on either device: on the card
    the kernel (float32, chunks up to 256), on the CPU the plain
    version."""
    s = x.shape[1]
    chunk = min(chunk, s) if s % chunk == 0 else chunk
    pad = -s % chunk
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, dt, B, C))
    args = [t.contiguous() for t in (x, dt, A, B, C)]
    y, state = SSDChunkScan.apply(*args, chunk)
    return y[:, :s], state
