"""Collectives over a process group, in the reference's patterns.

The port of the reference's ``repro/distributed/collectives.py``: its
functions take a mesh axis name inside ``shard_map``; these take the
group of that axis, a ``ProcessGroup`` or ``(DeviceMesh, axis name)``,
and run on every rank of it in the same order.

* ``online_softmax_combine``: the near-data decode-attention reduction.
  Each rank holds online-softmax partials (max, sum, weighted V) over its
  slice of the KV cache; ``all_reduce(MAX)`` of the maxima, then one
  ``all_reduce(SUM)`` of the rescaled sums and weighted V together.
  Only O(heads x dim) bytes cross the link, never the KV slice.
* ``all_to_all_dispatch``: exchanges selected rows (``all_to_all_single``).
* ``ring_allgather_kv``: the ring all-gather of KV blocks, one
  ``batch_isend_irecv`` to the next rank a step.
* ``psum_scatter``: reduce-scatter (``reduce_scatter_tensor``).
* ``shard_offset``: a rank's offset along a dim its group shards.
* Tensor parallelism's region boundaries, as autograd functions:
  ``enter_region`` (identity forward, sum backward), ``exit_region`` (sum
  forward, identity backward) and ``gather_dim`` (the ranks' blocks of a
  dim, built from one ``all_reduce`` of zero-filled buffers; backward:
  the rank's block of the gradient).  ``TRAFFIC`` counts their
  ``all_reduce`` calls and bytes.

No collective moves a tensor to the host to get round its backend: one
that the backend does not serve raises (gloo serves only ``all_reduce``
and ``broadcast`` on CUDA tensors, so ranks that share a card run the
decode combine and nothing else).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_of(group):
    """The ``ProcessGroup`` of ``group``: a group, ``(DeviceMesh, axis
    name)``, or None for the default group."""
    if isinstance(group, tuple):
        mesh, axis = group
        return mesh.get_group(axis)
    return group


def _served(op: str, x: torch.Tensor, pg) -> None:
    """Raise, naming the op and the backend, where gloo is asked for a
    collective on CUDA tensors other than all_reduce and broadcast."""
    backend = dist.get_backend(pg)
    if x.is_cuda and backend == "gloo" and op not in ("all_reduce",
                                                      "broadcast"):
        raise RuntimeError(f"{op} on CUDA tensors is not served by the "
                           f"{backend} backend (ranks that share a card "
                           "run on gloo; give each rank a card of its own "
                           "for NCCL)")


def online_softmax_combine(m_local, l_local, o_local, group=None):
    """Merge per-rank online-softmax partials across ``group``.

    m_local: (...) the rank's running max of the logits; l_local: (...)
    its sum of exp(logits - m_local); o_local: (..., d) its sum of
    exp(logits - m_local) * V.  Returns the globally normalized output
    (..., d)."""
    pg = group_of(group)
    _served("all_reduce", m_local, pg)
    m_global = m_local.clone()
    dist.all_reduce(m_global, op=dist.ReduceOp.MAX, group=pg)
    scale = torch.exp(m_local - m_global)
    # the rescaled sums and weighted V in one buffer: one SUM for both
    lo = torch.cat([(l_local * scale)[..., None],
                    o_local * scale[..., None]], dim=-1)
    dist.all_reduce(lo, group=pg)
    return lo[..., 1:] / torch.clamp(lo[..., 0], min=1e-30)[..., None]


def all_to_all_dispatch(x, group=None, *, split_axis: int,
                        concat_axis: int, tiled: bool = True):
    """Split ``x`` on ``split_axis`` into one chunk per rank, send chunk
    ``i`` to rank ``i`` and concatenate the chunks received, in rank
    order, on ``concat_axis`` (``lax.all_to_all``; ``tiled=False`` stacks
    them on a new ``concat_axis`` and drops ``split_axis``, whose size
    must be the group's)."""
    pg = group_of(group)
    _served("all_to_all", x, pg)
    n = dist.get_world_size(pg)
    chunks = torch.stack(torch.chunk(x, n, dim=split_axis)).contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=pg)
    if not tiled:
        return torch.movedim(out.squeeze(split_axis + 1), 0, concat_axis)
    return torch.cat(list(out), dim=concat_axis)


def ring_allgather_kv(kv, group=None) -> list:
    """Each rank's ``kv`` passed round the ring: block ``j`` of rank
    ``r``'s list is rank ``(r - j) mod n``'s, as the reference's
    ``ppermute`` steps give them."""
    pg = group_of(group)
    _served("batch_isend_irecv", kv, pg)
    n = dist.get_world_size(pg)
    rank = dist.get_rank(pg)
    nxt = dist.get_global_rank(pg, (rank + 1) % n) if pg else (rank + 1) % n
    prv = dist.get_global_rank(pg, (rank - 1) % n) if pg else (rank - 1) % n
    blocks = [kv]
    cur = kv.contiguous()
    for _ in range(n - 1):
        recv = torch.empty_like(cur)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur, nxt, group=pg),
                dist.P2POp(dist.irecv, recv, prv, group=pg)]):
            req.wait()
        blocks.append(recv)
        cur = recv
    return blocks


def psum_scatter(x, group=None, *, scatter_dimension: int = 0,
                 tiled: bool = True):
    """Sum ``x`` over the group and keep this rank's block of
    ``scatter_dimension`` (``tiled=False``: that dim's size is the
    group's and is dropped)."""
    pg = group_of(group)
    _served("reduce_scatter", x, pg)
    n = dist.get_world_size(pg)
    xs = torch.movedim(x, scatter_dimension, 0).contiguous()
    out = torch.empty((xs.shape[0] // n,) + xs.shape[1:], dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, xs, group=pg)
    if not tiled:
        return out[0]
    return torch.movedim(out, 0, scatter_dimension)


def shard_offset(group, shard_len: int) -> int:
    """This rank's offset along a dim that ``group`` shards in blocks of
    ``shard_len``."""
    return dist.get_rank(group_of(group)) * shard_len


# ---------------------------------------------------------------------------
# Tensor parallelism over the ``model`` axis: the region boundaries
# ---------------------------------------------------------------------------

# the tensor-parallel all_reduces this process made (the region
# boundaries, the gathers and the max) and the bytes each handed to the
# backend, summed; ``reset_traffic`` zeroes them
TRAFFIC = {"all_reduce": 0, "bytes": 0}


def reset_traffic() -> None:
    TRAFFIC.update(all_reduce=0, bytes=0)


def _all_reduce(x: torch.Tensor, pg, op=dist.ReduceOp.SUM) -> None:
    TRAFFIC["all_reduce"] += 1
    TRAFFIC["bytes"] += x.numel() * x.element_size()
    dist.all_reduce(x, op=op, group=pg)


def _summed(x: torch.Tensor, pg) -> torch.Tensor:
    """``x`` summed over ``pg`` in its own dtype (a new tensor; two ranks'
    bf16 partials are added exactly and rounded once, as a float32 sum
    cast back would give, at half its bytes)."""
    _served("all_reduce", x, pg)
    out = x.clone()
    _all_reduce(out, pg)
    return out


class _EnterRegion(torch.autograd.Function):
    """Identity forward, sum over the group backward: where a tensor that
    every rank holds whole enters a computation each rank does on its own
    shard, its gradient on each rank is a part of the whole."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g.contiguous(), ctx.pg), None


class _ExitRegion(torch.autograd.Function):
    """Sum over the group forward, identity backward: each rank's partial
    sum (a product whose contraction dim it shards) becomes the whole
    result, which every rank then uses alike."""

    @staticmethod
    def forward(ctx, x, pg):
        return _summed(x.contiguous(), pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter_region(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` as it is, its gradient summed over ``group`` (Megatron's
    ``f``)."""
    return _EnterRegion.apply(x, group_of(group))


def exit_region(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group``, its gradient passed as it is
    (Megatron's ``g``)."""
    return _ExitRegion.apply(x, group_of(group))


def gather_dims(xs: list, dim: int, group=None) -> list:
    """Each tensor of ``xs`` gathered on ``dim`` as ``gather_dim`` does,
    all in one ``all_reduce`` (no gradient: the decode step's q, k and
    v)."""
    pg = group_of(group)
    n = dist.get_world_size(pg)
    flat = [torch.movedim(x, dim, 0) for x in xs]
    buf = _gathered(torch.cat([f.reshape(1, -1) for f in flat], dim=1), 0,
                    pg)
    out, at = [], 0
    for f in flat:
        k = f.numel()
        block = buf[:, at:at + k].reshape(n * f.shape[0], *f.shape[1:])
        out.append(torch.movedim(block, 0, dim))
        at += k
    return out


def _gathered(x: torch.Tensor, dim: int, pg) -> torch.Tensor:
    """Every rank's ``x`` concatenated on ``dim`` in rank order, built as
    the sum of zero-filled buffers that each hold one rank's block (gloo
    serves only ``all_reduce`` and ``broadcast`` on CUDA tensors).  The
    sum of one value and zeros is exact; a bf16 or fp16 buffer whose last
    dim is even is summed as int32 pairs, so it crosses at its own width."""
    _served("all_reduce", x, pg)
    n, r = dist.get_world_size(pg), dist.get_rank(pg)
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= n
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf.narrow(dim, r * x.shape[dim], x.shape[dim]).copy_(x)
    if x.element_size() == 2 and shape[-1] % 2 == 0:
        _all_reduce(buf.view(torch.int32), pg)
        return buf
    if x.element_size() == 2:
        wide = buf.float()
        _all_reduce(wide, pg)
        return wide.to(x.dtype)
    _all_reduce(buf, pg)
    return buf


class _Gather(torch.autograd.Function):
    """The ranks' blocks concatenated on a dim; backward: this rank's
    block of the gradient (the whole result is used alike on every
    rank)."""

    @staticmethod
    def forward(ctx, x, dim, pg):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.r = dist.get_rank(pg)
        return _gathered(x.contiguous(), dim, pg)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.r * ctx.n, ctx.n), None, None


def gather_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The blocks of ``dim`` that the ranks of ``group`` hold, whole on
    every rank, in rank order (differentiable: the gradient of this
    rank's block is its block of the whole's)."""
    return _Gather.apply(x, dim, group_of(group))
