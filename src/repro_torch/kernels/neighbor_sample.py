"""CUDA kernel wrappers: CSR fanout sampling (``csrc/neighbor_sample.cu``).

The counterparts of the reference's Pallas ``neighbor_sample`` and
``neighbor_sample_cached``: one thread per sampled entry reads its
target's CSR offsets and the one sampled neighbour directly -- from the
edge array, or, in the cached variant, from the ``(C, block_e)`` edge-block
cache through the ``block_slots`` indirection -- so no edge-block staging
and no degree limit.  The wrappers check their inputs, allocate the
output and launch on the current stream; they take CUDA tensors only
(``kernels.ops`` sends CPU tensors to the plain versions in
``kernels.ref``).  Targets must lie in ``[0, N)``, ``indptr`` must be a
valid CSR offset array and, in the cached variant, every block a target
dereferences must be resident: checking them would cost a device round
trip per call.

``edge_pad`` and ``edge_block_count`` are the reference kernels' pad rule
of the edge array, which ``storage.devcache.DeviceEdgeBlockCache`` uses to
lay out its block space.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_void_p)
_CACHED_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_int, ctypes.c_void_p)


def edge_pad(num_edges: int, block_e: int) -> int:
    """Zero padding appended to the edge array so a two-block fetch never
    runs off its end (at least one block past the data, at least two
    blocks in all)."""
    pad = (-num_edges) % block_e + block_e
    if num_edges + pad < 2 * block_e:
        pad += block_e
    return pad


def edge_block_count(num_edges: int, block_e: int) -> int:
    """Number of ``block_e``-wide blocks in the padded edge array."""
    return (num_edges + edge_pad(num_edges, block_e)) // block_e


def _int32_cuda(x: torch.Tensor, what: str, ndim: int,
                name: str = "neighbor_sample") -> None:
    if not (x.is_cuda and x.dtype == torch.int32 and x.dim() == ndim
            and x.is_contiguous()):
        raise ValueError(f"{name}: {what} must be a contiguous "
                         f"{ndim}-d int32 CUDA tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _check_rows(targets, rand, name):
    M = rand.shape[0]
    if targets.shape[0] != M:
        raise ValueError(f"{name}: {M} rows of rand for "
                         f"{targets.shape[0]} targets")


def neighbor_sample(indptr: torch.Tensor, indices: torch.Tensor,
                    targets: torch.Tensor, rand: torch.Tensor
                    ) -> torch.Tensor:
    """indptr (N+1,), indices (E,), targets (M,), rand (M, S), all int32
    on one CUDA device -> (M, S) int32 sampled neighbour ids."""
    for x, what, nd in ((indptr, "indptr", 1), (indices, "indices", 1),
                        (targets, "targets", 1), (rand, "rand", 2)):
        _int32_cuda(x, what, nd)
    _check_rows(targets, rand, "neighbor_sample")
    if len({x.device for x in (indptr, indices, targets, rand)}) != 1:
        raise ValueError("neighbor_sample: inputs on different devices")
    M, S = rand.shape
    out = torch.empty((M, S), dtype=torch.int32, device=rand.device)
    if out.numel() == 0:
        return out
    fn = _build.function("neighbor_sample", "neighbor_sample_launch",
                         _ARGTYPES)
    stream = torch.cuda.current_stream(rand.device).cuda_stream
    _build.check(fn(indptr.data_ptr(), indices.data_ptr(), indices.shape[0],
                    targets.data_ptr(), rand.data_ptr(), out.data_ptr(), M, S,
                    stream), "neighbor_sample")
    LAUNCHES["neighbor_sample"] += 1
    return out


def neighbor_sample_cached(indptr: torch.Tensor, block_slots: torch.Tensor,
                           targets: torch.Tensor, rand: torch.Tensor,
                           cache: torch.Tensor, *, block_e: int,
                           max_block: int) -> torch.Tensor:
    """indptr (N+1,), block_slots (NB+1,), targets (M,), rand (M, S),
    cache (C, block_e), all int32 on one CUDA device -> (M, S) int32
    sampled neighbour ids, equal to ``neighbor_sample`` over the uncached
    edge array when every dereferenced block is resident."""
    name = "neighbor_sample_cached"
    for x, what, nd in ((indptr, "indptr", 1),
                        (block_slots, "block_slots", 1),
                        (targets, "targets", 1), (rand, "rand", 2),
                        (cache, "cache", 2)):
        _int32_cuda(x, what, nd, name)
    _check_rows(targets, rand, name)
    if cache.shape[1] != block_e or block_e < 1:
        raise ValueError(f"{name}: cache rows are {cache.shape[1]} wide, "
                         f"block_e is {block_e}")
    if not 0 <= max_block < block_slots.shape[0] - 1:
        raise ValueError(f"{name}: max_block {max_block} outside the "
                         f"{block_slots.shape[0] - 1}-block slot table")
    if len({x.device for x in (indptr, block_slots, targets, rand,
                               cache)}) != 1:
        raise ValueError(f"{name}: inputs on different devices")
    M, S = rand.shape
    out = torch.empty((M, S), dtype=torch.int32, device=rand.device)
    if out.numel() == 0:
        return out
    fn = _build.function("neighbor_sample", "neighbor_sample_cached_launch",
                         _CACHED_ARGTYPES)
    stream = torch.cuda.current_stream(rand.device).cuda_stream
    _build.check(fn(indptr.data_ptr(), block_slots.data_ptr(),
                    cache.data_ptr(), block_e, max_block, targets.data_ptr(),
                    rand.data_ptr(), out.data_ptr(), M, S, stream), name)
    LAUNCHES[name] += 1
    return out
