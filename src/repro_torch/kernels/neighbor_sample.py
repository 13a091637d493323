"""CUDA kernel wrappers: CSR fanout sampling (``csrc/neighbor_sample.cu``).

The counterparts of the reference's Pallas ``neighbor_sample`` and
``neighbor_sample_cached``: one thread per sampled entry reads its
target's CSR offsets and the one sampled neighbour directly -- from the
edge array, or, in the cached variant, from the ``(C, block_e)`` edge-block
cache through the ``block_slots`` indirection -- so no edge-block staging
and no degree limit.  Both kernels divide by the fanout (the cached one
also by ``block_e``) with multipliers from ``fast_divisor`` and index in 32
bits (``launch_params`` and ``cached_launch_params`` refuse what does not
fit); the cached one stages a slot table of up to ``SLOT_BUDGET`` entries
in shared memory (``cached_launch_params`` picks the instance).  The wrappers check their inputs, allocate the
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

from repro_torch.kernels import _build, count_launch

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_void_p)
_CACHED_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                    ctypes.c_void_p)
# slot-table entries the cached kernel stages in shared memory (the
# kernel's kSlotBudget); a longer table is read from global memory
SLOT_BUDGET = 4096
# the kernels' numerators and indices lie below this
_NUMERATOR_LIMIT = 1 << 31


def fast_divisor(d: int) -> tuple[int, int]:
    """(mul, shift) with ``n // d == (n * mul) >> shift`` for every ``0 <=
    n < 2**31``, ``mul`` below 2**32 (the cached kernel's divisions by
    the fanout and by ``block_e``).  With ``l = ceil(log2 d)``, ``shift =
    31 + l`` and ``mul = ceil(2**shift / d) = (2**shift + e) / d``, ``0 <=
    e < d``: ``n * mul / 2**shift = n / d + n * e / (d * 2**shift)``, and
    ``n * e < 2**31 * 2**l = 2**shift`` keeps the excess below ``1 / d``,
    too little to carry the quotient past the next integer."""
    if not 1 <= d < _NUMERATOR_LIMIT:
        raise ValueError(f"fast_divisor: divisor {d} outside [1, 2**31)")
    shift = 31 + (d - 1).bit_length()
    return -(-(1 << shift) // d), shift


def _outputs(num_targets: int, fanout: int, name: str) -> int:
    total = num_targets * fanout
    if total >= _NUMERATOR_LIMIT:
        raise ValueError(f"{name}: {num_targets} x {fanout} outputs, the "
                         "kernel takes fewer than 2**31")
    return total


def launch_params(num_targets: int, fanout: int, num_edges: int) -> dict:
    """The host-side arguments of ``neighbor_sample``'s launch: the output
    count and the fanout divisor's (mul, shift) pair.  The kernel indexes
    in 32 bits: fewer than 2**31 outputs and edges."""
    total = _outputs(num_targets, fanout, "neighbor_sample")
    if num_edges >= _NUMERATOR_LIMIT:
        raise ValueError(f"neighbor_sample: {num_edges} edges, the kernel "
                         "takes fewer than 2**31")
    return {"total": total, "fanout": fast_divisor(max(fanout, 1))}


def cached_launch_params(num_targets: int, fanout: int, num_slots: int,
                         block_e: int) -> dict:
    """The host-side arguments of the cached kernel's launch: the output
    count, the divisors' (mul, shift) pairs and whether the slot table is
    staged in shared memory (at most ``SLOT_BUDGET`` entries)."""
    total = _outputs(num_targets, fanout, "neighbor_sample_cached")
    return {"total": total, "fanout": fast_divisor(max(fanout, 1)),
            "block_e": fast_divisor(block_e),
            "staged": num_slots <= SLOT_BUDGET}


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


def _int32_cuda(x: torch.Tensor, what: str, ndim: int) -> None:
    if not (x.is_cuda and x.dtype == torch.int32 and x.dim() == ndim
            and x.is_contiguous()):
        raise ValueError(f"neighbor_sample: {what} must be a contiguous "
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
    p = launch_params(M, S, indices.shape[0])
    fn = _build.function("neighbor_sample", "neighbor_sample_launch",
                         _ARGTYPES)
    stream = torch.cuda.current_stream(rand.device).cuda_stream
    _build.check(fn(indptr.data_ptr(), indices.data_ptr(), indices.shape[0],
                    targets.data_ptr(), rand.data_ptr(), out.data_ptr(), M, S,
                    *p["fanout"], stream), "neighbor_sample")
    count_launch("neighbor_sample")
    return out


def check_cached_args(indptr, block_slots, targets, rand, cache, *,
                      block_e: int, max_block: int) -> None:
    """Shapes, dtypes and layout of the cached kernel's inputs, on any
    device: any number of targets (no padding) with one rand row each."""
    name = "neighbor_sample_cached"
    for x, what, nd in ((indptr, "indptr", 1),
                        (block_slots, "block_slots", 1),
                        (targets, "targets", 1), (rand, "rand", 2),
                        (cache, "cache", 2)):
        if not (x.dtype == torch.int32 and x.dim() == nd
                and x.is_contiguous()):
            raise ValueError(f"{name}: {what} must be a contiguous {nd}-d "
                             f"int32 tensor, got {x.dtype} "
                             f"{tuple(x.shape)}")
    _check_rows(targets, rand, name)
    if cache.shape[1] != block_e or block_e < 1:
        raise ValueError(f"{name}: cache rows are {cache.shape[1]} wide, "
                         f"block_e is {block_e}")
    if not 0 <= max_block < block_slots.shape[0] - 1:
        raise ValueError(f"{name}: max_block {max_block} outside the "
                         f"{block_slots.shape[0] - 1}-block slot table")


def neighbor_sample_cached(indptr: torch.Tensor, block_slots: torch.Tensor,
                           targets: torch.Tensor, rand: torch.Tensor,
                           cache: torch.Tensor, *, block_e: int,
                           max_block: int) -> torch.Tensor:
    """indptr (N+1,), block_slots (NB+1,), targets (M,), rand (M, S),
    cache (C, block_e), all int32 on one CUDA device -> (M, S) int32
    sampled neighbour ids, equal to ``neighbor_sample`` over the uncached
    edge array when every dereferenced block is resident.  ``max_block``
    is the reference's clamp of a target's base block; the sampled entry
    does not depend on it (see the kernel's note)."""
    name = "neighbor_sample_cached"
    args = (indptr, block_slots, targets, rand, cache)
    if not all(x.is_cuda for x in args):
        raise ValueError(f"{name}: inputs must be CUDA tensors, got "
                         f"{[str(x.device) for x in args]}")
    if len({x.device for x in args}) != 1:
        raise ValueError(f"{name}: inputs on different devices")
    check_cached_args(*args, block_e=block_e, max_block=max_block)
    M, S = rand.shape
    out = torch.empty((M, S), dtype=torch.int32, device=rand.device)
    if out.numel() == 0:
        return out
    p = cached_launch_params(M, S, block_slots.shape[0], block_e)
    fn = _build.function("neighbor_sample", "neighbor_sample_cached_launch",
                         _CACHED_ARGTYPES)
    stream = torch.cuda.current_stream(rand.device).cuda_stream
    _build.check(fn(indptr.data_ptr(), block_slots.data_ptr(),
                    block_slots.shape[0], cache.data_ptr(), block_e,
                    *p["block_e"], targets.data_ptr(), rand.data_ptr(),
                    out.data_ptr(), M, S, *p["fanout"], int(p["staged"]),
                    stream), name)
    count_launch(name)
    return out
