"""CUDA kernel wrapper: CSR fanout sampling (``csrc/neighbor_sample.cu``).

The counterpart of the reference's Pallas ``neighbor_sample``: one thread
per sampled entry reads its target's CSR offsets and the one sampled
neighbour directly, so no edge-block staging and no degree limit.  The
wrapper checks its inputs, allocates the output and launches on the
current stream; it takes CUDA tensors only (``kernels.ops`` sends CPU
tensors to the plain version in ``kernels.ref``).  Targets must lie in
``[0, N)`` and ``indptr`` must be a valid CSR offset array: checking them
would cost a device round trip per call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_void_p)


def _int32_cuda(x: torch.Tensor, what: str, ndim: int) -> None:
    if not (x.is_cuda and x.dtype == torch.int32 and x.dim() == ndim
            and x.is_contiguous()):
        raise ValueError(f"neighbor_sample: {what} must be a contiguous "
                         f"{ndim}-d int32 CUDA tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def neighbor_sample(indptr: torch.Tensor, indices: torch.Tensor,
                    targets: torch.Tensor, rand: torch.Tensor
                    ) -> torch.Tensor:
    """indptr (N+1,), indices (E,), targets (M,), rand (M, S), all int32
    on one CUDA device -> (M, S) int32 sampled neighbour ids."""
    for x, what, nd in ((indptr, "indptr", 1), (indices, "indices", 1),
                        (targets, "targets", 1), (rand, "rand", 2)):
        _int32_cuda(x, what, nd)
    M, S = rand.shape
    if targets.shape[0] != M:
        raise ValueError(f"neighbor_sample: {M} rows of rand for "
                         f"{targets.shape[0]} targets")
    if len({x.device for x in (indptr, indices, targets, rand)}) != 1:
        raise ValueError("neighbor_sample: inputs on different devices")
    out = torch.empty((M, S), dtype=torch.int32, device=rand.device)
    if out.numel() == 0:
        return out
    fn =_build.function("neighbor_sample", "neighbor_sample_launch",
                         _ARGTYPES)
    stream = torch.cuda.current_stream(rand.device).cuda_stream
    _build.check(fn(indptr.data_ptr(), indices.data_ptr(), indices.shape[0],
                    targets.data_ptr(), rand.data_ptr(), out.data_ptr(), M, S,
                    stream), "neighbor_sample")
    LAUNCHES["neighbor_sample"] += 1
    return out
