"""CUDA kernel wrappers: feature-row gather and fanout mean
(``csrc/feature_gather.cu``).

The counterparts of the reference's Pallas ``feature_gather_rows`` and
``feature_gather_mean``, which share one body there and one kernel here:
a warp per output row reads the gathered rows straight from device memory
with the widest vector load the row length allows.  The wrappers check
their inputs, allocate the output and launch on the current stream; they
take CUDA tensors only (``kernels.ops`` sends CPU tensors to the plain
versions in ``kernels.ref``).  Ids must lie in ``[0, N)``: checking them
would cost a device round trip per call, and the sampler that produces
them never leaves that range.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p)


def _vec_width(table: torch.Tensor, out: torch.Tensor) -> int:
    """Widest float vector (4, 2 or 1) that divides the row length and
    to whose size both base pointers are aligned."""
    F = table.shape[1]
    for vec in (4, 2):
        if F % vec == 0 and all(x.data_ptr() % (4 * vec) == 0
                                for x in (table, out)):
            return vec
    return 1


def _gather(table: torch.Tensor, ids2d: torch.Tensor, what: str
            ) -> torch.Tensor:
    if not (table.is_cuda and table.dtype == torch.float32
            and table.dim() == 2 and table.is_contiguous()):
        raise ValueError(f"{what}: table must be a contiguous 2-d float32 "
                         f"CUDA tensor, got {table.dtype} "
                         f"{tuple(table.shape)} on {table.device}")
    if not (ids2d.is_cuda and ids2d.dtype == torch.int32
            and ids2d.is_contiguous()):
        raise ValueError(f"{what}: ids must be a contiguous int32 CUDA "
                         f"tensor, got {ids2d.dtype} on {ids2d.device}")
    if ids2d.device != table.device:
        raise ValueError(f"{what}: table and ids on different devices")
    M, K = ids2d.shape
    F = table.shape[1]
    out = torch.empty((M, F), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    fn = _build.function("feature_gather", "feature_gather_launch",
                         _ARGTYPES)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    _build.check(fn(table.data_ptr(), F, ids2d.data_ptr(), M, K,
                    out.data_ptr(), _vec_width(table, out), stream), what)
    LAUNCHES[what] += 1
    return out


def feature_gather_rows(table: torch.Tensor, ids: torch.Tensor
                        ) -> torch.Tensor:
    """table (N, F) float32, ids (R,) int32 -> (R, F) exact row copy."""
    if ids.dim() != 1:
        raise ValueError(f"feature_gather_rows: ids must be 1-d, got "
                         f"{tuple(ids.shape)}")
    return _gather(table, ids[:, None], "feature_gather_rows")


def feature_gather_mean(table: torch.Tensor, ids: torch.Tensor
                        ) -> torch.Tensor:
    """table (N, F) float32, ids (M, K) int32 -> (M, F) float32 fanout
    mean, summed as ``row_k / K`` in k order."""
    if ids.dim() != 2:
        raise ValueError(f"feature_gather_mean: ids must be 2-d, got "
                         f"{tuple(ids.shape)}")
    return _gather(table, ids, "feature_gather_mean")
