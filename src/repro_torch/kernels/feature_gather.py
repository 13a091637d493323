"""CUDA kernel wrappers: feature-row gather, fanout mean and the cached
row gather (``csrc/feature_gather.cu``).

The counterparts of the reference's Pallas ``feature_gather_rows`` and
``feature_gather_mean``, which share one body there and one source here,
and of ``feature_gather_cached``, which reads each row of the device
feature cache through the node -> slot table: a warp per output row reads
the gathered rows straight from device memory with the widest vector load
the row length allows.  The mean kernel loads a row's K ids once and
reads the K source rows whole, one after another in k order (segments of
``MEAN_LANE_FLOATS`` floats a lane, the next row's loads in flight while
the current one is summed), keeping the output row's sums in registers,
and writes it by streaming stores; the cached kernel resolves a block's slots first and loads a whole
row before storing it, in a grid of one wave.  The wrappers check their
inputs, allocate the output and launch on the current stream; they
take CUDA tensors only (``kernels.ops`` sends CPU tensors to the plain
versions in ``kernels.ref``).  Ids must lie in ``[0, N)``: checking them
would cost a device round trip per call, and the sampler that produces
them never leaves that range.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, count_launch

_ARGTYPES = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p)
_CACHED_ARGTYPES = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p)
# floats of one source row a lane of the mean kernel holds (the kernel's
# kMeanFloats): rows are read in segments of 32 lanes x this many floats
MEAN_LANE_FLOATS = 20


def _vec_width(table: torch.Tensor, out: torch.Tensor) -> int:
    """Widest float vector (4, 2 or 1) that divides the row length and
    to whose size both base pointers are aligned."""
    F = table.shape[1]
    for vec in (4, 2):
        if F % vec == 0 and all(x.data_ptr() % (4 * vec) == 0
                                for x in (table, out)):
            return vec
    return 1


def _check_table(table: torch.Tensor, what: str) -> None:
    if not (table.is_cuda and table.dtype == torch.float32
            and table.dim() == 2 and table.is_contiguous()):
        raise ValueError(f"{what}: table must be a contiguous 2-d float32 "
                         f"CUDA tensor, got {table.dtype} "
                         f"{tuple(table.shape)} on {table.device}")


def _gather(table: torch.Tensor, ids2d: torch.Tensor, what: str,
            mean: bool) -> torch.Tensor:
    _check_table(table, what)
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
    _build.check(fn(table.data_ptr(), F, ids2d.data_ptr(), M, K, int(mean),
                    out.data_ptr(), _vec_width(table, out), stream), what)
    count_launch(what)
    return out


def feature_gather_rows(table: torch.Tensor, ids: torch.Tensor
                        ) -> torch.Tensor:
    """table (N, F) float32, ids (R,) int32 -> (R, F) exact row copy."""
    if ids.dim() != 1:
        raise ValueError(f"feature_gather_rows: ids must be 1-d, got "
                         f"{tuple(ids.shape)}")
    return _gather(table, ids[:, None], "feature_gather_rows", mean=False)


def feature_gather_mean(table: torch.Tensor, ids: torch.Tensor
                        ) -> torch.Tensor:
    """table (N, F) float32, ids (M, K) int32 -> (M, F) float32 fanout
    mean, summed as ``row_k / K`` in k order."""
    if ids.dim() != 2:
        raise ValueError(f"feature_gather_mean: ids must be 2-d, got "
                         f"{tuple(ids.shape)}")
    return _gather(table, ids, "feature_gather_mean", mean=True)


def feature_gather_cached(cache: torch.Tensor, slot_of: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """cache (C, F) float32, slot_of (N+1,) int32, ids (R,) int32 ->
    (R, F) exact copy of ``cache[max(slot_of[ids], 0)]``.  Ids must lie in
    ``[0, N]``."""
    name = "feature_gather_cached"
    _check_table(cache, name)
    for x, what in ((slot_of, "slot_of"), (ids, "ids")):
        if not (x.is_cuda and x.dtype == torch.int32 and x.dim() == 1
                and x.is_contiguous()):
            raise ValueError(f"{name}: {what} must be a contiguous 1-d int32 "
                             f"CUDA tensor, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
    if not slot_of.device == ids.device == cache.device:
        raise ValueError(f"{name}: inputs on different devices")
    R, F = ids.shape[0], cache.shape[1]
    out = torch.empty((R, F), dtype=torch.float32, device=cache.device)
    if out.numel() == 0:
        return out
    fn = _build.function("feature_gather", "feature_gather_cached_launch",
                         _CACHED_ARGTYPES)
    stream = torch.cuda.current_stream(cache.device).cuda_stream
    _build.check(fn(cache.data_ptr(), F, slot_of.data_ptr(), ids.data_ptr(),
                    R, out.data_ptr(), _vec_width(cache, out), stream), name)
    count_launch(name)
    return out
