"""CUDA kernel wrapper: the Mamba-2 SSD chunked scan
(``csrc/ssd_chunk_scan.cu``).

The counterpart of the reference's Pallas ``ssd_chunk_scan``
(``repro/kernels/ssd_chunk_scan.py``).  The wrapper checks its inputs,
allocates the outputs and the float32 scratch that passes the state before
each chunk from the kernel's first grid (the chunk states and their
recurrence) to its second (the output), and launches both on the current
stream: one counted launch.  It takes CUDA tensors only (``kernels.ops``
pads the sequence to a chunk multiple and sends CPU tensors to the plain
version in ``kernels.ref``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, count_launch

_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
MAX_CHUNK = 256      # the chunk's prefix sum is one scan over a block
MAX_DIM = 128        # p and n: the shared tiles


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int):
    """x (b, s, h, p), dt (b, s, h), A (h,), B and C (b, s, g, n),
    contiguous float32 CUDA tensors, s a multiple of ``chunk`` -> (y (b, s,
    h, p), final_state (b, h, p, n)) float32."""
    what = "ssd_chunk_scan"
    for name, t, dim in (("x", x, 4), ("dt", dt, 3), ("A", A, 1),
                         ("B", B, 4), ("C", C, 4)):
        if not (t.is_cuda and t.dtype == torch.float32 and t.dim() == dim
                and t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous {dim}-d "
                             f"float32 CUDA tensor, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if t.device != x.device:
            raise ValueError(f"{what}: inputs on different devices")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, g, n)
            or C.shape != B.shape):
        raise ValueError(f"{what}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if g < 1 or h % g:
        raise ValueError(f"{what}: {h} heads over {g} groups")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"{what}: chunk {chunk} must divide the sequence "
                         f"({s}) and be in [1, {MAX_CHUNK}]")
    if not (1 <= p <= MAX_DIM and 1 <= n <= MAX_DIM):
        raise ValueError(f"{what}: head dim {p} and state {n} must be in "
                         f"[1, {MAX_DIM}]")
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if s == 0 or b * h == 0:
        return y, state.zero_()
    prev = torch.empty((b, h, s // chunk - 1, p, n), dtype=torch.float32,
                       device=x.device)
    fn = _build.function("ssd_chunk_scan", "ssd_chunk_scan_launch",
                         _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), y.data_ptr(), state.data_ptr(),
                    prev.data_ptr(), b, s, h, p, g, n, chunk, stream),
                 what)
    count_launch(what)
    return y, state
