"""CUDA kernel wrapper: the flash-attention forward
(``csrc/flash_attention.cu``).

The counterpart of the reference's Pallas ``_flash_fwd``
(``repro/kernels/flash_attention.py``), taking the model's (B, S, H, D)
layout through strides instead of the reference wrapper's transposes.
The wrapper checks its inputs, allocates ``out`` and ``lse`` and launches
on the current stream; it takes CUDA tensors only (``kernels.ops`` sends
CPU tensors to the plain version in ``kernels.ref``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build

_STRIDES = ctypes.c_int64 * 3
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5
             + (ctypes.POINTER(ctypes.c_int64),) * 3
             + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))


def check_head_dim(D: int, what: str) -> None:
    """The kernels take D a multiple of 16 up to 256."""
    if D % 16 or not 16 <= D <= 256:
        raise ValueError(f"{what}: head dim {D} is not a multiple of 16 "
                         "in [16, 256]")


def check_bshd(x: torch.Tensor, name: str, what: str) -> None:
    """A 4-d bf16 CUDA tensor whose last dim is contiguous and whose rows
    start on 16-byte boundaries (the kernels load 8 values at a time)."""
    if not (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4):
        raise ValueError(f"{what}: {name} must be a 4-d bf16 CUDA tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) \
            or x.data_ptr() % 16:
        raise ValueError(f"{what}: {name} needs a contiguous last dim and "
                         f"16-byte aligned rows, got strides {x.stride()}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True):
    """q (B, S, Hq, D), k and v (B, S, Hkv, D) bf16 -> ``out`` (B, S, Hq,
    D) bf16 and ``lse`` (B, Hq, S) float32."""
    what = "flash_attention_fwd"
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        check_bshd(x, name, what)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.device == k.device == v.device:
        raise ValueError(f"{what}: inputs on different devices")
    check_head_dim(D, what)
    out = torch.empty((B, S, Hq, D), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    fn = _build.function("flash_attention", "flash_attention_fwd_launch",
                         _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [_STRIDES(*x.stride()[:3]) for x in (q, k, v)]
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), B, S, Hq, Hkv, D, *strides,
                    1.0 / D ** 0.5, int(causal), stream), what)
    LAUNCHES[what] += 1
    return out, lse
