"""CUDA kernel wrappers: the flash-attention forward
(``csrc/flash_attention.cu``) and backward (``csrc/flash_attention_bwd.cu``).

The counterparts of the reference's Pallas ``_flash_fwd`` and
``_flash_bwd`` (``repro/kernels/flash_attention.py``), taking the model's
(B, S, H, D) layout through strides instead of the reference wrapper's
transposes.  All three kernels run on the tensor cores (wgmma on tiles
that TMA loads) and round P, P^T, dS^T and dS to bf16 before their
products.  Each wrapper checks its inputs, allocates its outputs and
launches on the current stream; they take CUDA tensors only
(``kernels.ops`` sends CPU tensors to the plain versions in
``kernels.ref``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, count_launch

_STRIDES = ctypes.c_int64 * 3


def _argtypes(pointers: int, strided: int) -> tuple:
    """(pointers..., B, S, Hq, Hkv, D, strides..., scale, causal, stream)"""
    return ((ctypes.c_void_p,) * pointers + (ctypes.c_int,) * 5
            + (ctypes.POINTER(ctypes.c_int64),) * strided
            + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))


_ARGTYPES = _argtypes(5, 3)
_BWD_DQ_ARGTYPES = _argtypes(8, 5)
_BWD_DKV_ARGTYPES = _argtypes(8, 4)


def check_head_dim(D: int, what: str) -> None:
    """The kernels take D a multiple of 16 up to 256."""
    if D % 16 or not 16 <= D <= 256:
        raise ValueError(f"{what}: head dim {D} is not a multiple of 16 "
                         "in [16, 256]")


def check_bshd(x: torch.Tensor, name: str, what: str) -> None:
    """A 4-d bf16 CUDA tensor whose last dim is contiguous and whose rows
    start on 16-byte boundaries (TMA's tensor maps, which read every
    kernel's q, k, v and dO, need 16-byte aligned bases and strides; the
    dQ kernel and the decode kernel also load 8 values at a time)."""
    if not (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4):
        raise ValueError(f"{what}: {name} must be a 4-d bf16 CUDA tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) \
            or x.data_ptr() % 16:
        raise ValueError(f"{what}: {name} needs a contiguous last dim and "
                         f"16-byte aligned rows, got strides {x.stride()}")


def _check_qkv(what: str, q, k, v, **like_q) -> tuple[int, ...]:
    """Check q (B, S, Hq, D), k and v (B, S, Hkv, D) and every tensor of
    ``like_q`` shaped as q; returns (B, S, Hq, Hkv, D)."""
    for name, x in dict(q=q, k=k, v=v, **like_q).items():
        check_bshd(x, name, what)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape or Hq % Hkv or any(
            x.shape != q.shape for x in like_q.values()):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, " + ", ".join(
                             f"{n} {tuple(x.shape)}" for n, x in
                             like_q.items()))
    if any(x.device != q.device for x in (k, v, *like_q.values())):
        raise ValueError(f"{what}: inputs on different devices")
    check_head_dim(D, what)
    return B, S, Hq, Hkv, D


def _check_rows(x: torch.Tensor, shape: tuple, name: str, what: str):
    """A contiguous float32 tensor of ``shape`` on x's device (lse,
    delta)."""
    if x.dtype != torch.float32 or tuple(x.shape) != shape \
            or not x.is_contiguous() or not x.is_cuda:
        raise ValueError(f"{what}: {name} must be a contiguous float32 CUDA "
                         f"tensor of shape {shape}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _rows_aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when its last dim is contiguous and its rows start on
    16-byte boundaries, else a contiguous copy (an incoming gradient may
    be expanded or transposed)."""
    if x.dim() == 4 and x.stride(3) == 1 and not any(
            s % 8 for s in x.stride()[:3]) and x.data_ptr() % 16 == 0:
        return x
    return x.contiguous()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True):
    """q (B, S, Hq, D), k and v (B, S, Hkv, D) bf16 -> ``out`` (B, S, Hq,
    D) bf16 and ``lse`` (B, Hq, S) float32."""
    what = "flash_attention_fwd"
    B, S, Hq, Hkv, D = _check_qkv(what, q, k, v)
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
    count_launch(what)
    return out, lse


def flash_attention_bwd_dq(q, k, v, out, lse, do, *, causal: bool = True):
    """The dQ kernel: q, ``out`` and ``do`` (B, S, Hq, D), k and v (B, S,
    Hkv, D) bf16, ``lse`` (B, Hq, S) float32 from the forward -> ``dq``
    (B, S, Hq, D) bf16 and ``delta`` = rowsum(do * out) (B, Hq, S)
    float32, which the dK/dV kernel takes."""
    what = "flash_attention_bwd_dq"
    B, S, Hq, Hkv, D = _check_qkv(what, q, k, v, out=out, do=do)
    _check_rows(lse, (B, Hq, S), "lse", what)
    dq = torch.empty((B, S, Hq, D), dtype=torch.bfloat16, device=q.device)
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, delta
    fn = _build.function("flash_attention_bwd",
                         "flash_attention_bwd_dq_launch", _BWD_DQ_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [_STRIDES(*x.stride()[:3]) for x in (q, k, v, out, do)]
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), B, S, Hq, Hkv, D, *strides, 1.0 / D ** 0.5,
                    int(causal), stream), what)
    count_launch(what)
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True):
    """The dK/dV kernel: q and ``do`` (B, S, Hq, D), k and v (B, S, Hkv, D)
    bf16, ``lse`` and ``delta`` (B, Hq, S) float32 -> ``dk`` and ``dv``
    (B, S, Hkv, D) bf16, each summed over the group's query heads."""
    what = "flash_attention_bwd_dkv"
    B, S, Hq, Hkv, D = _check_qkv(what, q, k, v, do=do)
    _check_rows(lse, (B, Hq, S), "lse", what)
    _check_rows(delta, (B, Hq, S), "delta", what)
    dk = torch.empty((B, S, Hkv, D), dtype=torch.bfloat16, device=q.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return dk, dv
    fn = _build.function("flash_attention_bwd",
                         "flash_attention_bwd_dkv_launch", _BWD_DKV_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [_STRIDES(*x.stride()[:3]) for x in (q, k, v, do)]
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), B, S, Hq, Hkv, D, *strides, 1.0 / D ** 0.5,
                    int(causal), stream), what)
    count_launch(what)
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True):
    """The flash backward: (dq, dk, dv) in bf16 from the forward's
    ``out`` and ``lse`` and the incoming gradient ``do``, made contiguous
    first when its rows are not 16-byte aligned.  Launches the dQ kernel,
    which also writes delta, then the dK/dV kernel, on the current
    stream."""
    do = _rows_aligned(do)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, do, causal=causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    return dq, dk, dv
