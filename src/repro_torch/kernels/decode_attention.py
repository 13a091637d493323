"""CUDA kernel wrapper: decode attention (``csrc/decode_attention.cu``).

The counterpart of the reference's Pallas ``decode_attention``
(``repro/kernels/decode_attention.py``): one token's GQA attention over a
(B, S, Hkv, D) KV cache with a valid length and a sliding window, both
host ints passed by value.  The wrapper clips the key range to the valid
keys, cuts it into slices so that the card has a few blocks per SM,
allocates the output and launches one kernel on the current stream: each
block attends over its slice on the tensor cores and writes a float32
partial, and the last block of each (batch, kv head) combines them.  The
partials' workspace and the blocks' tickets are kept per (device, stream),
created once (the tickets zeroed; each launch leaves them zero) and grown
when a launch needs more: launches on one stream run in order, so none
shares them with another while it runs.  So a call allocates only its
output.  It takes CUDA tensors only (``kernels.ops`` sends CPU tensors to
the plain version in ``kernels.ref``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.flash_attention import check_bshd, check_head_dim

_STRIDES = ctypes.c_int64 * 3
_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4
             + (ctypes.POINTER(ctypes.c_int64),) * 2 + (ctypes.c_int,) * 4
             + (ctypes.c_float, ctypes.c_void_p))
TILE = 64                       # keys per tile (kTK in the source)
BLOCKS_PER_SM = 4
MAX_SMEM = 232448               # bytes a block may use on Hopper
_FN = None                      # the launch entry point, resolved once
# (device index, stream) -> (float32 partials, int32 tickets)
_WORK: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def valid_range(S: int, valid_len: int, window: int) -> tuple[int, int]:
    """The keys [lo, hi) that the reference's mask leaves valid."""
    lo = max(0, valid_len - window) if window > 0 else 0
    return lo, min(valid_len, S)


def split_plan(n_keys: int, blocks: int, sms: int) -> tuple[int, int]:
    """(split_len, nsplit): whole tiles per slice, so that ``blocks``
    (batch x kv heads) times the slices fill ``BLOCKS_PER_SM`` blocks on
    each of ``sms`` SMs where the keys allow."""
    tiles = -(-n_keys // TILE)
    want = max(1, -(-BLOCKS_PER_SM * sms // blocks))
    split_len = TILE * -(-tiles // min(want, tiles))
    return split_len, -(-n_keys // split_len)


@functools.lru_cache(maxsize=None)
def _smem_bytes(group: int, D: int) -> int:
    return _build.function(
        "decode_attention", "decode_attention_smem_bytes",
        (ctypes.c_int, ctypes.c_int), restype=ctypes.c_int64)(group, D)


def _workspace(device: torch.device, stream: int, floats: int,
               tickets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (device, stream)'s float32 partials and int32 tickets, at least
    ``floats`` and ``tickets`` long; a new tickets tensor is zeroed."""
    key = (device.index, stream)
    work, tick = _WORK.get(key, (None, None))
    if work is None or work.numel() < floats:
        work = torch.empty(floats, dtype=torch.float32, device=device)
    if tick is None or tick.numel() < tickets:
        tick = torch.zeros(tickets, dtype=torch.int32, device=device)
    _WORK[key] = (work, tick)
    return work, tick


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: int, window: int = 0) -> torch.Tensor:
    """q (B, Hq, D), k and v (B, S, Hkv, D) bf16 -> (B, Hq, D) bf16."""
    global _FN
    what = "decode_attention"
    if not (q.is_cuda and q.dtype == torch.bfloat16 and q.dim() == 3):
        raise ValueError(f"{what}: q must be a 3-d bf16 CUDA tensor, got "
                         f"{q.dtype} {tuple(q.shape)} on {q.device}")
    check_bshd(k, "k", what)
    check_bshd(v, "v", what)
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.device == k.device == v.device:
        raise ValueError(f"{what}: inputs on different devices")
    check_head_dim(D, what)
    lo, hi = valid_range(S, int(valid_len), int(window))
    if hi <= lo:
        raise ValueError(f"{what}: no valid key (cache length {S}, "
                         f"valid_len {valid_len}, window {window})")
    group = Hq // Hkv
    if _smem_bytes(group, D) > MAX_SMEM:
        raise ValueError(f"{what}: group {group} at head dim {D} needs more "
                         "shared memory than a block has")
    if not q.is_contiguous():
        q = q.contiguous()
    if q.data_ptr() % 16:
        raise ValueError(f"{what}: q must start on a 16-byte boundary")
    out = torch.empty((B, Hq, D), dtype=torch.bfloat16, device=q.device)
    if out.numel() == 0:
        return out
    split_len, nsplit = split_plan(hi - lo, B * Hkv,
                                   _sm_count(q.device.index))
    if _FN is None:
        _FN = _build.function("decode_attention", "decode_attention_launch",
                              _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    work, tickets = _workspace(q.device, stream, B * Hq * nsplit * (D + 2),
                               B * Hkv)
    _build.check(_FN(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     work.data_ptr(), tickets.data_ptr(), B, Hq, Hkv, D,
                     _STRIDES(*k.stride()[:3]), _STRIDES(*v.stride()[:3]),
                     lo, hi, split_len, nsplit, 1.0 / D ** 0.5, stream), what)
    count_launch(what)
    return out
