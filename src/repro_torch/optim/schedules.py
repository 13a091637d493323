"""LR schedules: plain float functions of the step.

The port of the reference's ``repro/optim/schedules.py``.  The reference
evaluates them in float32 with jnp; here every constant is rounded to
float32 and every operation runs on numpy float32 scalars in the same
order, and the cosine is the C library's float32 ``cosf`` (what XLA's
CPU backend computes; numpy's and PyTorch's own float32 cosines differ
from it by an ulp at ~1 % and ~5 % of the arguments), so the values equal
the reference's.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np

F32 = np.float32


@functools.cache
def _libm_cosf():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn


def _cosf(x: np.float32) -> np.float32:
    return F32(_libm_cosf()(float(x)))


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps`` (from
    peak/warmup at step 0), then a cosine from ``peak_lr`` down to
    ``final_frac * peak_lr`` at ``total_steps``, flat after."""

    def lr(step: int) -> float:
        s = F32(step)
        warm = F32(peak_lr) * (s + F32(1)) / F32(max(1, warmup_steps))
        t = np.clip((s - F32(warmup_steps))
                    / F32(max(1, total_steps - warmup_steps)), F32(0), F32(1))
        cos = F32(peak_lr) * (F32(final_frac) + F32((1 - final_frac) * 0.5)
                              * (F32(1) + _cosf(F32(np.pi) * t)))
        return float(warm if s < F32(warmup_steps) else cos)

    return lr


def constant(lr_val: float):
    def lr(step: int) -> float:
        return float(F32(lr_val))
    return lr
