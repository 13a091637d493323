"""Threefry-2x32 counter-based random bits, bit-exact with ``jax.random``.

The reference samples neighbours with
``jax.random.randint(fold_in(fold_in(key(seed), batch), hop), shape, 0,
2**31 - 1)`` under partitionable threefry (``kernels/ops.py``
``sample_khop_kernel``), and draws its initial weights with
``jax.random.normal`` under ``split(key(seed), n_leaves)[i]``
(``models/params.py``).  This module reproduces both streams outside JAX,
so the port samples the same node ids and starts from the same weights
as the reference at equal seeds.

A key is a pair of Python ints ``(k0, k1)``, each < 2**32: ``key``,
``fold_in`` and ``split`` are a handful of scalar rounds and run on the
host.  ``random_bits``, ``randint`` and ``normal`` run on whatever device
they are given, on int64 tensors masked to 32 bits (torch's ``uint32``
has no shifts or remainders on CUDA).  The counter of flat index ``i`` is
the pair ``(i >> 32, i & MASK32)``, as JAX's ``iota_2x32_shape`` builds
it, so leaves past 2**32 entries (the MoE experts) draw JAX's numbers
too.  ``threefry2x32`` is written over the operators ``+ ^ | << >> &``,
so it takes the host's ints and int64 tensors alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key, x0, x1):
    """20-round threefry-2x32 of the counter pair ``(x0, x1)`` under
    ``key``; every value is < 2**32.  Returns the output pair."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)`` for a non-negative seed < 2**32."""
    return (0, int(seed) & MASK32)


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in``: threefry of the counter ``(0, data)``."""
    return threefry2x32(k, 0, int(data) & MASK32)


def split(k: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """Partitionable ``jax.random.split``: key ``i`` is threefry of the
    counter ``(0, i)``."""
    return [threefry2x32(k, 0, i) for i in range(num)]


def random_bits(k: tuple[int, int], shape, device=None, *, start: int = 0,
                count: int | None = None) -> torch.Tensor:
    """Partitionable 32-bit ``jax.random.bits``: ``x0 ^ x1`` of threefry
    over the row-major flat index ``i``, counter ``(i >> 32, i &
    MASK32)``.  Returns int64 values < 2**32 of ``shape``; with ``count``,
    only the flat entries ``[start, start + count)`` of that draw, as a
    1-d tensor (a chunk of a leaf too large to draw at once)."""
    n = math.prod(int(d) for d in shape)
    whole = count is None
    if whole:
        if start:
            raise ValueError("random_bits: start needs count")
        count = n
    if not 0 <= start <= start + count <= n:
        raise ValueError(f"random_bits: chunk [{start}, {start + count}) "
                         f"outside a draw of {n}")
    idx = torch.arange(start, start + count, dtype=torch.int64,
                       device=device)
    x0, x1 = threefry2x32(k, idx >> 32, idx & MASK32)
    bits = x0 ^ x1
    return bits.reshape(tuple(shape)) if whole else bits


def randint(k: tuple[int, int], shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` for int32 bounds
    ``minval < maxval``; returns int32.  Two streams of bits from the
    split key are folded with a multiplier of ``(2**16 % span)**2 mod
    2**32 % span`` -- which is 0 for span = 2**31 - 1, the sampler's."""
    span = maxval - minval
    if not 0 < span < 2**32:
        raise ValueError(f"randint needs minval < maxval within int32, "
                         f"got [{minval}, {maxval})")
    k1, k2 = split(k)
    hi = random_bits(k1, shape, device)
    lo = random_bits(k2, shape, device)
    mult = ((2**16 % span) ** 2 & MASK32) % span
    off = (((hi % span) * mult) & MASK32) + lo % span
    off = (off & MASK32) % span
    return (off + minval).to(torch.int32)


# ``jax.random.normal``'s constants for float32 (``_normal_real``,
# ``_uniform``): the uniform's lower bound nextafter(-1, 0), its span
# 1 - lo rounded to float32 (2.0), and sqrt(2) in float32
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SPAN = float(np.float32(1.0) - np.float32(_LO))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def _flat_index(shape, local, dim: int, lo: int, start: int,
                count: int, device) -> torch.Tensor:
    """The row-major flat indices in a draw of ``shape`` of the entries
    ``[start, start + count)`` of its block ``local`` (``shape`` with dim
    ``dim`` cut to ``local[dim]`` entries from ``lo``)."""
    pos = torch.arange(start, start + count, dtype=torch.int64,
                       device=device)
    idx = torch.zeros_like(pos)
    stride = 1
    for d in reversed(range(len(shape))):
        coord = pos % local[d]
        pos = pos // local[d]
        if d == dim:
            coord = coord + lo
        idx += coord * stride
        stride *= shape[d]
    return idx


def normal(k: tuple[int, int], shape, *, device=None, out=None,
           scale: float = 1.0, chunk: int = 2**26,
           block: tuple[int, int] | None = None) -> torch.Tensor:
    """``scale * jax.random.normal(k, shape, float32)``, drawn ``chunk``
    entries at a time into ``out`` (a new float32 tensor on ``device``
    when None; any float dtype, contiguous).  As JAX draws it: the top 23
    bits of ``random_bits`` as the mantissa of a float in [1, 2), minus
    1, times the span plus ``lo = nextafter(-1, 0)``, clamped below at
    ``lo``; then ``float32(sqrt 2) * erfinv(u)`` and, as the reference's
    ``init_params`` multiplies by its float scale, ``* scale``, all in
    float32.  A bf16 ``out`` holds the round-to-nearest of the float32
    draw, what the reference's ``astype`` at use gives.  ``erfinv`` may
    round apart from XLA's in the last bits (a few float32 ulps).
    ``block=(dim, lo)`` draws only the block of ``shape`` whose dim
    ``dim`` starts at ``lo`` and has ``out``'s size there (a leaf's shard
    on one rank: each entry the number the whole draw puts there)."""
    shape = tuple(int(d) for d in shape)
    local = shape
    if block is not None:
        local = tuple(out.shape)
        dim, lo = block
        if len(local) != len(shape) or any(
                a != b for i, (a, b) in enumerate(zip(local, shape))
                if i != dim) or not 0 <= lo <= lo + local[dim] <= shape[dim]:
            raise ValueError(f"normal: block {tuple(local)} at {lo} on dim "
                             f"{dim} outside a draw of {shape}")
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=device)
    if tuple(out.shape) != local or not out.is_contiguous():
        raise ValueError(f"normal: out must be contiguous of shape {local}")
    flat = out.view(-1)
    n = flat.numel()
    for start in range(0, n, chunk):
        c = min(chunk, n - start)
        if block is None:
            bits = random_bits(k, shape, flat.device, start=start, count=c)
        else:
            idx = _flat_index(shape, local, block[0], block[1], start, c,
                              flat.device)
            x0, x1 = threefry2x32(k, idx >> 32, idx & MASK32)
            bits = x0 ^ x1
            del idx, x0, x1
        u = bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000).to(
            torch.int32).view(torch.float32)
        u = u.sub_(1.0).mul_(_SPAN).add_(_LO).clamp_min_(_LO)
        x = torch.special.erfinv(u).mul_(_SQRT2)
        if scale != 1.0:
            x.mul_(scale)
        flat[start:start + c].copy_(x)
        del bits, u, x
    return out
