"""Threefry-2x32 counter-based random bits, bit-exact with ``jax.random``.

The reference samples neighbours with
``jax.random.randint(fold_in(fold_in(key(seed), batch), hop), shape, 0,
2**31 - 1)`` under partitionable threefry (``kernels/ops.py``
``sample_khop_kernel``).  This module reproduces that stream outside JAX,
so the port samples the same node ids as the reference at equal seeds.

A key is a pair of Python ints ``(k0, k1)``, each < 2**32: ``key``,
``fold_in`` and ``split`` are a handful of scalar rounds and run on the
host.  ``random_bits`` and ``randint`` run on whatever device they are
given, on int64 tensors masked to 32 bits (torch's ``uint32`` has no
shifts or remainders on CUDA).  ``threefry2x32`` itself is written once
over the operators ``+ ^ | << >> &``, so it takes either ints or tensors.
"""

from __future__ import annotations

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


def random_bits(k: tuple[int, int], shape, device=None) -> torch.Tensor:
    """Partitionable 32-bit ``jax.random.bits``: ``x0 ^ x1`` of threefry
    over the row-major flat index.  Returns int64 values < 2**32."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k, torch.zeros_like(idx), idx)
    return (x0 ^ x1).reshape(tuple(shape))


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
