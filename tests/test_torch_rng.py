"""The port's threefry stream against ``jax.random``: bit for bit."""

import jax
import numpy as np
import pytest
import torch

from repro_torch import rng

SPAN = 2**31 - 1


def _key_pair(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed,batch,hop,shape", [
    (0, 0, 0, (8, 3)),
    (0, 3, 1, (8, 3, 2)),
    (5, 17, 0, (1024, 25)),
    (1, 2, 2, (7,)),
    (123, 999, 1, (25600 // 64, 10)),
    (2**31 + 5, 4, 0, (3, 4, 5)),
])
def test_randint_matches_jax_sampler_stream(seed, batch, hop, shape):
    """The sampler's draw: randint(fold_in(fold_in(key(s), b), h), shape,
    0, 2**31 - 1) -- 1-, 2- and 3-d shapes and a (1024, 25) one."""
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), batch),
                            hop)
    expect = np.asarray(jax.random.randint(jk, shape, 0, SPAN))
    k = rng.fold_in(rng.fold_in(rng.key(seed), batch), hop)
    got = rng.randint(k, shape, 0, SPAN)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("seed,data", [(0, 0), (0, 1), (7, 2**32 - 1),
                                       (2**32 - 1, 12345)])
def test_fold_in_and_split_match_jax(seed, data):
    jk = jax.random.fold_in(jax.random.key(seed), data)
    k = rng.fold_in(rng.key(seed), data)
    assert k == _key_pair(jk)
    assert rng.split(k) == [_key_pair(x) for x in jax.random.split(jk)]


@pytest.mark.parametrize("lo,hi", [(0, 10), (-5, 1000), (3, SPAN),
                                   (-2**31, 2**31 - 1)])
def test_randint_other_ranges_match_jax(lo, hi):
    """Spans whose fold multiplier is not 0."""
    jk = jax.random.fold_in(jax.random.key(3), 9)
    expect = np.asarray(jax.random.randint(jk, (64, 5), lo, hi))
    got = rng.randint(rng.fold_in(rng.key(3), 9), (64, 5), lo, hi)
    np.testing.assert_array_equal(got.numpy(), expect)


def test_randint_rejects_empty_range():
    with pytest.raises(ValueError):
        rng.randint(rng.key(0), (4,), 5, 5)
