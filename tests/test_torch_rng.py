"""The port's threefry stream against ``jax.random``: bit for bit."""

import jax
import jax.numpy as jnp
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


@pytest.mark.parametrize("seed,index,n,shape", [
    (0, 0, 1, (7,)), (0, 3, 5, (256, 129)), (42, 11, 12, (3, 4, 5)),
    (2**32 - 1, 1, 2, (1000,))])
def test_normal_matches_jax_normal(seed, index, n, shape):
    """``rng.normal`` against ``jax.random.normal`` (float32) under
    ``split(key(seed), n)[index]``, the weight draw's keys: within rtol
    1e-5, atol 3e-5 (``erfinv`` rounds apart from XLA's in the last
    bits), and in [-5.4, 5.4] (the uniform's open ends)."""
    jk = jax.random.split(jax.random.key(seed), n)[index]
    want = np.asarray(jax.random.normal(jk, shape, jnp.float32))
    got = rng.normal(rng.split(rng.key(seed), n)[index], shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=3e-5)
    assert float(got.abs().max()) < 5.5


@pytest.mark.parametrize("start", [2**32, 2**32 + 5, 2**33 - 3,
                                   5 * 2**32 + 77])
def test_random_bits_counter_past_two_to_the_32(start):
    """Past 2**32 entries the counter's first word is the flat index's
    high 32 bits, as JAX's ``iota_2x32_shape`` builds it: the chunk
    against ``jax._src.prng.threefry_2x32`` on the hand-built (hi, lo)
    counter pairs."""
    from jax._src import prng
    k = (123, 456)
    got = rng.random_bits(k, (6 * 2**32,), start=start, count=10)
    idx = np.arange(start, start + 10, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out = np.asarray(prng.threefry_2x32(jnp.asarray(np.array(k, np.uint32)),
                                        jnp.asarray(np.stack([hi, lo]))))
    np.testing.assert_array_equal(got.numpy(),
                                  (out[0] ^ out[1]).astype(np.int64))


def test_chunked_draws_equal_whole_draws():
    """Bits and normals drawn a chunk at a time (odd chunk sizes, into a
    bf16 ``out`` too) equal the whole draw bit for bit."""
    k = rng.split(rng.key(9), 3)[2]
    shape = (37, 129)
    whole = rng.random_bits(k, shape)
    parts = [rng.random_bits(k, shape, start=s, count=min(1000, 37 * 129 - s))
             for s in range(0, 37 * 129, 1000)]
    assert torch.equal(torch.cat(parts).reshape(shape), whole)
    x = rng.normal(k, shape, scale=0.25)
    assert torch.equal(rng.normal(k, shape, scale=0.25, chunk=777), x)
    out = torch.empty(shape, dtype=torch.bfloat16)
    rng.normal(k, shape, scale=0.25, chunk=1000, out=out)
    assert torch.equal(out, x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        rng.random_bits(k, shape, start=37 * 129 - 5, count=10)
