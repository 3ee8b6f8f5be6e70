"""The token stream (``repro_torch.data.synthetic.token_batch`` /
``token_stream``) and the threefry draws under it (``repro_torch.net.
prng``'s ``key``, ``split`` and ``randint``), bitwise against jax 0.9.0's
partitionable threefry (``jax_threefry_partitionable`` is on).

``jax.random.randint`` squares its multiplier ``2^16 mod span`` in
uint32, so the square wraps once the span passes 2^16: vocab 65537,
151936 (qwen2's) and 256000 are here for that.  A seed keeps its low 32
bits (the reference runs with ``jax_enable_x64`` off), which seed
2^32 + 5 and the negative seeds hold.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsynthetic
from repro_torch.data import synthetic
from repro_torch.net import prng

SEEDS = (0, 1, 2 ** 32 + 5)
VOCABS = (512, 50288, 65536, 65537, 151936, 256000)
SHAPES = ((2, 9), (8, 257), ())


def _key_data(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


def test_threefry_is_partitionable():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS + (-1, -7, 2 ** 31 + 3))
def test_key_is_jax_key(seed):
    assert prng.key(seed) == _key_data(jax.random.key(seed))
    assert prng.key(seed) == _key_data(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed,num", itertools.product(SEEDS, (2, 3, 5)))
def test_split_is_bitwise(seed, num):
    got = prng.split(prng.key(seed), num)
    want = [_key_data(k) for k in jax.random.split(jax.random.key(seed),
                                                   num)]
    assert got == want


@pytest.mark.parametrize("seed,vocab", itertools.product(SEEDS, VOCABS))
def test_randint_is_bitwise(seed, vocab):
    for shape in SHAPES:
        got = prng.randint(prng.key(seed), shape, 0, vocab)
        want = np.asarray(jax.random.randint(jax.random.key(seed), shape, 0,
                                             vocab, jnp.int32))
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_randint_multiplier_wraps_past_two_to_the_sixteen():
    """Squaring 2^16 mod span in Python ints (no wrap) differs from jax
    at qwen2's vocab; the port's draw does not."""
    vocab, shape = 151936, (8, 257)
    k1, k2 = prng.split(prng.key(0))
    hi, lo = prng.random_bits(k1, shape), prng.random_bits(k2, shape)
    m = (2 ** 16 % vocab) ** 2 % vocab
    unwrapped = ((hi.astype(object) % vocab) * m
                 + lo.astype(object) % vocab) % vocab
    want = np.asarray(jax.random.randint(jax.random.key(0), shape, 0, vocab,
                                         jnp.int32))
    assert not np.array_equal(unwrapped.astype(np.int64), want)
    np.testing.assert_array_equal(prng.randint(prng.key(0), shape, 0, vocab),
                                  want)


@pytest.mark.parametrize("seed,vocab", [(0, 512), (3, 50288), (1, 151936),
                                        (2 ** 32 + 5, 256000)])
def test_token_batch_is_bitwise(seed, vocab):
    got = synthetic.token_batch(prng.key(seed), vocab, 4, 33, device="cpu")
    want = jsynthetic.token_batch(jax.random.key(seed), vocab, 4, 33)
    for k in ("tokens", "targets"):
        assert got[k].dtype == torch.int32 and got[k].shape == (4, 33)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert torch.equal(got["tokens"][:, 1:], got["targets"][:, :-1])


@pytest.mark.parametrize("vocab", (512, 151936))
def test_token_stream_is_bitwise(vocab):
    got = synthetic.token_stream(7, vocab, 2, 16, device="cpu")
    want = jsynthetic.token_stream(7, vocab, 2, 16)
    for _ in range(3):
        g, w = next(got), next(want)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
        assert torch.equal(g["tokens"][:, 1:], g["targets"][:, :-1])


def test_token_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        synthetic.token_batch(prng.key(0), 512, 1, 4)
