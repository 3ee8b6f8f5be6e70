"""JAX's threefry2x32 counter PRNG in numpy: the fabric's drop stream and
the token stream's draws.

The reference draws each round's in-transit losses as
``jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed), k),
(V, V)) >= drop`` (``repro/net/fabric.py``).  This module reproduces
those bits exactly (tests/test_torch_net.py holds it bitwise against
jax's partitionable threefry), so a lossy run of the port loses the same
messages as the reference's:

- ``key(s)`` is the key ``(0, s & 0xFFFFFFFF)``: the reference runs
  with ``jax_enable_x64`` off, so a seed keeps its low 32 bits;
- ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
- element ``i`` of a draw takes the 32 bits ``x0 ^ x1`` of
  ``threefry2x32(k, (hi32(i), lo32(i)))``;
- ``uniform`` maps bits to ``max(0, f32((bits >> 9) | 0x3F800000) - 1)``;
- ``split(k, num)``'s key i is ``threefry2x32(k, (hi32(i), lo32(i)))``;
- ``randint`` is ``jax.random.randint``'s modulus rule in uint32
  (``data/synthetic.py``'s token batches draw with it).

The stream is keyed on the absolute round, so a run split across calls
draws what one long run draws.  ``keep_masks`` is what ``run_async``
uses: the host draws every round's mask of a call at once and the call
moves them to the device in one copy.
"""
from __future__ import annotations

import numpy as np

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k, x0, x1):
    """Threefry-2x32 with 20 rounds (JAX's ``threefry2x32_p``): key
    ``k = (k0, k1)``, counters ``x0``, ``x1`` (uint32 arrays of one
    shape).  Returns the two uint32 output words."""
    ks0, ks1 = np.uint32(k[0]), np.uint32(k[1])
    ks2 = np.uint32(ks0 ^ ks1 ^ np.uint32(0x1BD11BDA))
    ks = (ks0, ks1, ks2)
    x0 = np.asarray(x0, np.uint32) + ks0
    x1 = np.asarray(x1, np.uint32) + ks1
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int):
    """The key ``jax.random.PRNGKey(seed)`` (and ``jax.random.key``)
    under JAX's default 32-bit mode: ``(0, lo32)`` of seed, a negative
    seed in two's complement."""
    return (0, int(seed) & _MASK32)


def fold_in(k, data: int):
    """``jax.random.fold_in(k, data)`` for a 32-bit ``data``."""
    y0, y1 = threefry2x32(k, np.zeros(1, np.uint32),
                          np.asarray([int(data) & _MASK32], np.uint32))
    return (int(y0[0]), int(y1[0]))


def split(k, num: int = 2):
    """``jax.random.split(k, num)``: key i hashes the counter i."""
    idx = np.arange(int(num), dtype=np.uint64)
    y0, y1 = threefry2x32(k, (idx >> np.uint64(32)).astype(np.uint32),
                          (idx & np.uint64(_MASK32)).astype(np.uint32))
    return [(int(a), int(b)) for a, b in zip(y0, y1)]


def random_bits(k, shape) -> np.ndarray:
    """32 random bits per element of ``shape`` (JAX's partitionable
    ``random_bits``: each element hashes its own flat index)."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(k, (idx >> np.uint64(32)).astype(np.uint32),
                          (idx & np.uint64(_MASK32)).astype(np.uint32))
    return (y0 ^ y1).reshape(shape)


def uniform(k, shape) -> np.ndarray:
    """``jax.random.uniform(k, shape)``: float32 in [0, 1)."""
    bits = (random_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return np.maximum(np.float32(0.0), bits.view(np.float32) - np.float32(1))


def randint(k, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval, jnp.int32)``:
    int32 in [minval, maxval).  High and low 32 bits come from the two
    halves of ``split(k)``, each reduced mod the span and joined with the
    multiplier ``2^32 mod span``, every product and sum wrapping in
    uint32 as JAX computes them; the multiplier is ``(2^16 mod span)^2``
    reduced, whose square wraps too once the span passes 2^16."""
    minval, maxval = int(minval), int(maxval)
    span = np.uint32(max(maxval - minval, 1) & _MASK32)
    k1, k2 = split(k)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    with np.errstate(over="ignore"):
        m = np.uint32(2 ** 16) % span
        m = (m * m) % span
        off = ((hi % span) * m + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def keep_masks(seed: int, round0: int, rounds: int,
               drop_m: np.ndarray) -> np.ndarray:
    """(rounds, V, V) bool: ``uniform(fold_in(key(seed), k), (V, V)) >=
    drop_m`` for each absolute round k in ``[round0, round0 + rounds)``.
    With no drop anywhere every draw passes, so none is made."""
    drop_m = np.asarray(drop_m, np.float32)
    out = np.ones((rounds,) + drop_m.shape, bool)
    if not drop_m.any():
        return out
    base = key(seed)
    for i in range(rounds):
        out[i] = uniform(fold_in(base, round0 + i), drop_m.shape) >= drop_m
    return out
