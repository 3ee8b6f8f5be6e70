"""The fabric's drop stream: JAX's threefry2x32 counter PRNG in numpy.

The reference draws each round's in-transit losses as
``jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed), k),
(V, V)) >= drop`` (``repro/net/fabric.py``).  This module reproduces
those bits exactly (tests/test_torch_net.py holds it bitwise against
jax's partitionable threefry), so a lossy run of the port loses the same
messages as the reference's:

- ``key(s)`` is the key ``(s >> 32, s & 0xFFFFFFFF)``;
- ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
- element ``i`` of a draw takes the 32 bits ``x0 ^ x1`` of
  ``threefry2x32(k, (hi32(i), lo32(i)))``;
- ``uniform`` maps bits to ``max(0, f32((bits >> 9) | 0x3F800000) - 1)``.

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
    """The key ``jax.random.PRNGKey(seed)``: ``(hi32, lo32)`` of seed."""
    seed = int(seed)
    return ((seed >> 32) & _MASK32, seed & _MASK32)


def fold_in(k, data: int):
    """``jax.random.fold_in(k, data)`` for a 32-bit ``data``."""
    y0, y1 = threefry2x32(k, np.zeros(1, np.uint32),
                          np.asarray([int(data) & _MASK32], np.uint32))
    return (int(y0[0]), int(y1[0]))


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
