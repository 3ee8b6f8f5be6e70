"""Synthetic data (twin of ``repro/data/synthetic.py``).

1. The MNIST-proxy multi-task generator: class-conditional Gaussians in
   R^p whose class-mean directions are shared up to a per-task rotation
   (``relatedness=1`` identical tasks, ``0`` independent).  Pure numpy:
   for the same arguments the arrays are exactly the reference's, so
   both packages fit the same data.
2. The LM token stream: ``token_batch`` and ``token_stream`` draw the
   reference's tokens bit for bit (``repro_torch.net.prng``'s threefry
   ``split`` and ``randint``) on the host, then copy each batch to the
   device once.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.net import prng


def _task_directions(rng: np.random.Generator, T: int, p: int,
                     relatedness: float) -> np.ndarray:
    """Unit class-mean directions per task with controlled similarity."""
    base = rng.normal(size=p)
    base /= np.linalg.norm(base)
    dirs = []
    for _ in range(T):
        indep = rng.normal(size=p)
        indep /= np.linalg.norm(indep)
        d = relatedness * base + (1.0 - relatedness) * indep
        d /= np.linalg.norm(d)
        dirs.append(d)
    return np.stack(dirs)                                   # (T, p)


def sample_task(rng: np.random.Generator, direction: np.ndarray, n_pos: int,
                n_neg: int, noise: float,
                margin: float) -> Tuple[np.ndarray, np.ndarray]:
    p = direction.shape[0]
    xp = margin * direction + noise * rng.normal(size=(n_pos, p))
    xn = -margin * direction + noise * rng.normal(size=(n_neg, p))
    X = np.concatenate([xp, xn]).astype(np.float32)
    y = np.concatenate([np.ones(n_pos), -np.ones(n_neg)]).astype(np.float32)
    perm = rng.permutation(len(y))
    return X[perm], y[perm]


def make_multitask_data(
    *,
    V: int,
    T: int,
    p: int = 10,
    n_train: np.ndarray,            # (V, T) samples per node per task
    n_test: int = 1800,
    relatedness: float = 0.85,
    noise: float = 1.0,
    margin: float = 1.0,
    pos_frac: Optional[np.ndarray] = None,   # (V, T) positive-label fraction
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Returns padded arrays:

    X (V,T,Nmax,p), y (V,T,Nmax), mask (V,T,Nmax),
    X_test (T,n_test,p), y_test (T,n_test).
    """
    rng = np.random.default_rng(seed)
    dirs = _task_directions(rng, T, p, relatedness)
    n_train = np.asarray(n_train, int)
    if pos_frac is None:
        pos_frac = np.full((V, T), 0.5)
    Nmax = max(int(n_train.max()), 1)
    X = np.zeros((V, T, Nmax, p), np.float32)
    y = np.zeros((V, T, Nmax), np.float32)
    mask = np.zeros((V, T, Nmax), np.float32)
    for v in range(V):
        for t in range(T):
            n = int(n_train[v, t])
            if n == 0:
                continue
            npos = int(round(pos_frac[v, t] * n))
            npos = min(max(npos, 0), n)
            Xd, yd = sample_task(rng, dirs[t], npos, n - npos, noise, margin)
            X[v, t, :n] = Xd
            y[v, t, :n] = yd
            mask[v, t, :n] = 1.0
    X_test = np.zeros((T, n_test, p), np.float32)
    y_test = np.zeros((T, n_test), np.float32)
    for t in range(T):
        Xd, yd = sample_task(rng, dirs[t], n_test // 2, n_test - n_test // 2,
                             noise, margin)
        X_test[t] = Xd
        y_test[t] = yd
    return {"X": X, "y": y, "mask": mask, "X_test": X_test, "y_test": y_test,
            "dirs": dirs}


def split_counts(total: int, V: int) -> np.ndarray:
    """Spread ``total`` samples across V nodes (paper's per-node split)."""
    base = total // V
    out = np.full(V, base, int)
    out[: total - base * V] += 1
    return out


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------
def token_batch(key, vocab_size: int, batch: int, seq: int,
                device=None) -> Dict[str, torch.Tensor]:
    """One (tokens, targets) pair of the deterministic synthetic stream
    for the threefry key ``key`` (``prng.key``/``prng.split``): int32
    (batch, seq) views of one (batch, seq + 1) draw on ``device``
    (``None`` means ``"cuda"``), the targets the tokens shifted by one."""
    dev = device_lib.resolve(device)
    k1, _ = prng.split(key)
    toks = torch.from_numpy(
        prng.randint(k1, (batch, seq + 1), 0, vocab_size)).to(dev)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def token_stream(seed: int, vocab_size: int, batch: int, seq: int,
                 device=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite generator of token batches: the key of ``seed`` split
    once a batch, as the reference's."""
    key = prng.key(seed)
    while True:
        key, sub = prng.split(key)
        yield token_batch(sub, vocab_size, batch, seq, device=device)
