"""Network graphs for the decentralized experiments (twin of
``repro/core/graph.py``; numpy, exactly the reference's adjacencies).

Graphs are dense boolean adjacency matrices (V, V): symmetric, zero
diagonal, connected.
"""
from __future__ import annotations

import numpy as np


def ring(V: int) -> np.ndarray:
    A = np.zeros((V, V), bool)
    for v in range(V):
        A[v, (v + 1) % V] = True
        A[v, (v - 1) % V] = True
    if V <= 2:
        A = A | A.T
        np.fill_diagonal(A, False)
    return A


def full(V: int) -> np.ndarray:
    A = np.ones((V, V), bool)
    np.fill_diagonal(A, False)
    return A


def random_graph(V: int, degree: float, seed: int = 0) -> np.ndarray:
    """Connected random graph with network degree ~ ``degree`` (the
    paper's definition).  Starts from a ring and adds random edges."""
    rng = np.random.default_rng(seed)
    A = ring(V)
    target_edges = int(round(degree * V * (V - 1) / 2))
    cand = [(i, j) for i in range(V) for j in range(i + 1, V) if not A[i, j]]
    rng.shuffle(cand)
    need = max(target_edges - A.sum() // 2, 0)
    for (i, j) in cand[: int(need)]:
        A[i, j] = A[j, i] = True
    return A


def make_graph(kind: str, V: int, degree: float = 0.8,
               seed: int = 0) -> np.ndarray:
    if kind == "ring":
        return ring(V)
    if kind == "full":
        return full(V)
    if kind == "random":
        return random_graph(V, degree, seed)
    raise ValueError(f"unknown graph kind {kind!r}")


def laplacian(A: np.ndarray) -> np.ndarray:
    """Graph Laplacian L = D - A (float64, symmetric PSD, rows sum 0)."""
    A = np.asarray(A, np.float64)
    return np.diag(A.sum(1)) - A


def metropolis_weights(A: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings mixing matrix: symmetric, doubly stochastic,
    nonnegative; w_uv = 1 / (1 + max(deg_u, deg_v)) on edges, the
    diagonal absorbs the rest."""
    A = np.asarray(A, bool)
    deg = A.sum(1)
    W = np.where(A, 1.0 / (1.0 + np.maximum(deg[:, None], deg[None, :])),
                 0.0)
    np.fill_diagonal(W, 0.0)
    np.fill_diagonal(W, 1.0 - W.sum(1))
    return W


def schedule(kind: str, V: int, rounds: int, seed: int = 0,
             degree: float = 0.6, round0: int = 0) -> np.ndarray:
    """A time-varying adjacency sequence (rounds, V, V) for the fabric's
    link schedules (``repro_torch.net.schedule.TimeVaryingLinks``); every
    adjacency is symmetric, hollow and connected:

        "static"  one random graph, repeated every round
        "random"  a fresh connected random graph per round
        "ring"    the ring, repeated

    Rounds are seeded independently, so ``round0`` enters the sequence
    mid-way at O(rounds) cost and a resumed session sees exactly the
    rows ``[round0, round0 + rounds)``.
    """
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if kind == "static":
        A = random_graph(V, degree, seed)
        return np.broadcast_to(A, (rounds,) + A.shape).copy()
    if kind == "ring":
        A = ring(V)
        return np.broadcast_to(A, (rounds,) + A.shape).copy()
    if kind == "random":
        return np.stack([random_graph(V, degree, seed + 7919 * (round0 + r))
                         for r in range(rounds)]) if rounds else \
            np.zeros((0, V, V), bool)
    raise ValueError(f"unknown schedule kind {kind!r}; "
                     f"expected 'static', 'random' or 'ring'")


def network_degree(A: np.ndarray) -> float:
    V = A.shape[0]
    if V <= 1:
        return 0.0
    return float(A.sum(1).mean() / (V - 1))


def is_connected(A: np.ndarray) -> bool:
    V = A.shape[0]
    seen = {0}
    frontier = [0]
    while frontier:
        v = frontier.pop()
        for u in np.nonzero(A[v])[0]:
            if u not in seen:
                seen.add(int(u))
                frontier.append(int(u))
    return len(seen) == V
