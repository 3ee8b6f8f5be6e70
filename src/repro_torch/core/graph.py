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
