"""Activation and link schedules: who computes and which links exist, per
round (twin of ``repro/net/schedule.py``; host numpy, the reference's
code, so both packages emit the same masks).

A ``Schedule`` turns the synchronous "everyone steps, every edge carries"
round into the asynchronous regimes of the related work (arXiv:1609.09563,
arXiv:2410.03403):

    acts  (rounds, V)     1.0 where the node runs its Prop.-1 update this
                          round; inactive nodes freeze their state and
                          publish nothing (neighbors keep stale copies)
    links (rounds, V, V)  which directed edges can carry a message this
                          round, or None for the static consensus graph

The CONSENSUS TOPOLOGY (``prob.adj`` — what defines U, the counts and
the beta constraints) never changes: schedules only gate computation and
delivery, so the compiled Plan's invariants stay valid and staleness is
purely a property of the fabric.  Emission is host-side numpy, seeded,
and continuation-safe: ``emit(rounds, round0=k)`` returns exactly the
rows ``[k, k+rounds)`` of the infinite schedule, so an OnlineSession
resuming mid-stream sees the same sequence as one long run.

Node-level membership (``repro_torch.net.elastic``) composes ON TOP of a
schedule, after emission: ``run_async`` multiplies ``acts`` by the
membership's alive mask and intersects ``links`` through
``elastic.combine_links`` — a schedule never needs to know that the
node set is elastic, and the schedule stream (rng burn-in included)
stays identical with or without membership events.

Specs (``resolve``):

    "full"               everyone, every round (the synchronous default)
    "round_robin"        one node per round, in index order
    "partial:F"          each node active i.i.d. with probability F
    "gossip"             one random edge per round: its two endpoints
                         compute, only that edge carries
    "links:KIND:DEG"     full activation over a time-varying availability
                         graph from ``core.graph.schedule`` (KIND in
                         {static, random, ring}), intersected with adj
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core import graph as graph_lib


class Schedule:
    """Base schedule: full synchronous participation."""

    #: True when ``emit`` returns a links array (forces mailbox mode
    #: even under an identity policy — per-receiver state differs).
    varies_links = False

    def __init__(self, seed: int = 0):
        self.seed = seed

    def _acts(self, V: int, rounds: int, round0: int,
              rng: np.random.Generator) -> np.ndarray:
        return np.ones((rounds, V), np.float32)

    def _links(self, adj: np.ndarray, rounds: int, round0: int,
               rng: np.random.Generator) -> Optional[np.ndarray]:
        return None

    def emit(self, V: int, rounds: int, *, adj=None, round0: int = 0
             ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(acts, links) for absolute rounds ``[round0, round0+rounds)``.

        Deterministic in (seed, V, round0, rounds) with prefix
        consistency: the rng is burned through the first ``round0``
        rounds so resumed sessions continue the same stream.
        """
        rng = np.random.default_rng(self.seed)
        adj = (np.ones((V, V), bool) if adj is None
               else np.asarray(adj, bool))
        full_acts = self._acts(V, round0 + rounds, 0, rng)
        rng2 = np.random.default_rng(self.seed + 1)
        full_links = self._links(adj, round0 + rounds, 0, rng2) \
            if self.varies_links else None
        acts = full_acts[round0:]
        links = None if full_links is None else full_links[round0:] & adj
        return acts, links


class RoundRobin(Schedule):
    """One node computes per round, cycling in index order."""

    def _acts(self, V, rounds, round0, rng):
        acts = np.zeros((rounds, V), np.float32)
        acts[np.arange(rounds), (round0 + np.arange(rounds)) % V] = 1.0
        return acts


class Partial(Schedule):
    """Each node active i.i.d. with probability ``frac`` per round."""

    def __init__(self, frac: float, seed: int = 0):
        super().__init__(seed)
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"partial fraction must be in (0, 1], "
                             f"got {frac}")
        self.frac = frac

    def _acts(self, V, rounds, round0, rng):
        return (rng.random((rounds, V)) < self.frac).astype(np.float32)


class Gossip(Schedule):
    """Classic pairwise gossip: one random consensus edge per round; its
    endpoints compute and only that edge (both directions) carries."""

    varies_links = True

    def emit(self, V, rounds, *, adj=None, round0=0):
        if adj is None:
            raise ValueError("gossip needs the consensus adjacency")
        adj = np.asarray(adj, bool)
        iu, ju = np.nonzero(np.triu(adj, 1))
        if len(iu) == 0:
            raise ValueError("gossip on an edgeless graph")
        rng = np.random.default_rng(self.seed)
        picks = rng.integers(0, len(iu), size=round0 + rounds)[round0:]
        acts = np.zeros((rounds, V), np.float32)
        links = np.zeros((rounds, V, V), bool)
        for r, e in enumerate(picks):
            u, v = int(iu[e]), int(ju[e])
            acts[r, [u, v]] = 1.0
            links[r, u, v] = links[r, v, u] = True
        return acts, links


class TimeVaryingLinks(Schedule):
    """Full activation over a time-varying availability graph
    (``core.graph.schedule``), intersected with the consensus adj.

    Emits directly from ``round0`` (graph rounds are independently
    seeded, no rng stream to burn through) — a long-lived session's
    emission cost stays O(rounds), not O(round0 + rounds)."""

    varies_links = True

    def __init__(self, kind: str = "random", degree: float = 0.6,
                 seed: int = 0):
        super().__init__(seed)
        self.kind = kind
        self.degree = degree

    def emit(self, V, rounds, *, adj=None, round0=0):
        adj = (np.ones((V, V), bool) if adj is None
               else np.asarray(adj, bool))
        acts = np.ones((rounds, V), np.float32)
        links = graph_lib.schedule(self.kind, V, rounds, seed=self.seed,
                                   degree=self.degree, round0=round0)
        return acts, links & adj


def resolve(spec, seed: int = 0) -> Schedule:
    """A Schedule from a spec string / instance (see module docstring).

    String specs inherit ``seed`` (the NetConfig seed); an explicit
    Schedule instance keeps its own.
    """
    if isinstance(spec, Schedule):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"schedule spec must be a str or Schedule, "
                        f"got {type(spec).__name__}")
    name, _, arg = spec.partition(":")
    if name == "full":
        return Schedule(seed)
    if name == "round_robin":
        return RoundRobin(seed)
    if name == "partial":
        return Partial(float(arg or 0.5), seed)
    if name == "gossip":
        return Gossip(seed)
    if name == "links":
        kind, _, deg = arg.partition(":")
        return TimeVaryingLinks(kind or "random",
                                float(deg or 0.6), seed)
    raise ValueError(f"unknown schedule spec {spec!r}")
