"""Elastic node membership: enter / leave / crash / recover (twin of
``repro/net/elastic.py``; host numpy, the reference's code).

The paper's Fig. 7 has *tasks* entering and leaving a live network; this
module gives the fabric the same elasticity at the NODE level, following
the heterogeneous-participation models of arXiv:1609.09563 and
arXiv:2410.03403.  The consensus topology (``prob.adj`` — what defines
the compiled plan's counts and constraints) never changes and the round
loop's shapes stay static: membership is an ACTIVE-NODE MASK over the rounds,
plus two per-round maintenance masks the fabric applies with
value-level ``where``s (``Fabric.apply_membership``):

    enter    a new node joins: it starts computing, its incident
             mailboxes warm-fill (both directions, metered)
    leave    a GRACEFUL departure: neighbors know — the node's edges
             are withdrawn and its mailbox contributions are
             garbage-collected immediately
    crash    an ABRUPT death: neighbors don't know — they keep paying
             bytes to send into the void, and the dead node's stale
             values linger in their mailboxes until the
             bounded-staleness policy (``NetConfig.stale_limit``) ages
             them out
    recover  the crashed node rejoins (optionally from a saved state:
             the session grafts its rows, ``node_recover(from_state=)``);
             its incident mailboxes warm-fill like an enter

Four derived per-round masks drive the rounds (``Membership.masks``):
``alive`` gates activation (a dead node freezes, exactly the schedule
semantics), ``gone`` withdraws a leaver's incident links, ``gc`` and
``fill`` fire the fabric maintenance on the event round.  Emission is
host-side numpy and CONTINUATION-SAFE: ``masks(V, rounds, round0=k)``
replays all events before ``k`` into the starting status, so a session
resuming mid-stream sees the same masks as one long run.

Consensus weights: the Metropolis-Hastings mixing matrix of the
ALIVE-induced subgraph (``metropolis``, via
``core.graph.metropolis_weights``) is recomputed per membership epoch;
it stays symmetric doubly stochastic with dead nodes as fixed points
(tests/test_torch_churn.py holds it).  The Prop.-1 iteration keeps its
compiled count-based invariants: masking is data, never structure.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import graph as graph_lib

#: the event vocabulary; status transitions are idempotent (see
#: ``Membership.masks`` — re-entering an alive node is a value no-op)
KINDS = ("enter", "leave", "crash", "recover")

# internal per-node status codes
_ALIVE, _CRASHED, _LEFT = 0, 1, 2


@dataclass(frozen=True)
class MembershipEvent:
    """One node-level membership event at an absolute round.

    ``round`` is the ABSOLUTE round index (the fabric's round counter,
    not an offset into one ``run_async`` call), so a schedule split
    across session stages fires each event exactly once.
    """
    round: int
    kind: str
    node: int

    def __post_init__(self):
        if self.round < 0:
            raise ValueError(f"event round must be >= 0, got {self.round}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown membership kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.node < 0:
            raise ValueError(f"node must be >= 0, got {self.node}")

    def to_dict(self) -> dict:
        """Plain-python form (msgpack/json-ready)."""
        return {"round": int(self.round), "kind": self.kind,
                "node": int(self.node)}

    @classmethod
    def from_dict(cls, d: dict) -> "MembershipEvent":
        """Inverse of ``to_dict``."""
        return cls(round=int(d["round"]), kind=d["kind"],
                   node=int(d["node"]))


@dataclass(frozen=True)
class Membership:
    """A node-membership schedule: initial statuses + timed events.

    ``events`` fire at their absolute round, BEFORE that round's
    exchange; ``initial`` is an optional (V,) status-code array
    (``status_codes`` builds one from alive/left masks) for sessions
    whose nodes already died in an earlier stage.  ``Membership()``
    (no events, everyone alive) is the identity — ``run_async`` treats
    it exactly like ``membership=None``, keeping the buffer fast path
    and the bitwise-vmap contract.
    """
    events: Tuple[MembershipEvent, ...] = ()
    initial: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        evs = tuple(e if isinstance(e, MembershipEvent)
                    else MembershipEvent(**e) for e in self.events)
        object.__setattr__(self, "events", evs)
        if self.initial is not None:
            object.__setattr__(self, "initial",
                               tuple(int(s) for s in self.initial))

    @property
    def is_trivial(self) -> bool:
        """True when membership can never diverge from all-alive —
        no events and no initially dead node (the identity config)."""
        return not self.events and (
            self.initial is None or all(s == _ALIVE for s in self.initial))

    def _initial_status(self, V: int) -> np.ndarray:
        if self.initial is None:
            return np.zeros(V, np.int8)
        if len(self.initial) != V:
            raise ValueError(f"initial statuses have length "
                             f"{len(self.initial)}, expected V={V}")
        return np.asarray(self.initial, np.int8)

    def masks(self, V: int, rounds: int, *, round0: int = 0
              ) -> Dict[str, np.ndarray]:
        """The four per-round mask arrays for rounds [round0, round0+rounds).

        Returns ``{"alive": (rounds, V) f32, "gone": (rounds, V) bool,
        "gc": (rounds, V) bool, "fill": (rounds, V) bool}``.  An event
        at round k is reflected in row k (it fires before the round's
        exchange); events before ``round0`` are replayed into the
        starting status, so splitting a run across calls emits the
        same masks — the continuation-safety contract.

        Transitions are idempotent: ``gc`` fires only when a LIVE node
        leaves, ``fill`` only when a DEAD (or absent) node comes up —
        replaying "crash" on a corpse or "enter" on a live node is a
        value no-op, which is what makes randomly generated chaos
        schedules (tests/test_torch_churn.py) well-defined.
        """
        status = self._initial_status(V)
        events = sorted(enumerate(self.events),
                        key=lambda ie: (ie[1].round, ie[0]))
        for _, e in events:
            if e.node >= V:
                raise ValueError(f"event node {e.node} out of range for "
                                 f"V={V}")
        alive = np.zeros((rounds, V), np.float32)
        gone = np.zeros((rounds, V), bool)
        gc = np.zeros((rounds, V), bool)
        fill = np.zeros((rounds, V), bool)

        def apply(e: MembershipEvent, k: Optional[int]) -> None:
            s = status[e.node]
            if e.kind in ("enter", "recover"):
                if s != _ALIVE:
                    status[e.node] = _ALIVE
                    if k is not None:
                        fill[k, e.node] = True
            elif e.kind == "leave":
                if s == _ALIVE:
                    status[e.node] = _LEFT
                    if k is not None:
                        gc[k, e.node] = True
                elif s == _CRASHED:
                    status[e.node] = _LEFT
            elif e.kind == "crash":
                if s == _ALIVE:
                    status[e.node] = _CRASHED

        i = 0
        while i < len(events) and events[i][1].round < round0:
            apply(events[i][1], None)
            i += 1
        for k in range(rounds):
            rnd = round0 + k
            while i < len(events) and events[i][1].round == rnd:
                apply(events[i][1], k)
                i += 1
            alive[k] = (status == _ALIVE).astype(np.float32)
            gone[k] = status == _LEFT
        return {"alive": alive, "gone": gone, "gc": gc, "fill": fill}

    def alive_at(self, V: int, rnd: int) -> np.ndarray:
        """The (V,) alive mask in effect DURING absolute round ``rnd``
        (after that round's events fired)."""
        return self.masks(V, 1, round0=rnd)["alive"][0]

    def epochs(self, V: int, rounds: int, *, round0: int = 0):
        """Membership epochs inside the window: ``[(start_round,
        alive_mask), ...]`` — one entry per distinct alive mask, in
        order.  The per-epoch Metropolis weights (``metropolis``) are
        what a weight-based consensus deployment would recompute at
        each entry."""
        m = self.masks(V, rounds, round0=round0)["alive"]
        out = []
        for k in range(rounds):
            if not out or not np.array_equal(out[-1][1], m[k]):
                out.append((round0 + k, m[k].copy()))
        return out

    def to_dict(self) -> dict:
        """Plain-python form for logs/snapshots; ``from_dict`` inverts."""
        return {"events": [e.to_dict() for e in self.events],
                "initial": None if self.initial is None
                else [int(s) for s in self.initial]}

    @classmethod
    def from_dict(cls, d: dict) -> "Membership":
        """Rebuild a Membership from ``to_dict``'s plain form."""
        init = d.get("initial")
        return cls(events=tuple(MembershipEvent.from_dict(e)
                                for e in d["events"]),
                   initial=None if init is None else tuple(init))


def status_codes(alive, left=None) -> Tuple[int, ...]:
    """(V,) status codes from masks: dead nodes default to CRASHED
    unless ``left`` marks them as graceful leavers.  The session layer
    uses this to hand its node bookkeeping to ``Membership(initial=)``.
    """
    alive = np.asarray(alive).astype(bool)
    left = (np.zeros_like(alive) if left is None
            else np.asarray(left).astype(bool))
    codes = np.where(alive, _ALIVE, np.where(left, _LEFT, _CRASHED))
    return tuple(int(c) for c in codes)


def metropolis(adj, alive) -> np.ndarray:
    """Metropolis-Hastings weights of the ALIVE-induced subgraph.

    Masks ``adj`` to the live nodes and delegates to
    ``core.graph.metropolis_weights`` — the result is symmetric doubly
    stochastic with every dead node an exact fixed point (weight-1 self
    loop), the certificate that masked consensus still averages over
    exactly the survivors.  Recomputed per membership epoch
    (``Membership.epochs``); reported, and pinned doubly-stochastic by
    tests/test_torch_churn.py.
    """
    adj = np.asarray(adj, bool)
    alive = np.asarray(alive).astype(bool)
    sub = adj & alive[:, None] & alive[None, :]
    return graph_lib.metropolis_weights(sub)


def combine_links(links: Optional[np.ndarray], masks: Dict[str, np.ndarray],
                  adj: np.ndarray) -> np.ndarray:
    """Intersect a schedule's per-round links with membership gating.

    A message can cross edge (u -> v) at round k only when the sender
    ``u`` is alive (dead nodes publish nothing) and the receiver ``v``
    has not gracefully LEFT (its neighbors withdrew the link).  A
    *crashed* receiver keeps its incoming edges — neighbors don't know
    it died, so they keep spending bytes into its mailbox: exactly the
    waste a crash costs over a graceful leave.
    """
    rounds = masks["alive"].shape[0]
    send_ok = masks["alive"] > 0                       # (rounds, V)
    recv_ok = ~masks["gone"]                           # (rounds, V)
    mem = recv_ok[:, :, None] & send_ok[:, None, :]    # (rounds, V, V)
    base = (np.broadcast_to(np.asarray(adj, bool), (rounds,) + adj.shape)
            if links is None else np.asarray(links, bool))
    return base & mem


def events_in(membership: Optional[Membership], rounds: int,
              round0: int = 0) -> Sequence[MembershipEvent]:
    """The events firing inside the window (meter/report bookkeeping)."""
    if membership is None:
        return []
    return [e for e in membership.events
            if round0 <= e.round < round0 + rounds]
