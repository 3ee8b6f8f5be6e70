"""Link policies: what a directed edge does to a message in flight (twin
of ``repro/net/policies.py``).

A ``LinkPolicy`` describes one link's imperfections:

    delay       rounds between send and delivery (0 = the same round,
                the synchronous semantics)
    drop        i.i.d. per-round probability that a sent message is lost
                in transit (the sender still pays its bytes)
    quant       wire format of the (2p+2)-vector: "float32" (lossless),
                "float16", "int16" or "int8" (symmetric per-vector
                scale, round half to even)
    bandwidth   sender-side byte budget per round (token bucket); a round
                whose credit cannot cover the bundle skips the send.
                None = unmetered.

``NetConfig`` bundles one default policy, per-edge overrides keyed by
the directed pair ``(u, v)`` = (sender, receiver), the activation/link
schedule spec (``repro_torch.net.schedule``), the seed of every
stochastic choice, and the churn policies (bounded staleness, error
feedback).  Its ``to_dict`` is key for key the reference's.

``bytes_per_message`` charges the payload at its wire width plus a
4-byte scale word for the integer formats; ``repro_torch.net.meter``
aggregates it per edge and per round.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

#: wire-format codes, the fabric's per-edge integer matrix
QUANT_CODES: Dict[str, int] = {"float32": 0, "float16": 1,
                               "int16": 2, "int8": 3}
_QMAX = {2: 32767.0, 3: 127.0}           # code -> symmetric int range


@dataclass(frozen=True)
class LinkPolicy:
    """One directed link's behavior; the default is a perfect
    synchronous wire (zero delay, no loss, float32, unmetered)."""
    delay: int = 0
    drop: float = 0.0
    quant: str = "float32"
    bandwidth: Optional[float] = None     # bytes per round, None = inf

    def __post_init__(self):
        if self.delay < 0:
            raise ValueError(f"delay must be >= 0, got {self.delay}")
        if not 0.0 <= self.drop <= 1.0:
            raise ValueError(f"drop must be in [0, 1], got {self.drop}")
        if self.quant not in QUANT_CODES:
            raise ValueError(f"unknown quant {self.quant!r}; expected one "
                             f"of {sorted(QUANT_CODES)}")
        if self.bandwidth is not None and self.bandwidth <= 0:
            raise ValueError("bandwidth must be positive (or None)")

    @property
    def is_identity(self) -> bool:
        """True when the link is a perfect synchronous float32 wire."""
        return (self.delay == 0 and self.drop == 0.0
                and self.quant == "float32" and self.bandwidth is None)

    def to_dict(self) -> dict:
        """Plain-python form; ``from_dict`` inverts it exactly."""
        return {"delay": int(self.delay), "drop": float(self.drop),
                "quant": self.quant,
                "bandwidth": None if self.bandwidth is None
                else float(self.bandwidth)}

    @classmethod
    def from_dict(cls, d: dict) -> "LinkPolicy":
        """Rebuild a LinkPolicy from ``to_dict``'s plain form."""
        return cls(**d)


@dataclass(frozen=True)
class NetConfig:
    """The whole network's communication model.

    ``policy`` applies to every edge unless ``edge_policies[(u, v)]``
    overrides the directed link u -> v.  ``schedule`` is a spec for
    ``repro_torch.net.schedule.resolve`` or a Schedule.  ``warm_fill``
    bootstraps every mailbox from the senders' initial variables (one
    metered exchange).  ``stale_limit``: a neighbor whose edge has
    delivered nothing for more than that many rounds leaves the
    consensus reduce until it delivers again (None: any staleness).
    ``error_feedback``: the integer wire formats add the previous
    round's quantization error to the payload before quantizing, at the
    same bytes per round.
    """
    policy: LinkPolicy = field(default_factory=LinkPolicy)
    edge_policies: Optional[Mapping[Tuple[int, int], LinkPolicy]] = None
    schedule: Union[str, object] = "full"
    seed: int = 0
    warm_fill: bool = True
    stale_limit: Optional[int] = None
    error_feedback: bool = False

    def __post_init__(self):
        if self.stale_limit is not None and self.stale_limit < 0:
            raise ValueError(
                f"stale_limit must be >= 0 (or None), got {self.stale_limit}")

    def edge_policy(self, u: int, v: int) -> LinkPolicy:
        """The effective policy of the directed link u -> v."""
        if self.edge_policies:
            return self.edge_policies.get((u, v), self.policy)
        return self.policy

    @property
    def is_identity(self) -> bool:
        """True when every link is a perfect synchronous float32 wire
        and no staleness or compression policy is on.  The schedule is
        not part of it, as in the reference."""
        if self.stale_limit is not None or self.error_feedback:
            return False
        if not self.policy.is_identity:
            return False
        return not self.edge_policies or all(
            p.is_identity for p in self.edge_policies.values())

    def to_dict(self) -> dict:
        """Plain-python form (edge overrides as ``[u, v, policy_dict]``
        triples).  Only a string schedule spec has one: a Schedule
        instance raises ``TypeError``."""
        if not isinstance(self.schedule, str):
            raise TypeError(
                "NetConfig.to_dict: only string schedule specs are "
                "serializable; got a %r instance — pass the spec string "
                '(e.g. "partial:0.5") instead of a resolved Schedule'
                % type(self.schedule).__name__)
        edges = None
        if self.edge_policies:
            edges = [[int(u), int(v), p.to_dict()]
                     for (u, v), p in sorted(self.edge_policies.items())]
        return {"policy": self.policy.to_dict(), "edge_policies": edges,
                "schedule": self.schedule, "seed": int(self.seed),
                "warm_fill": bool(self.warm_fill),
                "stale_limit": None if self.stale_limit is None
                else int(self.stale_limit),
                "error_feedback": bool(self.error_feedback)}

    @classmethod
    def from_dict(cls, d: dict) -> "NetConfig":
        """Rebuild a NetConfig from ``to_dict``'s plain form (a dict
        without the churn fields means their defaults)."""
        edges = d.get("edge_policies")
        return cls(
            policy=LinkPolicy.from_dict(d["policy"]),
            edge_policies=None if edges is None else {
                (u, v): LinkPolicy.from_dict(p) for u, v, p in edges},
            schedule=d["schedule"], seed=d["seed"],
            warm_fill=d["warm_fill"],
            stale_limit=d.get("stale_limit"),
            error_feedback=d.get("error_feedback", False))


# ---------------------------------------------------------------------------
# wire formats
# ---------------------------------------------------------------------------
def bytes_per_message(quant: str, dim: int) -> float:
    """Wire bytes of one ``dim``-vector message under a quant format;
    the integer formats carry one float32 scale word."""
    code = QUANT_CODES[quant]
    if code == 0:
        return 4.0 * dim
    if code == 1:
        return 2.0 * dim
    if code == 2:
        return 2.0 * dim + 4.0
    return 1.0 * dim + 4.0


def _int_roundtrip(x: torch.Tensor, qmax: float) -> torch.Tensor:
    """Symmetric per-vector integer quantize -> dequantize over the last
    axis: scale = max|x| / qmax, round half to even (``torch.round``, as
    ``jnp.round``), zero vectors stay exactly zero."""
    s = x.abs().amax(-1, keepdim=True) / qmax
    nonzero = s > 0
    safe = torch.where(nonzero, s, torch.ones_like(s))
    q = torch.clamp(torch.round(x / safe), -qmax, qmax)
    return torch.where(nonzero, q * s, torch.zeros_like(x))


def apply_quant(x: torch.Tensor, code: int) -> torch.Tensor:
    """Quantize-dequantize round trip of payload ``x`` for a wire code."""
    if code == 0:
        return x
    if code == 1:
        return x.to(torch.float16).to(torch.float32)
    return _int_roundtrip(x, _QMAX[code])


def quant_error_bound(x: np.ndarray, quant: str) -> float:
    """A priori worst-case absolute round-trip error (a test oracle)."""
    code = QUANT_CODES[quant]
    if code == 0:
        return 0.0
    amax = float(np.max(np.abs(x), axis=-1, keepdims=False).max()) \
        if np.size(x) else 0.0
    if code == 1:
        return amax * 2.0 ** -10 + 1e-12   # half-precision ulp at amax
    return 0.5 * amax / _QMAX[code] + 1e-12
