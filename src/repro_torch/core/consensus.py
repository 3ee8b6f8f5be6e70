"""The paper's ADMM-consensus pattern as a distributed optimizer for deep
networks (twin of ``repro/core/consensus.py``).

Each data group v keeps its own replica r_v of the parameters and a dual
beta_v (eq. 9's multiplier).  At the current iterate the augmented
loss's gradient is

    g_total = g_loss + 2*beta_v + eta * sum_{u in B_v} (r_v - r_u)

and after the step the dual ascends as eq. (9):

    beta_v += eta/2 * sum_{u in B_v} (r_v - r_u)

Only parameters cross replica boundaries, never data or gradients.

The reference runs one replica a device and exchanges over the ``data``
mesh axis by ``ppermute``.  Here every replica lives on one card: each
mapping (parameter name -> tensor) is *stacked*, its leaves carrying a
leading replica axis of size R, and the ring's exchange is two rolls of
that axis.  ``ConsensusConfig.axis`` is kept for the reference's
signature and names no mesh.  ``ConsensusState.step`` is a 0-d int32
tensor on the CPU, so a caller gating on ``step % every`` reads it
without waiting for the card.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch

Tree = Mapping[str, torch.Tensor]


class ConsensusConfig(NamedTuple):
    eta: float = 0.05
    every: int = 1          # exchange every k steps (k>1 = beyond-paper)
    axis: str = "data"      # the reference's mesh axis; one card has none


class ConsensusState(NamedTuple):
    dual: Dict[str, torch.Tensor]   # beta_v, fp32, stacked like the params
    step: torch.Tensor              # 0-d int32 on the CPU


def init_state(params: Tree) -> ConsensusState:
    return ConsensusState(
        dual={n: torch.zeros_like(p, dtype=torch.float32)
              for n, p in params.items()},
        step=torch.zeros((), dtype=torch.int32))


def ring_neighbor_sum(params: Tree) -> Tuple[Dict[str, torch.Tensor], int]:
    """sum_{u in B_v} r_u on the ring over the replica axis, and |B_v| = 2.

    Replica j receives j-1 (the reference's ``fwd`` pairs send i to i+1)
    and j+1.  The count stays 2 at every R, as the reference's does: at
    R = 1 both neighbours are the replica itself, at R = 2 both are the
    other one."""
    return {n: torch.roll(p, 1, 0) + torch.roll(p, -1, 0)
            for n, p in params.items()}, 2


def consensus_grads(grads: Tree, params: Tree, state: ConsensusState,
                    nbr_sum: Tree, n_nbr: int, cfg: ConsensusConfig
                    ) -> Dict[str, torch.Tensor]:
    """Add the ADMM augmented-Lagrangian gradient to the loss gradient,
    in fp32, cast back to each gradient's dtype."""
    def add(g, p, b, s):
        pf = p.float()
        return (g.float() + 2.0 * b + cfg.eta * (n_nbr * pf - s)).to(g.dtype)
    return {n: add(g, params[n], state.dual[n], nbr_sum[n])
            for n, g in grads.items()}


def dual_update(params: Tree, state: ConsensusState, nbr_sum: Tree,
                n_nbr: int, cfg: ConsensusConfig) -> ConsensusState:
    """eq. (9): beta += eta/2 * sum_u (r_v - r_u)."""
    def upd(b, p, s):
        return b + 0.5 * cfg.eta * (n_nbr * p.float() - s)
    return ConsensusState(
        dual={n: upd(b, params[n], nbr_sum[n])
              for n, b in state.dual.items()},
        step=state.step + 1)


def consensus_round(grads: Tree, params: Tree, state: ConsensusState,
                    cfg: ConsensusConfig
                    ) -> Tuple[Dict[str, torch.Tensor], ConsensusState]:
    """One full exchange + dual update; returns (augmented grads, state).

    Every output reads ``params`` as given: no replica may have stepped
    before all of its neighbours' sums are formed.  When ``every > 1``
    the caller gates on ``state.step % every == 0`` (train/steps.py)."""
    nbr_sum, n_nbr = ring_neighbor_sum(params)
    g = consensus_grads(grads, params, state, nbr_sum, n_nbr, cfg)
    return g, dual_update(params, state, nbr_sum, n_nbr, cfg)


def consensus_gap(params: Tree) -> torch.Tensor:
    """Per replica v, max over every leaf of ||r_v - mean_u r_u||_inf: the
    (R,) vector whose entry v is what the reference's shard v computes."""
    gaps = [torch.amax((p.float() - p.float().mean(0)).abs_().reshape(
        p.shape[0], -1), dim=1) for p in params.values()]
    return torch.stack(gaps).amax(0)
