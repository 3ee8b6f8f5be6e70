"""Sample-axis and config-axis worlds, and what each rank is sent (twin of
the SVM half of ``repro/dist/sharding.py``, :218-279; the LM half belongs
to the seed substrate).

The reference splits an axis over the devices of a mesh and states, per
leaf, which axis each one splits (``sample_specs``).  The port's ranks
are processes of a ``World`` on the one card, so a layout is a world of
the right size and the payload each rank is sent:

- the sample axis (``"sample_shard"``): a node's local samples split over
  S ranks.  ``X``, ``y``, ``mask`` and ``lam`` are cut on N, so a rank
  receives only its N/S rows; ``adj``, the scalars, ``active``,
  ``couple`` and the O(p) consensus state ``r``/``alpha``/``beta`` are
  replicated (:func:`sample_payloads`, :func:`sample_state_rows`);
- the config axis of a sweep, alone (1-D: ``n_sweep`` ranks) or beside
  the node axis (2-D: ``n_sweep`` rows of V ranks, each row a node group
  of the world; ``engine.sweep.SweepPlan.run_sharded``).

One card holds every rank, so "the devices available" cannot choose a
default count as the reference's meshes do: a default takes the largest
divisor of the axis that is at most :data:`DEFAULT_RANKS`.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.dtsvm_dist import _SCALARS, _host
from repro_torch.dist import world as world_lib

#: ranks a default sample or sweep axis is split over, at most
DEFAULT_RANKS = 4


def largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= ``cap`` (>= 1): the even tiling
    behind the sample and sweep worlds."""
    for d in range(min(n, max(cap, 1)), 1, -1):
        if n % d == 0:
            return d
    return 1


def check_tiling(n: int, ranks: int, what: str, axis: str) -> None:
    """The reference's refusal of an axis that does not tile."""
    if ranks < 1 or n % ranks:
        raise ValueError(f"{n} {what} do not tile evenly over {ranks} "
                         f"'{axis}' devices")


def sample_shards(n_samples: int, n_shards: Optional[int] = None) -> int:
    """The rank count of a sample world: ``n_shards``, checked, or by
    default the largest divisor of N that is at most DEFAULT_RANKS."""
    if n_shards is None:
        n_shards = largest_divisor_leq(n_samples, DEFAULT_RANKS)
    check_tiling(n_samples, int(n_shards), "samples", "samples")
    return int(n_shards)


def make_sample_world(n_samples: int, n_shards: Optional[int] = None, *,
                      device=None,
                      timeout: float = world_lib.DEFAULT_TIMEOUT_S
                      ) -> world_lib.World:
    """A world splitting the per-node sample axis (the port's
    ``make_sample_mesh``): :func:`sample_shards` ranks on ``device``
    (None means ``"cuda"``)."""
    return world_lib.World(sample_shards(n_samples, n_shards),
                           device=device, timeout=timeout)


def sweep_groups(n_sweep: int, n_nodes: int) -> list:
    """The node groups of a 2-D sweep world: sweep row s is the ranks
    ``s * n_nodes + v``, v = 0..n_nodes-1."""
    return [list(range(s * n_nodes, (s + 1) * n_nodes))
            for s in range(n_sweep)]


def make_sweep_world(n_configs: int, n_nodes: Optional[int] = None, *,
                     n_sweep: Optional[int] = None, device=None,
                     timeout: float = world_lib.DEFAULT_TIMEOUT_S
                     ) -> world_lib.World:
    """A world tiling a sweep's configs (the port's ``make_sweep_mesh``):
    1-D, ``n_sweep`` ranks, or with ``n_nodes`` 2-D, ``n_sweep`` rows of
    ``n_nodes`` ranks, each row a node group.  ``n_sweep=None`` takes the
    largest divisor of ``n_configs`` that is at most DEFAULT_RANKS."""
    if n_sweep is None:
        n_sweep = largest_divisor_leq(n_configs, DEFAULT_RANKS)
    check_tiling(n_configs, int(n_sweep), "configs", "sweep")
    if n_nodes is None:
        return world_lib.World(int(n_sweep), device=device, timeout=timeout)
    return world_lib.World(int(n_sweep) * int(n_nodes), device=device,
                           timeout=timeout,
                           groups=sweep_groups(int(n_sweep), int(n_nodes)))


def sample_payloads(prob, n_shards: int) -> list:
    """Each rank's part of a problem: its N/S rows of ``X``, ``y`` and
    ``mask`` (numpy copies of those rows alone), the replicated ``adj``,
    ``active``, ``couple`` and scalars, its first row ``row0`` and N."""
    N = prob.X.shape[2]
    Nl = N // n_shards
    X, y, mask = (_host(t) for t in (prob.X, prob.y, prob.mask))
    shared = dict(adj=_host(prob.adj), active=_host(prob.active),
                  couple=_host(prob.couple),
                  **{k: float(getattr(prob, k)) for k in _SCALARS})
    return [dict(X=X[:, :, k * Nl:(k + 1) * Nl].copy(),
                 y=y[:, :, k * Nl:(k + 1) * Nl].copy(),
                 mask=mask[:, :, k * Nl:(k + 1) * Nl].copy(),
                 row0=k * Nl, n_samples=N, **shared)
            for k in range(n_shards)]


def sample_state_rows(state, n_shards: int) -> list:
    """Each rank's part of a state: ``r``, ``alpha``, ``beta`` whole, its
    N/S rows of ``lam``."""
    r, alpha, beta, lam = (_host(t) for t in state)
    Nl = lam.shape[2] // n_shards
    return [(r, alpha, beta, lam[:, :, k * Nl:(k + 1) * Nl].copy())
            for k in range(n_shards)]
