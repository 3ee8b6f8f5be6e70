"""The ``"sample_shard"`` backend: every node's local samples split over
the S ranks of a ``World`` (twin of ``repro/api/backends.py:248-416``,
``_qp_rows`` and ``_run_sample_shard``).

The reference's large-n path: the N axis of the (V, T, N, p) problem is
cut into S row blocks, and rank k owns rows [k N/S, (k+1) N/S) of every
(v, t) dual Hessian, so a rank's Gram memory is N²/S instead of N².

- **What a rank receives** (``dist.sharding.sample_payloads``): its N/S
  rows of ``X``, ``y``, ``mask`` (and of ``lam`` with the state), as
  numpy, and the replicated ``adj``, scalars, ``active``, ``couple`` and
  ``r``/``alpha``/``beta``.  It records the shapes.
- **Its invariants**, built once per fit and kept in its store across
  ADMM iterations: the counts, u, a and its box rows (replicated math on
  its rows), ``Z_rows``, then ``Z_full`` by one all-gather (sample
  sharding splits memory, not privacy), its panel K[rows, :] of every
  (v, t) K (``kernels.ops.weighted_gram_rows``: on the card one prescale
  of ``Z_full`` and one tiled-kernel launch at its first row; under a
  binding ``PlanBudget`` one launch per ``budget.row_chunk(V*T, N/S,
  cols=N)``-row chunk, ``engine.invariants.streamed_gram_panel``), the
  per-row |K| sums, and the global Gershgorin bound L by one max-reduce.
- **Each ADMM iteration** is the reference's step: the f-term and the
  consensus updates on the replicated O(p) state (the dense-adjacency
  neighbor sum), q on the rank's rows, the dual QP by :func:`_qp_rows`
  (FISTA or PG, one all-gather of the (V, T, N) iterate per inner step,
  the panel matvec a ``torch.matmul``, as the reference computes it
  outside any Pallas kernel), then zl = Zᵀλ: ``reduce="gather"`` gathers
  λ (one more all-gather) and reduces densely; ``"psum"`` sums each
  rank's partial (V, T, p+1) zl (one all-reduce).

The collectives are ``dist.collectives``' (pinned host staging on the
card, each counted).  Telemetry is collected in the ranks by
``obs.telemetry.collect_shard_diagnostics``.  Rank 0 returns the
replicated ``r``/``alpha``/``beta``, every rank its rows of ``lam``, and
the parent joins them into the (V, T, ...) state; with an ``eval_fn`` the
parent steps the world one ADMM iteration at a time and evaluates each
state (the panels stay in the ranks).  A world that cannot start, or a
rank that raises, raises in the parent; nothing runs anywhere else
instead.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import dtsvm as core
from repro_torch.core import dtsvm_dist
from repro_torch.core import qp as qp_lib
from repro_torch.dist import collectives
from repro_torch.dist import sharding
from repro_torch.dist import world as world_lib

QP_SOLVERS = ("fista", "pg")
REDUCES = ("gather", "psum")
_serials = itertools.count(1)


def check_options(qp_solver: str, reduce: str) -> None:
    """The reference's refusals, in its order: the engine, then the
    reduction."""
    if qp_solver not in QP_SOLVERS:
        raise ValueError(
            f"sample_shard supports qp_solver 'fista' | 'pg', got "
            f"{qp_solver!r} (the fused Pallas engine assumes the square "
            f"single-device Hessian)")
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}; "
                         f"expected 'gather' or 'psum'")


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------
def _qp_rows(K_rows: torch.Tensor, q_rows: torch.Tensor,
             hi_rows: torch.Tensor, lam0_rows: torch.Tensor,
             L: torch.Tensor, *, iters: int, qp_solver: str) -> torch.Tensor:
    """The dual box QP iterated on a row panel of each Hessian.

    ``core.qp.solve_box_qp_fista`` / ``_pg`` operation for operation on
    the rank's rows: each iteration all-gathers the (..., N) iterate over
    the world (the rank order is the row order), applies the rank's
    K[rows, :] (..., N/S, N) to it, and updates the rank's rows
    elementwise.  L (...) is the global bound."""
    step = (1.0 / L)[..., None]

    def matvec(y):
        full = collectives.all_gather(y, -1)
        return torch.matmul(K_rows, full[..., None])[..., 0]

    lam = qp_lib._project(lam0_rows, hi_rows)
    if qp_solver == "pg":
        for _ in range(iters):
            lam = qp_lib._project(lam + step * (q_rows - matvec(lam)),
                                  hi_rows)
        return lam
    y = lam                                                  # fista
    for coef in qp_lib.fista_momentum(iters):
        lam_new = qp_lib._project(y + step * (q_rows - matvec(y)), hi_rows)
        y = lam_new + coef * (lam_new - lam)
        lam = lam_new
    return lam


def _rows_problem(part: dict, dev: torch.device) -> core.DTSVMProblem:
    """A rank's problem: its rows of the data, the replicated rest."""
    t = lambda a, dtype=torch.float32: torch.from_numpy(a).to(  # noqa: E731
        dev, dtype)
    s = lambda v: torch.tensor(v, dtype=torch.float32,        # noqa: E731
                               device=dev)
    return core.DTSVMProblem(
        X=t(part["X"]), y=t(part["y"]), mask=t(part["mask"]),
        adj=t(part["adj"], torch.bool),
        **{k: s(part[k]) for k in dtsvm_dist._SCALARS},
        active=t(part["active"]), couple=t(part["couple"]))


def _rank_compile(serial: int, part: dict, kw: dict) -> None:
    """Build the rank's invariants and panel once (its previous ones
    dropped first, so a world holds one panel per rank)."""
    from repro_torch.engine import invariants as inv_lib
    from repro_torch.kernels import ops as kops

    ctx = world_lib.context()
    ctx.store.pop("sample", None)
    ctx.store["received"] = {k: tuple(v.shape) for k, v in part.items()
                             if isinstance(v, np.ndarray)}
    pr = _rows_problem(part, ctx.device)
    V, T, Nl, _ = pr.X.shape
    N, r0, budget = part["n_samples"], part["row0"], kw["budget"]
    ntp, nbr, u, a, hi_rows = inv_lib._masks_part(pr)
    Z_rows = inv_lib.compute_z(pr)                         # (V,T,Nl,p+1)
    Z_full = collectives.all_gather(Z_rows, -2)            # (V,T,N,p+1)
    chunk = None if budget is None else \
        budget.row_chunk(V * T, Nl, cols=N)
    if chunk is None:
        K_rows = kops.weighted_gram_rows(Z_full, a, r0, Nl)
        rs = K_rows.abs().sum(-1)
    else:
        K_rows, rs = inv_lib.streamed_gram_panel(Z_full, a, chunk,
                                                 row0=r0, rows=Nl)
    # the global Gershgorin bound: the max over every rank's rows (exact)
    L = torch.clamp_min(collectives.all_reduce(rs.amax(-1), "max"), 1e-12)
    ctx.store["sample"] = dict(
        serial=serial, prob=pr, ntp=ntp, nbr=nbr, u=u, hi=hi_rows,
        Z_rows=Z_rows, K=K_rows, L=L,
        Z_full=Z_full if kw["reduce"] == "gather" else None,
        nbr_reduce=core._default_nbr_reduce(pr), kw=kw, state=None)


def _step(held: dict, s: core.DTSVMState) -> core.DTSVMState:
    """One ADMM iteration (``engine.plan.plan_step`` with the N-sized
    pieces on the rank's rows)."""
    from repro_torch.engine import plan as engine_plan

    pr, u, ntp, nbr = held["prob"], held["u"], held["ntp"], held["nbr"]
    kw, nbr_reduce = held["kw"], held["nbr_reduce"]
    p = pr.X.shape[-1]
    f = core._f_vec(pr, s, ntp, nbr, nbr_reduce)
    g = f[..., : p + 1] / u[..., : p + 1] + f[..., p + 1:] / u[..., p + 1:]
    q_rows = pr.mask + (held["Z_rows"] * g[..., None, :]).sum(-1)
    lam = _qp_rows(held["K"], q_rows, held["hi"], s.lam, held["L"],
                   iters=kw["qp_iters"], qp_solver=kw["qp_solver"])
    if kw["reduce"] == "gather":
        # repro: noqa[raw-einsum-in-plan] — deliberate: the gathered (..., N) iterate against the whole Z, engine/plan.py's zl expression on its shapes, which keeps gather torch.equal to vmap (tests/test_torch_sample_shard.py)
        zl = torch.einsum("...n,...nd->...d",
                          collectives.all_gather(lam, -1), held["Z_full"])
    else:
        zl = collectives.all_reduce(
            # repro: noqa[raw-einsum-in-plan] — deliberate: a rank's partial Z_rows^T lam_rows, summed over ranks by all_reduce; psum is held to tolerance, never bitwise, as in the reference
            torch.einsum("...n,...nd->...d", lam, held["Z_rows"]), "sum")
    r_new, alpha, beta = engine_plan.consensus_update(
        pr, s, u, ntp, nbr, f, zl, nbr_reduce)
    return core.DTSVMState(r=r_new, alpha=alpha, beta=beta, lam=lam)


def _rank_run(serial: int, rows: Optional[tuple], iters: int,
              streams: tuple) -> tuple:
    """``iters`` ADMM iterations from the state ``rows`` (None: the state
    the rank kept from its last call).  Returns ``(head, lam rows,
    telemetry)``: ``head`` the replicated ``(r, alpha, beta)`` and the
    telemetry streams (numpy) from rank 0 only, None elsewhere."""
    from repro_torch.obs import telemetry as obs_telemetry

    ctx = world_lib.context()
    held = ctx.store.get("sample")
    if held is None or held["serial"] != serial:
        raise RuntimeError("this world has compiled another problem since "
                           "(or none): compile it again")
    if rows is not None:
        ctx.store["received"]["lam"] = tuple(rows[3].shape)
        held["state"] = core.DTSVMState(*(torch.from_numpy(a).to(ctx.device)
                                          for a in rows))
    s, tel = held["state"], []
    for _ in range(iters):
        new = _step(held, s)
        if streams:
            tel.append(obs_telemetry.collect_shard_diagnostics(
                held["prob"], held["hi"], new, s, streams))
        s = new
    held["state"] = s
    lam = s.lam.cpu().numpy()
    if ctx.rank != 0:
        return None, lam, None
    head = tuple(t.cpu().numpy() for t in (s.r, s.alpha, s.beta))
    streams_np = None
    if streams:
        streams_np = obs_telemetry.materialize(obs_telemetry.stack_rows(
            tel, streams, s.r.shape[1], ctx.device))
    return head, lam, streams_np


def _rank_qp_rows(K, q, hi, lam0, L, iters: int, qp_solver: str):
    """:func:`_qp_rows` on numpy rows (the tests hold it against the
    reference's dense solvers)."""
    dev = world_lib.context().device
    t = lambda a: torch.from_numpy(a).to(dev)                # noqa: E731
    return _qp_rows(t(K), t(q), t(hi), t(lam0), t(L), iters=iters,
                    qp_solver=qp_solver).cpu().numpy()


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def sample_world(prob: core.DTSVMProblem, n_shards: Optional[int] = None,
                 world: Optional[world_lib.World] = None):
    """``world`` itself (its size checked against ``n_shards`` and N), or
    a world of ``n_shards`` ranks (default: ``sharding.sample_shards``)
    on the problem's device, closed when the block ends."""
    N = prob.X.shape[2]
    if world is None:
        with sharding.make_sample_world(N, n_shards,
                                        device=prob.X.device) as own:
            yield own
        return
    if n_shards is not None and int(n_shards) != world.size:
        raise ValueError(f"a world of {world.size} ranks for "
                         f"n_shards={n_shards}")
    sharding.check_tiling(N, world.size, "samples", "samples")
    if world.device.type != prob.X.device.type:
        raise ValueError(f"the world's ranks run on {world.device}, the "
                         f"problem is on {prob.X.device}")
    yield world


def _join(outs: list, dev: torch.device) -> core.DTSVMState:
    head = outs[0][0]
    lam = np.concatenate([o[1] for o in outs], axis=-1)
    return core.DTSVMState(*(torch.from_numpy(a).to(dev)
                             for a in (*head, lam)))


def run_sample_shard(prob: core.DTSVMProblem, iters: int, *,
                     world: Optional[world_lib.World] = None,
                     n_shards: Optional[int] = None, reduce: str = "gather",
                     budget=None, qp_iters: int = 200,
                     qp_solver: str = "fista",
                     state: Optional[core.DTSVMState] = None, eval_fn=None,
                     telemetry=None):
    """The sample-sharded fit (see the module doc).  Returns ``(state,
    history or None, streams or None)``: ``history`` stacks ``eval_fn``
    of every iteration's state, ``streams`` the telemetry streams as
    float32 numpy when ``telemetry`` (a ``repro_torch.obs.Telemetry``) is
    given.  Validates before any world starts: the engine, the reduction,
    then N against the rank count."""
    from repro_torch.obs import telemetry as obs_telemetry

    check_options(qp_solver, reduce)
    T = prob.X.shape[1]
    if state is None:
        state = core.init_state(prob)
    dev = prob.X.device
    kw = dict(qp_iters=int(qp_iters), qp_solver=qp_solver, reduce=reduce,
              budget=budget)
    streams = tuple(telemetry.streams) if telemetry is not None else ()
    hist, tel = [], None
    with sample_world(prob, n_shards, world) as w:
        serial = next(_serials)
        w.run(_rank_compile, [(serial, part, kw) for part in
                              sharding.sample_payloads(prob, w.size)])
        rows = sharding.sample_state_rows(state, w.size)
        per_call = 1 if eval_fn is not None else max(int(iters), 0)
        done = 0
        while done < iters:
            outs = w.run(_rank_run, [(serial, r if done == 0 else None,
                                      per_call, streams) for r in rows])
            done += per_call
            state = _join(outs, dev)
            if eval_fn is not None:
                hist.append(eval_fn(state))
            if streams:
                tel = obs_telemetry.concat_streams(tel, outs[0][2])
    if streams and tel is None:
        tel = obs_telemetry.materialize(obs_telemetry.stack_rows(
            [], streams, T, dev))
    return state, (torch.stack(hist) if hist else None), tel
