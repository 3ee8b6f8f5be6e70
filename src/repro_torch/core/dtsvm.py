"""DTSVM, Proposition 1 of the paper, batched over (V, T) (twin of
``repro/core/dtsvm.py``).

Decision vector layout (size 2p+2):  r = [w0 (p), b0, wt (p), bt].
Every operator of Prop. 1 is diagonal in this basis, so the dual Hessian
of QP (6) is the weighted Gram matrix K = (Y X~) diag(a) (Y X~)^T with
X~ = [X, 1] and a_i = 1/U_i + 1/U_{p+1+i} (see the reference's module
doc for the derivation and the ``active``/``couple``/``mask``
generalizations, which this module keeps).

All leaves of a problem and a state are fp32 tensors on one device (the
adjacency is bool); the hyper-parameters are 0-d fp32 tensors.  The
pieces below count their axes from the end, so a sweep's stacked problem
(``engine.sweep``: a leading config axis S on the state, ``active``,
``couple``, and hyper-parameters of shape (S, 1, 1, 1)) runs through
them as it is; the reference gets that axis from ``jax.vmap``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import qp as qp_lib
from repro_torch.kernels import ops as kops

_U_FLOOR = 1e-6


class DTSVMState(NamedTuple):
    r: torch.Tensor        # (V, T, 2p+2)
    alpha: torch.Tensor    # (V, T, p+1)
    beta: torch.Tensor     # (V, T, 2p+2)
    lam: torch.Tensor      # (V, T, N)   warm-started duals


class DTSVMProblem(NamedTuple):
    X: torch.Tensor        # (V, T, N, p)
    y: torch.Tensor        # (V, T, N)  in {-1, +1}
    mask: torch.Tensor     # (V, T, N)  in {0, 1}
    adj: torch.Tensor      # (V, V) bool
    C: torch.Tensor        # () fp32
    eps1: torch.Tensor     # ()
    eps2: torch.Tensor     # ()
    eta1: torch.Tensor     # ()
    eta2: torch.Tensor     # ()
    box_scale: torch.Tensor  # () the paper's V*T multiplier on C
    active: torch.Tensor   # (V, T)
    couple: torch.Tensor   # (V,)


def _tensor(x, dev: torch.device, dtype=torch.float32) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=dev, dtype=dtype)


def make_problem(X, y, mask=None, adj=None, *, C=0.01, eps1=1.0, eps2=1.0,
                 eta1=1.0, eta2=1.0, box_scale=None, active=None,
                 couple=None, device=None) -> DTSVMProblem:
    """The Prop.-1 problem from arrays (numpy or tensors) on ``device``
    (``None`` means ``"cuda"``; see ``repro_torch.device``)."""
    dev = device_lib.resolve(device)
    X = _tensor(X, dev)
    y = _tensor(y, dev)
    V, T, N, p = X.shape
    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=dev)
    mask = ones(V, T, N) if mask is None else _tensor(mask, dev)
    adj = (torch.zeros((V, V), dtype=torch.bool, device=dev) if adj is None
           else _tensor(adj, dev, torch.bool))
    active = ones(V, T) if active is None else _tensor(active, dev)
    couple = ones(V) if couple is None else _tensor(couple, dev)
    if box_scale is None:
        box_scale = float(V * T)
    s = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)
    return DTSVMProblem(X, y, mask, adj, s(C), s(eps1), s(eps2), s(eta1),
                        s(eta2), s(box_scale), active, couple)


def init_state(prob: DTSVMProblem) -> DTSVMState:
    V, T, N, p = prob.X.shape
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                   device=prob.X.device)
    return DTSVMState(r=z(V, T, 2 * p + 2), alpha=z(V, T, p + 1),
                      beta=z(V, T, 2 * p + 2), lam=z(V, T, N))


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------
def _default_nbr_reduce(prob: DTSVMProblem):
    """Sum an (..., V, T, D) array over each node's neighbors (dense adj)."""
    adjf = prob.adj.to(torch.float32)
    return lambda arr: torch.einsum("vu,...utd->...vtd", adjf, arr)


def _counts(prob: DTSVMProblem, nbr_counts: Optional[torch.Tensor] = None):
    """Per-(v,t) coupling pair count and active-neighbor count
    (``nbr_counts``: precomputed (..., V, T) active-neighbor counts)."""
    active = prob.active                                   # (...,V,T)
    T_v = active.sum(-1, keepdim=True)                     # (...,V,1)
    ntp = (T_v - 1.0) * prob.couple[..., None] * active    # (...,V,T)
    ntp = torch.clamp_min(ntp, 0.0)
    if nbr_counts is None:
        nbr_counts = torch.einsum("vu,...ut->...vt",
                                  prob.adj.to(torch.float32), active)
    nbr = nbr_counts * active                              # inactive rows: 0
    return ntp, nbr


def _u_diag(prob: DTSVMProblem, ntp, nbr):
    """Diagonal of U_vt, eq. (10): (V, T, 2p+2)."""
    p = prob.X.shape[-1]
    ntp, nbr = ntp[..., None], nbr[..., None]
    w0 = prob.eps1 + 2 * prob.eta1 * ntp + 2 * prob.eta2 * nbr
    b0 = 2 * prob.eta1 * ntp + 2 * prob.eta2 * nbr
    wt = prob.eps2 + 2 * prob.eta2 * nbr
    bt = 2 * prob.eta2 * nbr
    shape = ntp.shape[:-1] + (p,)
    u = torch.cat([w0.expand(shape), b0, wt.expand(shape), bt], dim=-1)
    return torch.clamp_min(u, _U_FLOOR)


def _f_vec(prob: DTSVMProblem, state: DTSVMState, ntp, nbr, nbr_reduce):
    """f_vt^{(k)}, eq. (11): (V, T, 2p+2)."""
    p = prob.X.shape[-1]
    r, alpha, beta = state.r, state.alpha, state.beta
    active = prob.active[..., None]                        # (...,V,T,1)
    # task sums: over the other active tasks at the node (coupled nodes)
    r_act = r * active
    task_sum = r_act.sum(-2, keepdim=True) - r_act         # (...,V,T,D)
    task_term = ntp[..., None] * r + task_sum * prob.couple[..., None, None]
    task_term = torch.cat([task_term[..., : p + 1],
                           torch.zeros_like(task_term[..., p + 1:])], -1)
    # neighbor sums: over the active neighbors, same task
    nbr_term = nbr[..., None] * r + nbr_reduce(r_act)
    alpha_full = torch.cat([alpha, torch.zeros_like(alpha)], -1)  # [I,0]^T a
    return 2.0 * alpha_full + 2.0 * beta \
        - prob.eta1 * task_term - prob.eta2 * nbr_term


def _qp_inputs(prob: DTSVMProblem, u, f):
    """Weighted Gram Hessian K, linear term q, box hi, for QP (6)."""
    V, T, N, p = prob.X.shape
    ones = torch.ones((V, T, N, 1), dtype=torch.float32, device=prob.X.device)
    Xa = torch.cat([prob.X, ones], -1)
    Z = prob.y[..., None] * Xa * prob.mask[..., None]       # (V,T,N,p+1)
    a = 1.0 / u[..., : p + 1] + 1.0 / u[..., p + 1:]        # (V,T,p+1)
    K = kops.weighted_gram(Z, a)                            # (V,T,N,N)
    g = f[..., : p + 1] / u[..., : p + 1] + f[..., p + 1:] / u[..., p + 1:]
    q = prob.mask + (Z * g[..., None, :]).sum(-1)
    hi = prob.box_scale * prob.C * prob.mask * prob.active[..., None]
    return Z, K, q, hi


def dtsvm_step(state: DTSVMState, prob: DTSVMProblem,
               qp_iters: int = 200, nbr_reduce=None,
               nbr_counts: Optional[torch.Tensor] = None) -> DTSVMState:
    """One full Proposition-1 iteration (eqs. 6-9), self-contained.

    ``nbr_reduce`` sums an array over each node's neighbors (default: the
    dense-adjacency einsum; a rank of the ``"shard_map"`` backend passes
    its collective, ``core.dtsvm_dist``), and ``nbr_counts`` gives the
    (V, T) active-neighbor counts precomputed.

    The LEGACY per-iteration oracle: it rebuilds every loop invariant (Z,
    K, u, counts, box) on each call, and solves the duals of all (v, t)
    problems in one batched FISTA solve (the reference vmaps a
    one-problem solve over them).  Runs go through :func:`run_dtsvm` /
    ``engine.compile_problem``, which hoist the invariants out of the
    loop; with ``qp_solver="fista"`` the states are bitwise these.
    """
    from repro_torch.engine.plan import consensus_update   # deferred: cycle
    if nbr_reduce is None:
        nbr_reduce = _default_nbr_reduce(prob)
    ntp, nbr = _counts(prob, nbr_counts)
    u = _u_diag(prob, ntp, nbr)
    f = _f_vec(prob, state, ntp, nbr, nbr_reduce)
    Z, K, q, hi = _qp_inputs(prob, u, f)
    lam = qp_lib.solve_box_qp_fista(K, q, hi, iters=qp_iters,
                                    lam0=state.lam)           # eq. (6)
    zl = torch.einsum("...n,...nd->...d", lam,
                      kops.broadcast_z(Z, lam))               # X^T Y lam
    r, alpha, beta = consensus_update(prob, state, u, ntp, nbr, f, zl,
                                      nbr_reduce)             # eqs. (7)-(9)
    return DTSVMState(r=r, alpha=alpha, beta=beta, lam=lam)


def run_dtsvm(prob: DTSVMProblem, iters: int, qp_iters: int = 200,
              state: Optional[DTSVMState] = None,
              eval_fn: Optional[Callable[[DTSVMState], torch.Tensor]] = None,
              qp_solver: str = "fista"):
    """Run ``iters`` ADMM iterations through a freshly compiled
    ``engine.Plan`` (``qp_solver`` selects the dual engine).  Returns
    ``(state, history)``, history stacking ``eval_fn(state)`` after every
    iteration (or None)."""
    from repro_torch.engine import plan as engine_plan   # deferred: cycle
    pl = engine_plan.compile_problem(prob, qp_iters=qp_iters,
                                     qp_solver=qp_solver)
    return pl.run(state=state, iters=iters, eval_fn=eval_fn)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------
def decision_values(r: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """g_vt(x) = [x^T, 1] [I,I] r_vt, eq. (12).  X: (..., N, p)."""
    p = X.shape[-1]
    w = r[..., :p] + r[..., p + 1: 2 * p + 1]
    b = r[..., p] + r[..., 2 * p + 1]
    return torch.einsum("...np,...p->...n", X, w) + b[..., None]


def risks(r: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-(v,t) misclassification rate on a test set."""
    g = decision_values(r, X)
    wrong = (torch.sign(g) != torch.sign(y)).to(torch.float32)
    if mask is None:
        return wrong.mean(-1)
    return (wrong * mask).sum(-1) / torch.clamp_min(mask.sum(-1), 1)


def consensus_residuals(state: DTSVMState, prob: DTSVMProblem):
    """Max violation of the two consensus constraint families."""
    p = prob.X.shape[-1]
    r = state.r
    act = prob.active[..., None]
    w0b0 = r[..., : p + 1] * act
    # across tasks within a node
    mean_t = w0b0.sum(1, keepdim=True) / torch.clamp_min(
        act.sum(1, keepdim=True), 1)
    task_res = ((w0b0 - mean_t) * act).abs().max()
    # across neighboring nodes per task
    A = prob.adj.to(torch.float32)
    deg = torch.clamp_min(torch.einsum("vu,ut->vt", A, prob.active),
                          1)[..., None]
    nbr_mean = torch.einsum("vu,utd->vtd", A, r * act) / deg
    node_res = ((r - nbr_mean) * act * (deg > 0)).abs().max()
    return task_res, node_res
