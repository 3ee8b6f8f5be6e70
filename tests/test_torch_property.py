"""Properties of the port's box QP and of Prop. 1 (the twins of
tests/test_qp.py, tests/test_property.py's QP properties and
tests/test_dtsvm.py's structural and paper-claim tests), on the CPU
through the plain versions.

These hold the port to the algorithm's own guarantees, not to the
reference's leaves: iterates stay in the box, projected gradient with a
1/L step never lowers the concave dual, warm starts are projected before
the first step, the engines that iterate the same update agree, and the
ADMM iteration shrinks its consensus residuals, freezes inactive tasks
and transfers to a scarce target task.  Hypothesis runs without its
example database.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from helpers import brute_force_box_qp
from repro_torch.core import csvm, dsvm, dtsvm
from repro_torch.core import graph
from repro_torch.core import qp as qp_lib
from repro_torch.data import synthetic
from repro_torch.engine import qp_engines
from repro_torch.kernels import ref

SET = settings(max_examples=25, deadline=None, database=None)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rand_problem(rng, n, box=1.0):
    A = rng.normal(size=(n, n))
    K = (A @ A.T / n).astype(np.float32)
    q = rng.normal(size=n).astype(np.float32)
    hi = np.full(n, box, np.float32)
    return K, q, hi


# ---------------------------------------------------------------------------
# the box QP (tests/test_qp.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [3, 10, 50])
@pytest.mark.parametrize("solver", ["pg", "fista"])
def test_qp_matches_oracle(n, solver):
    rng = np.random.default_rng(n)
    K, q, hi = _rand_problem(rng, n)
    fn = {"pg": qp_lib.solve_box_qp_pg,
          "fista": qp_lib.solve_box_qp_fista}[solver]
    lam = fn(_t(K), _t(q), _t(hi), iters=3000)
    np.testing.assert_allclose(lam.numpy(), brute_force_box_qp(K, q, hi),
                               atol=2e-4)


@pytest.mark.parametrize("solver", ["pg", "fista"])
def test_qp_kkt_residual_small(solver):
    rng = np.random.default_rng(0)
    K, q, hi = map(_t, _rand_problem(rng, 30))
    fn = {"pg": qp_lib.solve_box_qp_pg,
          "fista": qp_lib.solve_box_qp_fista}[solver]
    lam = fn(K, q, hi, iters=3000)
    assert float(qp_lib.kkt_residual(K, q, hi, lam)) < 1e-3


def test_qp_box_feasibility():
    rng = np.random.default_rng(1)
    K, q, hi = map(_t, _rand_problem(rng, 25, box=0.3))
    lam = qp_lib.solve_box_qp_fista(K, q, hi, iters=50)
    assert float(lam.min()) >= 0.0
    assert float(lam.max()) <= 0.3 + 1e-7


def test_qp_zero_box_pins_padding():
    """hi=0 rows (padding, inactive tasks) keep lam=0."""
    rng = np.random.default_rng(2)
    K, q, hi = _rand_problem(rng, 20)
    hi[10:] = 0.0
    lam = qp_lib.solve_box_qp_fista(_t(K), _t(q), _t(hi), iters=500)
    np.testing.assert_allclose(lam.numpy()[10:], 0.0, atol=1e-9)


def test_qp_unconstrained_interior_solution():
    """With a huge box the solution solves K lam = q when interior."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(8, 8))
    K = (A @ A.T + 8 * np.eye(8)).astype(np.float32)
    lam_true = rng.uniform(0.2, 0.8, 8).astype(np.float32)
    q = K @ lam_true
    lam = qp_lib.solve_box_qp_fista(_t(K), _t(q),
                                    _t(np.full(8, 10.0)), iters=4000)
    np.testing.assert_allclose(lam.numpy(), lam_true, atol=1e-3)


def test_qp_warm_start_converges_faster():
    rng = np.random.default_rng(4)
    K, q, hi = map(_t, _rand_problem(rng, 40))
    lam_star = qp_lib.solve_box_qp_fista(K, q, hi, iters=5000)
    cold = qp_lib.solve_box_qp_fista(K, q, hi, iters=25)
    warm = qp_lib.solve_box_qp_fista(K, q, hi, iters=25, lam0=lam_star)
    obj = lambda lam: float(qp_lib.qp_objective(K, q, lam))  # noqa: E731
    assert obj(warm) >= obj(cold) - 1e-6


@pytest.mark.parametrize("solver", ["pg", "fista"])
def test_qp_warm_start_projected_before_first_step(solver):
    """An out-of-box warm start is projected into [0, hi] before the
    first gradient step (iters=0 shows the raw handling)."""
    rng = np.random.default_rng(5)
    K, q, hi = _rand_problem(rng, 20, box=0.5)
    lam0 = np.full(20, 100.0, np.float32)
    fn = {"pg": qp_lib.solve_box_qp_pg,
          "fista": qp_lib.solve_box_qp_fista}[solver]
    out = fn(_t(K), _t(q), _t(hi), iters=0, lam0=_t(lam0))
    np.testing.assert_allclose(out.numpy(), np.clip(lam0, 0.0, hi))


def test_qp_infeasible_warm_start_stays_feasible_every_iter():
    rng = np.random.default_rng(6)
    K, q, hi = map(_t, _rand_problem(rng, 30, box=0.3))
    lam0 = _t(rng.uniform(-2.0, 2.0, 30))
    for iters in (1, 2, 5):
        lam = qp_lib.solve_box_qp_pg(K, q, hi, iters=iters, lam0=lam0)
        assert float(lam.min()) >= 0.0
        assert float((lam - hi).max()) <= 1e-7


# ---------------------------------------------------------------------------
# QP properties (tests/test_property.py)
# ---------------------------------------------------------------------------
@SET
@given(n=st.integers(2, 24), seed=st.integers(0, 10_000),
       box=st.floats(0.01, 5.0))
def test_qp_iterates_stay_in_box(n, seed, box):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    K = A @ A.T / n
    q = rng.normal(size=n).astype(np.float32)
    lam = qp_lib.solve_box_qp_fista(_t(K), _t(q), _t(np.full(n, box)),
                                    iters=60)
    assert float(lam.min()) >= -1e-7
    assert float(lam.max()) <= np.float32(box) + 1e-6


@SET
@given(n=st.integers(2, 20), seed=st.integers(0, 10_000))
def test_qp_objective_never_decreases_under_pg(n, seed):
    """Projected gradient with a 1/L step is an ascent method on the
    concave dual: the objective never decreases."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    K = _t(A @ A.T / n)
    q = _t(rng.normal(size=n))
    hi = _t(np.full(n, 1.0))
    gamma = 1.0 / max(float(K.abs().sum(1).max()), 1e-9)
    lam = torch.zeros(n)
    prev = float(qp_lib.qp_objective(K, q, lam))
    for _ in range(20):
        lam = ref.qp_pg_step(lam, K, q, hi, gamma)
        cur = float(qp_lib.qp_objective(K, q, lam))
        assert cur >= prev - 1e-5
        prev = cur


@SET
@given(n=st.integers(1, 40), d=st.integers(1, 16), seed=st.integers(0, 9999))
def test_weighted_gram_psd_and_symmetric(n, d, seed):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n, d)).astype(np.float32)
    a = rng.uniform(0.01, 3.0, size=d).astype(np.float32)
    K = ref.weighted_gram(_t(Z), _t(a)).numpy()
    np.testing.assert_allclose(K, K.T, atol=1e-5)
    assert np.linalg.eigvalsh(K.astype(np.float64)).min() > -1e-4


@SET
@given(n=st.integers(2, 24), seed=st.integers(0, 10_000),
       iters=st.integers(1, 12), scale=st.floats(0.1, 4.0))
def test_qp_engines_agree_from_random_warm_starts(n, seed, iters, scale):
    """Out-of-box warm starts (negative or far above hi): the engines
    that iterate the same PG update agree (the fused step and the multi
    solve bitwise on the plain path, "pg" to float tolerance), FISTA
    reaches the same optimum, and every result lies in the box."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    K = _t(A @ A.T / n)
    q = _t(rng.normal(size=n))
    hi = _t(rng.uniform(0.1, 1.0, size=n))
    lam0 = _t(rng.uniform(-scale, scale, size=n))
    fused = qp_engines.get("pallas_fused")(K, q, hi, lam0, iters=iters)
    multi = qp_engines.get("pallas_fused_multi")(K, q, hi, lam0,
                                                 iters=iters)
    pg = qp_engines.get("pg")(K, q, hi, lam0, iters=iters)
    assert torch.equal(fused, multi)
    np.testing.assert_allclose(pg.numpy(), multi.numpy(), rtol=3e-5,
                               atol=3e-5)
    fista = qp_engines.get("fista")(K, q, hi, lam0, iters=3000)
    star = qp_engines.get("pg")(K, q, hi, lam0, iters=3000)
    np.testing.assert_allclose(fista.numpy(), star.numpy(), atol=2e-3)
    for out in (fused, multi, pg, fista):
        assert float(out.min()) >= -1e-7
        assert float((out - hi).max()) <= 1e-6


# ---------------------------------------------------------------------------
# Prop. 1 (tests/test_dtsvm.py)
# ---------------------------------------------------------------------------
def _make(V=6, T=2, n_tgt=30, n_src=300, seed=1, relatedness=0.9,
          noise=1.0, degree=0.8):
    n_train = np.zeros((V, T), int)
    n_train[:, 0] = synthetic.split_counts(n_tgt, V)
    if T > 1:
        n_train[:, 1] = synthetic.split_counts(n_src, V)
    data = synthetic.make_multitask_data(
        V=V, T=T, p=10, n_train=n_train, n_test=600,
        relatedness=relatedness, noise=noise, seed=seed)
    A = graph.make_graph("random", V, degree=degree, seed=0)
    return data, A


def _problem(data, A, **kw):
    return dtsvm.make_problem(data["X"], data["y"], data["mask"], A,
                              device="cpu", **kw)


def _risks(data, V, T, st):
    Xte = np.broadcast_to(data["X_test"][None],
                          (V, T) + data["X_test"].shape[1:])
    yte = np.broadcast_to(data["y_test"][None],
                          (V, T) + data["y_test"].shape[1:])
    return dtsvm.risks(st.r, _t(Xte), _t(yte)).numpy()


def test_u_diag_positive():
    data, A = _make()
    prob = _problem(data, A)
    ntp, nbr = dtsvm._counts(prob)
    assert float(dtsvm._u_diag(prob, ntp, nbr).min()) > 0.0


def test_consensus_residuals_shrink():
    data, A = _make()
    prob = _problem(data, A, C=0.01)
    st5, _ = dtsvm.run_dtsvm(prob, 5, qp_iters=60)
    st40, _ = dtsvm.run_dtsvm(prob, 35, qp_iters=60, state=st5)
    t5, n5 = dtsvm.consensus_residuals(st5, prob)
    t40, n40 = dtsvm.consensus_residuals(st40, prob)
    assert float(t40) < float(t5)
    assert float(n40) < float(n5)
    assert float(n40) < 5e-2


def test_transfer_beats_dsvm_on_scarce_target():
    """The paper's central claim (Fig. 2): with scarce target data,
    DTSVM's target-task risk beats per-task DSVM on average over seeds,
    and the source task is not hurt."""
    V, T = 8, 2
    rt, rd = [], []
    for seed in (1, 2, 3, 4):
        data, A = _make(V=V, T=T, n_tgt=40, n_src=600, seed=seed,
                        relatedness=0.92)
        st_t, _ = dtsvm.run_dtsvm(_problem(data, A, C=0.01), 60,
                                  qp_iters=80)
        prob_d = dsvm.make_dsvm_problem(data["X"], data["y"], data["mask"],
                                        A, C=0.01, device="cpu")
        st_d, _ = dtsvm.run_dtsvm(prob_d, 60, qp_iters=80)
        rt.append(_risks(data, V, T, st_t).mean(0))
        rd.append(_risks(data, V, T, st_d).mean(0))
    r_t, r_d = np.mean(rt, 0), np.mean(rd, 0)
    assert r_t[0] < r_d[0] - 0.005, (r_t, r_d)
    assert r_t[1] < r_d[1] + 0.05


def test_dtsvm_with_one_task_equals_dsvm():
    """T=1 with eps1 at its infinity and no coupling is DSVM's problem,
    so the two runs coincide."""
    V = 5
    data, A = _make(V=V, T=1, n_tgt=40, n_src=0)
    X, y, m = data["X"][:, :1], data["y"][:, :1], data["mask"][:, :1]
    prob_a = dsvm.make_dsvm_problem(X, y, m, A, C=0.02, device="cpu")
    prob_b = dtsvm.make_problem(
        X, y, m, A, C=0.02, eps1=dsvm._EPS1_INF, eta1=0.0,
        box_scale=float(V), couple=np.zeros(V, np.float32), device="cpu")
    st_a, _ = dtsvm.run_dtsvm(prob_a, 15, qp_iters=60)
    st_b, _ = dtsvm.run_dtsvm(prob_b, 15, qp_iters=60)
    np.testing.assert_allclose(st_a.r.numpy(), st_b.r.numpy(), atol=1e-6)


def test_w0_vanishes_when_eps1_huge():
    """eps1 >> eps2 forces the shared term to 0 (paper Section II)."""
    data, A = _make()
    st, _ = dtsvm.run_dtsvm(_problem(data, A, eps1=1e9, eps2=1.0), 20,
                            qp_iters=60)
    p = 10
    assert st.r[..., :p].abs().max() < 1e-4
    assert st.r[..., p + 1: 2 * p + 1].abs().max() > 1e-3


def test_tasks_agree_when_eps2_huge():
    """eps2 >> eps1 forces the task-specific w to 0, so the tasks share
    the weight vector at each node (the bias is not eps2-regularized)."""
    data, A = _make()
    st, _ = dtsvm.run_dtsvm(_problem(data, A, eps1=1.0, eps2=1e9), 30,
                            qp_iters=60)
    p = 10
    assert st.r[..., p + 1: 2 * p + 1].abs().max() < 1e-4
    w0 = st.r[..., :p]
    assert (w0[:, 0] - w0[:, 1]).abs().max() < 2e-2


def test_inactive_tasks_frozen():
    data, A = _make(V=4, T=2)
    active = np.ones((4, 2), np.float32)
    active[2:, 1] = 0.0       # nodes 2, 3 do not train task 1
    st, _ = dtsvm.run_dtsvm(_problem(data, A, active=active), 5,
                            qp_iters=40)
    assert float(st.r[2:, 1].abs().max()) == 0.0
    assert float(st.r[:2, 1].abs().max()) > 0.0
    assert float(st.lam[2:, 1].abs().max()) == 0.0


def test_decision_values_formula():
    rng = np.random.default_rng(0)
    p = 4
    r = rng.normal(size=(2, 3, 2 * p + 2)).astype(np.float32)
    X = rng.normal(size=(2, 3, 5, p)).astype(np.float32)
    g = dtsvm.decision_values(_t(r), _t(X)).numpy()
    for v in range(2):
        for t in range(3):
            w = r[v, t, :p] + r[v, t, p + 1: 2 * p + 1]
            b = r[v, t, p] + r[v, t, 2 * p + 1]
            np.testing.assert_allclose(g[v, t], X[v, t] @ w + b, rtol=1e-5,
                                       atol=1e-5)


def test_csvm_separable():
    rng = np.random.default_rng(0)
    d = rng.normal(size=10)
    d /= np.linalg.norm(d)
    X, y = synthetic.sample_task(rng, d, 100, 100, noise=0.1, margin=2.0)
    w, b = csvm.csvm_fit(_t(X), _t(y), C=1.0, qp_iters=800)
    assert float(csvm.csvm_risk(w, b, _t(X), _t(y))) == 0.0
