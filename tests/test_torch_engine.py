"""The port's engine (invariants, QP engines, plan) against the reference.

The JAX side runs its plain path (``REPRO_USE_PALLAS=0``); the port runs
its plain versions on the CPU.  Tolerances: invariants rtol = atol =
3e-5 relative to each leaf's scale; one ``plan_step`` per engine from a
shared state (given through ``repro_torch.convert``) rtol 1e-4, atol
1e-5 on r, alpha, beta and lam (bf16: 1e-2 relative to the largest
magnitude); a small fit's risks within 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.api import solvers as jsolvers
from repro.core import dtsvm as jcore
from repro.core import graph as jgraph
from repro.data import synthetic as jsynthetic
from repro.engine import plan as jplan
from repro_torch import convert
from repro_torch.api import solvers
from repro_torch.engine import invariants, plan, qp_engines

ENGINES = [("fista", "f32"), ("pg", "f32"), ("pallas_fused", "f32"),
           ("pallas_fused_multi", "f32"), ("pallas_fused_multi", "bf16")]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once, and these tests
    make many tiny torch ops: intra-op threads would only oversubscribe
    the cores (a quickstart fit took 190 s under the full suite with the
    default thread count, ~1 s alone with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_plain_path(monkeypatch):
    monkeypatch.setenv("REPRO_USE_PALLAS", "0")


def _data(V=4, T=2, p=10, n_tgt=24, n_src=120, seed=0):
    n_train = np.zeros((V, T), int)
    n_train[:, 0] = jsynthetic.split_counts(n_tgt, V)
    n_train[:, 1] = jsynthetic.split_counts(n_src, V)
    data = jsynthetic.make_multitask_data(V=V, T=T, p=p, n_train=n_train,
                                          n_test=300, relatedness=0.9,
                                          seed=seed)
    adj = jgraph.make_graph("random", V, degree=0.6, seed=seed)
    return data, adj


def _problems():
    data, adj = _data()
    jprob = jcore.make_problem(data["X"], data["y"], data["mask"], adj,
                               C=0.05, eps1=1.0, eps2=1.0)
    return jprob, convert.to_torch(jprob, device="cpu")


def _shared_state(jprob, seed=3):
    V, T, N, p = jprob.X.shape
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.2 * rng.normal(size=s)).astype(np.float32)
    return jcore.DTSVMState(r=jnp.asarray(f(V, T, 2 * p + 2)),
                            alpha=jnp.asarray(f(V, T, p + 1)),
                            beta=jnp.asarray(f(V, T, 2 * p + 2)),
                            lam=jnp.asarray(np.abs(f(V, T, N))))


def test_compute_invariants_match():
    jprob, tprob = _problems()
    jinv = jengine.compute_invariants(jprob)
    tinv = invariants.compute_invariants(tprob)
    for name in jengine.PlanInvariants._fields:
        j = np.asarray(getattr(jinv, name))
        t = getattr(tinv, name).numpy()
        scale = max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(t, j, rtol=3e-5, atol=3e-5 * scale,
                                   err_msg=name)


def test_invariants_convert_round_trip():
    jprob, _ = _problems()
    jinv = jengine.compute_invariants(jprob)
    back = convert.to_numpy(convert.to_torch(jinv, device="cpu"))
    for name in jengine.PlanInvariants._fields:
        np.testing.assert_array_equal(getattr(back, name),
                                      np.asarray(getattr(jinv, name)))


@pytest.mark.parametrize("qp_solver,precision", ENGINES)
def test_plan_step_matches_per_engine(qp_solver, precision):
    jprob, tprob = _problems()
    jst = _shared_state(jprob)
    jpl = jplan.compile_problem(jprob, qp_iters=25, qp_solver=qp_solver,
                                qp_precision=precision)
    tpl = plan.compile_problem(tprob, qp_iters=25, qp_solver=qp_solver,
                               qp_precision=precision)
    want = jpl.step(jst)
    got = convert.to_numpy(tpl.step(convert.to_torch(jst, device="cpu")))
    for name in jcore.DTSVMState._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        if precision == "f32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        else:
            scale = float(np.abs(w).max())
            assert float(np.abs(g - w).max()) <= 1e-2 * scale, name


@pytest.mark.parametrize("qp_solver,precision", [ENGINES[0], ENGINES[3],
                                                 ENGINES[4]])
def test_small_fit_risks_match(qp_solver, precision):
    """V=4, T=2, p=10, 10 ADMM iterations, qp_iters=30: risks within 1e-3,
    and the per-iteration risk history has the reference's shape."""
    data, adj = _data()
    cfg = dict(C=0.05, iters=10, qp_iters=30, qp_solver=qp_solver,
               qp_precision=precision)
    jfit = jsolvers.DTSVM(jsolvers.SolverConfig(**cfg)).fit(
        data["X"], data["y"], mask=data["mask"], adj=adj,
        X_test=data["X_test"], y_test=data["y_test"])
    tfit = solvers.DTSVM(solvers.SolverConfig(**cfg), device="cpu").fit(
        data["X"], data["y"], mask=data["mask"], adj=adj,
        X_test=data["X_test"], y_test=data["y_test"])
    np.testing.assert_allclose(
        tfit.global_risks(data["X_test"], data["y_test"]),
        jfit.global_risks(data["X_test"], data["y_test"]), atol=1e-3)
    assert tuple(tfit.history_.shape) == np.asarray(jfit.history_).shape
    np.testing.assert_allclose(tfit.history_.numpy(),
                               np.asarray(jfit.history_), atol=1e-3)


def test_plan_run_is_the_iterated_step():
    _, tprob = _problems()
    tpl = plan.compile_problem(tprob, qp_iters=10, qp_solver="pg")
    st = tpl.init_state()
    for _ in range(3):
        st = tpl.step(st)
    ran, hist = tpl.run(iters=3)
    assert hist is None
    for a, b in zip(st, ran):
        assert torch.equal(a, b)


def test_engine_registry_and_capabilities():
    assert qp_engines.names() == ["fista", "pallas_fused",
                                  "pallas_fused_multi", "pg"]
    multi = qp_engines.get("pallas_fused_multi")
    assert multi.supports_precision and multi.supports_fold
    assert not getattr(qp_engines.get("fista"), "supports_fold", False)
    with pytest.raises(ValueError):
        qp_engines.get("nope")


def test_compile_problem_validation():
    _, tprob = _problems()
    with pytest.raises(ValueError):
        plan.compile_problem(tprob, qp_solver="fista", qp_precision="bf16")
    with pytest.raises(ValueError):
        plan.compile_problem(tprob, qp_precision="fp8")
    with pytest.raises(ValueError, match="qp_operator"):
        plan.compile_problem(tprob, qp_operator="lowrank")
    # the factored operator: the fused multi engine and f32 only
    with pytest.raises(ValueError, match="factored"):
        plan.compile_problem(tprob, qp_solver="fista",
                             qp_operator="factored")
    with pytest.raises(ValueError, match="factored"):
        plan.compile_problem(tprob, qp_solver="pallas_fused_multi",
                             qp_precision="bf16", qp_operator="factored")
    factored = plan.compile_problem(tprob, qp_solver="pallas_fused_multi",
                                    qp_operator="factored")
    assert factored.inv.K is None and factored.qp_operator == "factored"
    budget = invariants.PlanBudget(max_elems=1024)
    budgeted = plan.compile_problem(tprob, budget=budget)
    assert budgeted.budget == budget
    assert budget.row_chunk(8, tprob.X.shape[2]) is not None   # it binds
