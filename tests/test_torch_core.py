"""The port's math layer (core/qp.py, core/dtsvm.py, core/dsvm.py) against
the JAX reference on the CPU.  Same-seed numpy inputs go to both; the
tolerance is rtol = atol = 3e-5 unless a test says otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsvm as jdsvm
from repro.core import dtsvm as jcore
from repro.core import qp as jqp
from repro_torch import convert
from repro_torch.core import dsvm, dtsvm, qp

TOL = dict(rtol=3e-5, atol=3e-5)


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


def _problem_arrays(seed=0, V=4, T=2, N=12, p=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(V, T, N, p)).astype(np.float32)
    y = np.where(rng.normal(size=(V, T, N)) > 0, 1.0, -1.0).astype(np.float32)
    mask = (rng.uniform(size=(V, T, N)) > 0.2).astype(np.float32)
    adj = np.zeros((V, V), bool)
    for v in range(V):
        adj[v, (v + 1) % V] = adj[(v + 1) % V, v] = True
    active = np.ones((V, T), np.float32)
    active[1, 0] = 0.0
    couple = np.ones((V,), np.float32)
    couple[2] = 0.0
    return dict(X=X, y=y, mask=mask, adj=adj, active=active, couple=couple)


def _both_problems(seed=0, **hyper):
    arrs = _problem_arrays(seed)
    hyper = dict(dict(C=0.05, eps1=0.7, eps2=1.3, eta1=0.9, eta2=1.1),
                 **hyper)
    jprob = jcore.make_problem(arrs["X"], arrs["y"], arrs["mask"],
                               arrs["adj"], active=arrs["active"],
                               couple=arrs["couple"], **hyper)
    tprob = dtsvm.make_problem(arrs["X"], arrs["y"], arrs["mask"],
                               arrs["adj"], active=arrs["active"],
                               couple=arrs["couple"], device="cpu", **hyper)
    return jprob, tprob


def _random_state(prob, seed=1):
    V, T, N, p = prob.X.shape
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.3 * rng.normal(size=s)).astype(np.float32)
    return jcore.DTSVMState(r=jnp.asarray(f(V, T, 2 * p + 2)),
                            alpha=jnp.asarray(f(V, T, p + 1)),
                            beta=jnp.asarray(f(V, T, 2 * p + 2)),
                            lam=jnp.asarray(np.abs(f(V, T, N))))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def test_make_problem_leaves_match():
    jprob, tprob = _both_problems()
    for name in jcore.DTSVMProblem._fields:
        j, t = np.asarray(getattr(jprob, name)), getattr(tprob, name)
        assert t.device.type == "cpu"
        assert t.dtype == (torch.bool if name == "adj" else torch.float32)
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


def test_make_problem_defaults_match():
    arrs = _problem_arrays(2)
    jprob = jcore.make_problem(arrs["X"], arrs["y"])
    tprob = dtsvm.make_problem(arrs["X"], arrs["y"], device="cpu")
    for name in jcore.DTSVMProblem._fields:
        np.testing.assert_array_equal(getattr(tprob, name).numpy(),
                                      np.asarray(getattr(jprob, name)))


def test_init_state_shapes_match():
    jprob, tprob = _both_problems()
    for j, t in zip(jcore.init_state(jprob), dtsvm.init_state(tprob)):
        assert tuple(t.shape) == j.shape
        assert not t.any()


def test_counts_udiag_fvec_qp_inputs_match():
    jprob, tprob = _both_problems()
    jst = _random_state(jprob)
    tst = convert.to_torch(jst, device="cpu")
    jntp, jnbr = jcore._counts(jprob)
    ntp, nbr = dtsvm._counts(tprob)
    _close(ntp, jntp)
    _close(nbr, jnbr)
    ju = jcore._u_diag(jprob, jntp, jnbr)
    u = dtsvm._u_diag(tprob, ntp, nbr)
    _close(u, ju)
    jf = jcore._f_vec(jprob, jst, jntp, jnbr,
                      jcore._default_nbr_reduce(jprob))
    f = dtsvm._f_vec(tprob, tst, ntp, nbr, dtsvm._default_nbr_reduce(tprob))
    _close(f, jf)
    for name, t, j in zip(("Z", "K", "q", "hi"), dtsvm._qp_inputs(tprob, u, f),
                          jcore._qp_inputs(jprob, ju, jf)):
        _close(t, j, rtol=3e-5, atol=3e-5 * max(1.0, float(np.abs(j).max())))


def test_decision_values_risks_residuals_match():
    jprob, tprob = _both_problems()
    jst = _random_state(jprob, seed=4)
    tst = convert.to_torch(jst, device="cpu")
    rng = np.random.default_rng(5)
    Xte = rng.normal(size=(4, 2, 30, 5)).astype(np.float32)
    yte = np.where(rng.normal(size=(4, 2, 30)) > 0, 1.0, -1.0).astype(
        np.float32)
    mte = (rng.uniform(size=(4, 2, 30)) > 0.3).astype(np.float32)
    _close(dtsvm.decision_values(tst.r, torch.from_numpy(Xte)),
           jcore.decision_values(jst.r, jnp.asarray(Xte)))
    for mask in (None, mte):
        got = dtsvm.risks(tst.r, torch.from_numpy(Xte), torch.from_numpy(yte),
                          None if mask is None else torch.from_numpy(mask))
        want = jcore.risks(jst.r, jnp.asarray(Xte), jnp.asarray(yte),
                           None if mask is None else jnp.asarray(mask))
        _close(got, want)
    for t, j in zip(dtsvm.consensus_residuals(tst, tprob),
                    jcore.consensus_residuals(jst, jprob)):
        _close(t, j)


def test_dsvm_problem_matches():
    arrs = _problem_arrays(6)
    jprob = jdsvm.make_dsvm_problem(arrs["X"], arrs["y"], arrs["mask"],
                                    arrs["adj"], C=0.02, eps2=0.5, eta2=2.0)
    tprob = dsvm.make_dsvm_problem(arrs["X"], arrs["y"], arrs["mask"],
                                   arrs["adj"], C=0.02, eps2=0.5, eta2=2.0,
                                   device="cpu")
    for name in jcore.DTSVMProblem._fields:
        np.testing.assert_array_equal(getattr(tprob, name).numpy(),
                                      np.asarray(getattr(jprob, name)),
                                      err_msg=name)
    assert sorted(dsvm.dsvm_problem_fields(4)) == sorted(
        jdsvm.dsvm_problem_fields(4))


def _qp_batch(seed, B=3, N=15):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(B, N, 4)).astype(np.float32)
    K = np.einsum("bnd,bmd->bnm", Z, Z).astype(np.float32)
    q = (1.0 + 0.2 * rng.normal(size=(B, N))).astype(np.float32)
    hi = np.full((B, N), 0.3, np.float32)
    hi[:, -3:] = 0.0
    lam0 = rng.uniform(-0.1, 0.5, size=(B, N)).astype(np.float32)
    return K, q, hi, lam0


def test_gershgorin_matches():
    K = _qp_batch(0)[0]
    _close(qp.gershgorin_lipschitz(torch.from_numpy(K)),
           jqp.gershgorin_lipschitz(jnp.asarray(K)))


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("solver", ["pg", "fista"])
def test_box_qp_solvers_match(solver, warm):
    """Batched port solvers against the reference vmapped over problems,
    with the warm start projected before the first step."""
    K, q, hi, lam0 = _qp_batch(1)
    L = np.abs(K).sum(-1).max(-1).astype(np.float32)
    jfn = {"pg": jqp.solve_box_qp_pg, "fista": jqp.solve_box_qp_fista}[solver]
    tfn = {"pg": qp.solve_box_qp_pg, "fista": qp.solve_box_qp_fista}[solver]
    want = jax.vmap(lambda k, qq, h, l0, l: jfn(k, qq, h, iters=40, lam0=l0,
                                                 L=l))(
        jnp.asarray(K), jnp.asarray(q), jnp.asarray(hi),
        jnp.asarray(lam0 if warm else np.zeros_like(lam0)), jnp.asarray(L))
    got = tfn(torch.from_numpy(K), torch.from_numpy(q), torch.from_numpy(hi),
              iters=40, lam0=torch.from_numpy(lam0) if warm else None,
              L=torch.from_numpy(L))
    _close(got, want)
    assert bool((got >= 0).all()) and bool((got <= torch.from_numpy(hi)).all())


def test_kkt_residual_matches():
    K, q, hi, lam0 = _qp_batch(2)
    lam = np.clip(lam0, 0, hi)
    want = jax.vmap(jqp.kkt_residual)(jnp.asarray(K), jnp.asarray(q),
                                      jnp.asarray(hi), jnp.asarray(lam))
    got = qp.kkt_residual(*(torch.from_numpy(x) for x in (K, q, hi, lam)))
    _close(got, want)


def test_solvers_converge_to_kkt_point():
    K, q, hi, _ = (torch.from_numpy(x) for x in _qp_batch(3))
    lam = qp.solve_box_qp_fista(K, q, hi, iters=3000)
    assert float(qp.kkt_residual(K, q, hi, lam).max()) < 1e-4


def test_qp_objective_matches():
    """The dual objective, batched in the port, against the reference's
    one-problem form mapped over the batch; PG never lowers it."""
    K, q, hi, lam0 = _qp_batch(4)
    lam = np.clip(lam0, 0, hi)
    want = jax.vmap(jqp.qp_objective)(jnp.asarray(K), jnp.asarray(q),
                                      jnp.asarray(lam))
    got = qp.qp_objective(*(torch.from_numpy(x) for x in (K, q, lam)))
    assert got.shape == (K.shape[0],)
    _close(got, want)
    Kt, qt, ht = (torch.from_numpy(x) for x in (K, q, hi))
    lam_pg = qp.solve_box_qp_pg(Kt, qt, ht, iters=20,
                                lam0=torch.from_numpy(lam))
    assert bool((qp.qp_objective(Kt, qt, lam_pg) >= got - 1e-6).all())


def test_run_dsvm_matches():
    """``run_dsvm`` on the same DSVM problem and warm state in both
    packages: the state within 3e-5 of each leaf's largest magnitude, the
    risk history within float32 rounding of a mean over 12 samples (the
    same samples misclassified)."""
    arrs = _problem_arrays(7)
    args = (arrs["X"], arrs["y"], arrs["mask"], arrs["adj"])
    jprob = jdsvm.make_dsvm_problem(*args, C=0.02, eps2=0.5, eta2=2.0)
    tprob = dsvm.make_dsvm_problem(*args, C=0.02, eps2=0.5, eta2=2.0,
                                   device="cpu")
    jstate = _random_state(jprob, seed=8)
    tstate = dtsvm.DTSVMState(*(torch.from_numpy(np.array(x))
                                for x in jstate))
    jout, jhist = jdsvm.run_dsvm(
        jprob, 4, qp_iters=25, state=jstate,
        eval_fn=lambda st: jcore.risks(st.r, jnp.asarray(arrs["X"]),
                                       jnp.asarray(arrs["y"])))
    tout, thist = dsvm.run_dsvm(
        tprob, 4, qp_iters=25, state=tstate,
        eval_fn=lambda st: dtsvm.risks(st.r, tprob.X, tprob.y))
    for name, got, want in zip(tout._fields, tout, jout):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=3e-5 * float(np.abs(want).max()),
                                   err_msg=name)
    assert tuple(thist.shape) == tuple(jhist.shape) == (4, 4, 2)
    np.testing.assert_allclose(thist.numpy(), np.asarray(jhist), rtol=0,
                               atol=1e-6)
