"""The port's sweep engine and ``sweep_fit`` against the reference, and
against the port's own serial fits, on the CPU.

The JAX side runs its plain path (``REPRO_USE_PALLAS=0``); the port runs
its plain versions on one torch thread.  Grids: an eps grid, a C grid,
DTSVM beside ``dsvm_overrides``, and per-config ``active``/``couple``
masks (Fig. 6's pair).  Tolerances across the packages: invariants and
states within 1e-5 of each leaf's largest magnitude (counts exact), risk
histories within one test sample (1/n_test).  Inside the port each
config of a sweep is held bitwise to its own serial fit: on one CPU
thread torch's batched products give each problem the same bits at any
batch size of two or more, and these problems have V*T = 8.
"""
import hashlib

import numpy as np
import pytest
import torch

from repro import api as japi
from repro import engine as jengine
from repro.api import backends as jbackends
from repro.api import evaluate as jevaluate
from repro.core import dtsvm as jcore
from repro.core import graph as jgraph
from repro.data import synthetic as jsynthetic
from repro_torch.api import (DSVM, DTSVM, SolverConfig, dsvm_overrides,
                             sweep_fit)
from repro_torch.api import backends, evaluate
from repro_torch.core import dtsvm as core
from repro_torch.engine import compile_sweep, invariants, plan, sweep
from repro_torch.kernels import ops, ref
from repro_torch.kernels import qp_step as qp_kernel

V, N_TEST = 4, 200


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and the bitwise checks hold for torch's single-thread CPU products."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_plain_path(monkeypatch):
    monkeypatch.setenv("REPRO_USE_PALLAS", "0")


def _data(seed=0):
    n_train = np.zeros((V, 2), int)
    n_train[:, 0] = jsynthetic.split_counts(24, V)
    n_train[:, 1] = jsynthetic.split_counts(60, V)
    data = jsynthetic.make_multitask_data(V=V, T=2, p=5, n_train=n_train,
                                          n_test=N_TEST, relatedness=0.9,
                                          seed=seed)
    return data, jgraph.make_graph("random", V, degree=0.6, seed=seed)


def _mixed():
    active_l = np.ones((V, 2), np.float32)
    active_l[:, 1] = 0.0
    active_r = np.ones((V, 2), np.float32)
    active_r[2:, 1] = 0.0
    couple_r = np.array([1, 1, 0, 0], np.float32)
    return active_l, active_r, couple_r


def _grid(name, overrides):
    if name == "eps":
        return [dict(eps1=e1, eps2=e2) for e1 in (0.1, 10.0)
                for e2 in (0.1, 10.0)]
    if name == "C":
        return [dict(C=c, eps2=e2) for c in (0.01, 0.1) for e2 in (1.0, 100.0)]
    if name == "dsvm":
        return [dict(), overrides(V)]
    active_l, active_r, couple_r = _mixed()
    return [overrides(V, active=active_l),
            dict(eps2=10.0, active=active_r, couple=couple_r)]


GRIDS = ["eps", "C", "dsvm", "masks"]


def _problems(C=0.05):
    data, adj = _data()
    tprob = core.make_problem(data["X"], data["y"], data["mask"], adj, C=C,
                              device="cpu")
    jprob = jcore.make_problem(data["X"], data["y"], data["mask"], adj, C=C)
    return data, tprob, jprob


def _close(got, want, name):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-5 * scale, (name, err, scale)


@pytest.mark.parametrize("grid", GRIDS)
def test_compile_sweep_invariants_match_reference(grid):
    data, tprob, jprob = _problems()
    ours = compile_sweep(tprob, _grid(grid, dsvm_overrides), qp_iters=30)
    theirs = jengine.compile_sweep(jprob, _grid(grid, japi.dsvm_overrides),
                                   qp_iters=30)
    S = len(_grid(grid, dsvm_overrides))
    assert ours.n_configs == S and ours.inv.K.shape[0] == S
    assert ours.inv.Z.shape == tuple(theirs.inv.Z.shape)      # shared Z
    for name in ("ntp", "nbr"):
        np.testing.assert_array_equal(getattr(ours.inv, name).numpy(),
                                      np.asarray(getattr(theirs.inv, name)))
    for name in ("u", "a", "Z", "K", "hi", "L"):
        _close(getattr(ours.inv, name), getattr(theirs.inv, name), name)
    for name in sweep.SWEEP_FIELDS:
        np.testing.assert_array_equal(
            getattr(ours.prob, name).reshape(-1).numpy(),
            np.asarray(getattr(theirs.prob, name)))
    for name in ("active", "couple"):
        np.testing.assert_array_equal(getattr(ours.prob, name).numpy(),
                                      np.asarray(getattr(theirs.prob, name)))
    # precomputed (S, V, T) active-neighbor counts give the same masks
    # part as the counts _masks_part computes from the stacked masks
    counts = torch.einsum("vu,sut->svt", tprob.adj.float(), ours.prob.active)
    for name, a, b in zip(("ntp", "nbr", "u", "a", "hi"),
                          invariants._masks_part(ours.prob, counts),
                          invariants._masks_part(ours.prob)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("grid", GRIDS)
def test_sweep_run_matches_reference(grid):
    data, tprob, jprob = _problems()
    ours = compile_sweep(tprob, _grid(grid, dsvm_overrides), qp_iters=30)
    theirs = jengine.compile_sweep(jprob, _grid(grid, japi.dsvm_overrides),
                                   qp_iters=30)
    st, hist = ours.run(iters=4, eval_fn=evaluate.risk_eval_fn(
        V, data["X_test"], data["y_test"], "cpu"))
    jst, jhist = theirs.run(iters=4, eval_fn=jevaluate.risk_eval_fn(
        V, data["X_test"], data["y_test"]))
    assert hist.shape == (4, ours.n_configs, V, 2)
    for name, a, b in zip(st._fields, st, jst):
        _close(a, b, name)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist),
                               atol=1.0 / N_TEST)


def test_sweep_chain_matches_reference():
    data, tprob, jprob = _problems()
    ours = compile_sweep(tprob, _grid("eps", dsvm_overrides), qp_iters=30)
    theirs = jengine.compile_sweep(jprob, _grid("eps", japi.dsvm_overrides),
                                   qp_iters=30)
    ev = evaluate.risk_eval_fn(V, data["X_test"], data["y_test"], "cpu")
    jev = jevaluate.risk_eval_fn(V, data["X_test"], data["y_test"])
    st, hist = ours.run_chain(iters=3, eval_fn=ev)
    jst, jhist = theirs.run_chain(iters=3, eval_fn=jev)
    assert hist.shape == (3, 4, V, 2)
    for name, a, b in zip(st._fields, st, jst):
        _close(a, b, name)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist),
                               atol=1.0 / N_TEST)
    # the chain is the serial warm-started loop, bitwise
    prev = None
    for s, pc in enumerate(ours.config_problems):
        prev, _ = plan.compile_problem(pc, qp_iters=30).run(state=prev,
                                                            iters=3)
        for a, b in zip(st, prev):
            assert torch.equal(a[s], b)


@pytest.mark.parametrize("qp_solver", ["fista", "pg", "pallas_fused",
                                       "pallas_fused_multi"])
@pytest.mark.parametrize("grid", ["eps", "masks"])
def test_sweep_configs_are_their_serial_fits(qp_solver, grid):
    """Each config of a sweep, on every engine, against the port's own
    serial fit of it (its own compiled plan): bitwise."""
    _, tprob, _ = _problems()
    ours = compile_sweep(tprob, _grid(grid, dsvm_overrides), qp_iters=20,
                         qp_solver=qp_solver)
    st, _ = ours.run(iters=3)
    for s, pc in enumerate(ours.config_problems):
        want, _ = plan.compile_problem(pc, qp_iters=20,
                                       qp_solver=qp_solver).run(iters=3)
        for name, a, b in zip(want._fields, st, want):
            assert torch.equal(a[s], b), (s, name)


def test_config_plan_slices_back_to_serial():
    _, tprob, _ = _problems()
    ours = compile_sweep(tprob, _grid("masks", dsvm_overrides), qp_iters=20)
    for s, pc in enumerate(ours.config_problems):
        cp = ours.config_plan(s)
        assert cp.prob is pc and cp.qp_iters == 20
        fresh = invariants.compute_invariants(pc)
        for name, a, b in zip(fresh._fields, cp.inv, fresh):
            assert torch.equal(a, b), (s, name)
        got, _ = cp.run(iters=2)
        want, _ = plan.compile_problem(pc, qp_iters=20).run(iters=2)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_budgeted_sweep_k_is_the_dense_k(monkeypatch):
    """8-row panels over all S*V*T problems: K ``torch.equal`` the dense
    stacked K, L within rounding, the same states."""
    _, tprob, _ = _problems()
    cfgs = _grid("C", dsvm_overrides)
    dense = compile_sweep(tprob, cfgs, qp_iters=20)
    streamed = []
    panel = invariants.streamed_gram_panel
    monkeypatch.setattr(invariants, "streamed_gram_panel",
                        lambda *a, **k: streamed.append(1) or panel(*a, **k))
    budget = invariants.PlanBudget(tile=(8, 128))
    assert budget.row_chunk(4 * V * 2, tprob.X.shape[2]) == 8
    got = compile_sweep(tprob, cfgs, qp_iters=20, budget=budget)
    assert streamed == [1] and got.budget == budget
    assert torch.equal(got.inv.K, dense.inv.K)
    torch.testing.assert_close(got.inv.L, dense.inv.L, rtol=1e-6, atol=0)
    a, _ = got.run(iters=2)
    b, _ = dense.run(iters=2)
    for name, x, y in zip(a._fields, a, b):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6, msg=name)


def test_sweep_validation_errors():
    """The reference's test_sweep_validation_errors, in both packages."""
    data, tprob, jprob = _problems()
    for eng, prob, cfg_cls, fit, bk in (
            (sweep, tprob, SolverConfig, sweep_fit, backends),
            (jengine, jprob, japi.SolverConfig, japi.sweep_fit, jbackends)):
        kw = {"device": "cpu"} if fit is sweep_fit else {}
        with pytest.raises(ValueError, match="empty config grid"):
            eng.compile_sweep(prob, [])
        with pytest.raises(ValueError, match="unknown sweep override"):
            eng.compile_sweep(prob, [dict(qC=1.0)])
        with pytest.raises(ValueError, match="disagree on static"):
            eng.compile_sweep(prob, [cfg_cls(qp_iters=10),
                                     cfg_cls(qp_iters=20)])
        with pytest.raises(ValueError, match="disagree on static"):
            fit(data["X"], data["y"], [cfg_cls(iters=3), cfg_cls(iters=4)],
                mask=data["mask"], adj=prob.adj, **kw)
        with pytest.raises(ValueError, match="unknown QP engine"):
            eng.compile_sweep(prob, [dict()], qp_solver="nope")
        with pytest.raises(ValueError, match="per-fit only"):
            eng.compile_sweep(prob, [cfg_cls(qp_precision="bf16")])
        with pytest.raises(ValueError, match="single-fit"):
            fit(data["X"], data["y"], [dict()], base=cfg_cls(net=object()),
                **kw)
        splan = eng.compile_sweep(prob, [dict()], qp_iters=5)
        with pytest.raises(ValueError, match="sequential"):
            bk.run_sweep(splan, 1, backend="shard_map", chain=True)
        with pytest.raises(ValueError, match="single-host"):
            bk.run_sweep(splan, 1, backend="shard_map",
                         eval_fn=lambda s: 0.0)
        with pytest.raises(ValueError, match="unknown sweep backend"):
            bk.run_sweep(splan, 1, backend="nope")


def test_sweep_fit_is_the_solver_loop():
    """SolverConfig configs are complete specs and equal DTSVM fits; the
    DSVM override equals the DSVM solver; SweepResult's views."""
    data, adj = _data()
    base = SolverConfig(iters=3, qp_iters=20)
    cfgs = [base.replace(C=0.1), base.replace(eps1=0.5, eps2=3.0),
            dsvm_overrides(V)]
    res = sweep_fit(data["X"], data["y"], cfgs, mask=data["mask"], adj=adj,
                    base=base, X_test=data["X_test"], y_test=data["y_test"],
                    device="cpu")
    fits = [DTSVM(cfgs[0], device="cpu"), DTSVM(cfgs[1], device="cpu"),
            DSVM(base, device="cpu")]
    for s, f in enumerate(fits):
        f.fit(data["X"], data["y"], mask=data["mask"], adj=adj,
              X_test=data["X_test"], y_test=data["y_test"])
        for a, b in zip(res.state_of(s), f.state_):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(res.history[:, s],
                                      f.history_.numpy())
    assert len(res) == 3 and not res.chained
    risks = res.risks(data["X_test"], data["y_test"])
    assert tuple(risks.shape) == (3, V, 2)
    np.testing.assert_array_equal(risks.numpy(), res.final_risks())
    np.testing.assert_array_equal(res.global_risks(data["X_test"],
                                                   data["y_test"]),
                                  res.final_global_risks())
    assert res.final_global_risks().shape == (3, 2)
    bare = sweep_fit(data["X"], data["y"], cfgs[:1], mask=data["mask"],
                     adj=adj, base=base, device="cpu")
    assert bare.history is None
    with pytest.raises(ValueError, match="no history"):
        bare.final_risks()


def test_multi_solve_takes_a_shared_z(monkeypatch):
    """The multi engine gets the sweep's Z without its S axis: ``ops``
    broadcasts it up to lam's batch, on the CPU and on the card route
    (forced here, with the kernel's wrapper replaced by the plain
    version, so the shapes it receives are checked without a card)."""
    rng = np.random.default_rng(2)
    S, B, N, D = 3, 4, 6, 5
    Z = torch.from_numpy(rng.normal(size=(B, N, D)).astype(np.float32))
    K = ops.weighted_gram(Z, torch.from_numpy(
        rng.uniform(0.1, 1.0, size=(S, B, D)).astype(np.float32)))
    q = torch.ones((S, B, N))
    hi = torch.full((S, B, N), 0.3)
    lam0 = torch.zeros((S, B, N))
    gamma = 1.0 / K.abs().sum(-1).amax(-1)
    want = ops.qp_pg_multi(lam0, K, q, hi, gamma, iters=5,
                           Z=Z.expand(S, B, N, D))
    got = ops.qp_pg_multi(lam0, K, q, hi, gamma, iters=5, Z=Z)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    seen = []

    def fake_kernel(lam0, K, q, hi, gamma, *, iters, Z=None,
                    precision="f32"):
        seen.append(tuple(Z.shape))
        return ref.qp_pg_multi(lam0, K, q, hi, gamma, iters=iters, Z=Z,
                               precision=precision)

    monkeypatch.setattr(ops, "_on_card", lambda *t: True)
    monkeypatch.setattr(qp_kernel, "qp_pg_multi", fake_kernel)
    got = ops.qp_pg_multi(lam0, K, q, hi, gamma, iters=5, Z=Z)
    assert seen == [(S * B, N, D)]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _digest(state):
    return {n: hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()[
        :16] for n, t in zip(state._fields, state)}


# sha256 (first 16 hex digits) of each state leaf of a 3-iteration fit,
# recorded from the parent tree's code before the pieces of core.dtsvm and
# engine.plan learned to count their axes from the end; pg, pallas_fused
# and pallas_fused_multi share their bits on the CPU
_PG = {"DTSVM": {"r": "ede0c608dad79ec3", "alpha": "3d49aecb2005eb8c",
                 "beta": "3e415675e5f839e9", "lam": "5340c486cb32421c"},
       "DSVM": {"r": "e294bb0e9bf294bb", "alpha": "2ea9ab9198d16380",
                "beta": "d4a69bb7f6ca2aea", "lam": "cfc5e340e4e338a8"}}
_PARENT_DIGESTS = {
    "fista": {"DTSVM": {"r": "ec1b7e8e43c7211f", "alpha": "8960484ab019c7ee",
                        "beta": "7b4139a0ccc2634f", "lam": "36adf5b961273897"},
              "DSVM": {"r": "17042ec57197f40a", "alpha": "2ea9ab9198d16380",
                       "beta": "341f5173d5a79f6e", "lam": "25f7922e3848a922"}},
    "pg": _PG, "pallas_fused": _PG, "pallas_fused_multi": _PG}


@pytest.mark.parametrize("qp_solver", sorted(_PARENT_DIGESTS))
@pytest.mark.parametrize("solver", ["DTSVM", "DSVM"])
def test_single_fit_state_is_unchanged_by_the_config_axis(qp_solver, solver):
    """A single fit computes exactly what it computed before the sweep's
    config axis came in: its state's bits are the parent tree's."""
    counts = np.array([[9, 6], [8, 9], [9, 5]])
    data = jsynthetic.make_multitask_data(V=3, T=2, p=3, n_train=counts,
                                          n_test=8, seed=7)
    adj = jgraph.make_graph("ring", 3, seed=0)
    cfg = SolverConfig(C=0.5, eps1=0.5, eta2=0.7, iters=3, qp_iters=7,
                       qp_solver=qp_solver)
    cls = {"DTSVM": DTSVM, "DSVM": DSVM}[solver]
    couple = np.array([1.0, 0.0, 1.0], np.float32) if solver == "DTSVM" \
        else None
    st = cls(cfg, device="cpu").fit(data["X"], data["y"], mask=data["mask"],
                                    adj=adj, couple=couple).state_
    assert _digest(st) == _PARENT_DIGESTS[qp_solver][solver]
