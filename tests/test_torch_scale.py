"""The port's large-n path against the reference: ``PlanBudget`` row
chunks, the streamed Gram build, the factored operator and budgeted
replans.

The JAX side runs its plain path (``REPRO_USE_PALLAS=0``; the tiled
Pallas kernel in interpret mode where a test names it); the port runs its
plain versions on the CPU, on one torch thread.  Tolerances: the row panel
against the tiled Pallas kernel atol = rtol = 3e-5; invariants (K, L)
3e-5 relative to each leaf's largest magnitude; ``plan.run`` rtol 1e-4,
atol 1e-5 on r, alpha, beta and lam; fit risks 1e-3.  Across frameworks
nothing is held bitwise (the reference's own tiled-vs-square bitwise test
fails under jax 0.9.0 at N=100).  Inside the port, a budgeted K and L are
held bitwise equal to the dense ones: on one CPU thread torch's row
panels are the rows of the dense product.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import solvers as jsolvers
from repro.core import dtsvm as jcore
from repro.core import graph as jgraph
from repro.data import synthetic as jsynthetic
from repro.engine import invariants as jinv
from repro.engine import plan as jplan
from repro.kernels import gram as jgram
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.api import DTSVM, SolverConfig
from repro_torch.engine import invariants, plan
from repro_torch.kernels import ops, ref

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and the bitwise checks below hold for torch's single-thread CPU
    products."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_plain_path(monkeypatch):
    monkeypatch.setenv("REPRO_USE_PALLAS", "0")


def _data(V=4, T_=2, n=24, p=10, seed=0):
    counts = np.full((V, T_), n, int)
    data = jsynthetic.make_multitask_data(
        V=V, T=T_, p=p, n_train=counts, n_test=60, relatedness=0.9,
        seed=seed)
    adj = jgraph.make_graph("random", V, degree=0.8, seed=seed)
    return data, adj


def _problems(**kw):
    data, adj = _data(**kw)
    jprob = jcore.make_problem(data["X"], data["y"], data["mask"], adj,
                               C=0.01)
    return jprob, convert.to_torch(jprob, device="cpu")


def _budget_pair(i, V=4, T_=2, N=24):
    """tests/test_scale.py:_budgets[i] for a (V, T, N) problem: the
    reference's and the port's."""
    kw = [dict(max_elems=V * T_ * 8 * N),       # smallest chunks
          dict(max_elems=V * T_ * 16 * N),
          dict(tile=(8, 128)),                  # tile_m as chunk
          dict(max_elems=10 ** 12)][i]          # non-binding
    return jinv.PlanBudget(**kw), invariants.PlanBudget(**kw)


BUDGET_IDS = ["chunk8", "chunk16", "tile8", "nonbinding"]


def _rel_close(got, want, rel, name):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rel * scale, name


# ---------------------------------------------------------------------------
# PlanBudget.row_chunk: the reference's integers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(), dict(max_elems=1000), dict(max_elems=6400), dict(max_elems=7),
    dict(max_elems=2 ** 27), dict(tile=(32, 128)), dict(tile=(5, 100)),
    dict(tile=(1000, 1000)), dict(max_elems=9600, tile=(64, 128)),
])
def test_row_chunk_matches_reference(kw):
    mine, theirs = invariants.PlanBudget(**kw), jinv.PlanBudget(**kw)
    for batch in (1, 2, 8, 20):
        for n in (1, 8, 10, 60, 100, 3352, 20000):
            for cols in (None, 64, 800):
                assert mine.row_chunk(batch, n, cols) == \
                    theirs.row_chunk(batch, n, cols), (batch, n, cols)


def test_row_chunk_of_the_large_fit():
    """bench_scale's large_fit: B=2, N=20000 under 2**27 elements streams
    3352-row panels, six of them."""
    chunk = invariants.PlanBudget(max_elems=2 ** 27).row_chunk(2, 20000)
    assert chunk == 3352
    assert invariants._row_starts(20000, chunk) == [
        0, 3352, 6704, 10056, 13408, 16648]
    # the reference's default tile means the same row chunk in the port
    assert invariants.PlanBudget(tile=jgram.DEFAULT_TILE).row_chunk(
        2, 20000) == 256


@pytest.mark.parametrize("kw,B,n,d,chunk,operands", [
    (dict(tile=(8, 128)), 20, 60, 11, 8, 26400),
    (dict(max_elems=2 ** 24), 2, 20000, 257, 416, 20560000),
    (dict(max_elems=2 ** 27), 2, 20000, 257, 3352, 20560000),
])
def test_card_operands_beside_a_binding_budget(kw, B, n, d, chunk, operands):
    """Under a binding budget the chunk stays the reference's, and the
    card's build holds the Gram kernels' operands beside it: 2·B·D·N4
    floats of prescaled Z, not charged to max_elems (PlanBudget's
    docstring).  Where the chunk is below 2·D rows they outweigh the
    panel."""
    from repro_torch.kernels import gram

    budget = invariants.PlanBudget(**kw)
    assert budget.row_chunk(B, n) == jinv.PlanBudget(**kw).row_chunk(B, n) \
        == chunk
    assert gram.prescale_elems(B, n, d) == operands
    assert (operands > B * chunk * n) == (chunk < 2 * d)


# ---------------------------------------------------------------------------
# the row panel (the tiled kernel's plain version) and its dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tile", [(8, 128), (16, 256)])
def test_gram_rows_plain_matches_tiled_pallas_kernel(tile):
    """A row panel of the port (rows 36-59 of a 60-row K) against the
    reference's tiled Pallas kernel on the same rows."""
    rng = np.random.default_rng(11)
    Zn = rng.normal(size=(60, 11)).astype(np.float32)
    a = rng.uniform(0.1, 2.0, size=(11,)).astype(np.float32)
    want = jgram.weighted_gram_tiled(jnp.asarray(Zn[36:]), jnp.asarray(a),
                                     jnp.asarray(Zn), tile=tile,
                                     interpret=True)
    [(start, got)] = ops.weighted_gram_panels(T(Zn)[None], T(a)[None],
                                              [36], 24)
    assert start == 36 and got.shape == (1, 24, 60)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


def test_gram_rows_write_into_an_output_view():
    rng = np.random.default_rng(12)
    Z = T(rng.normal(size=(3, 40, 7)).astype(np.float32))
    a = T(rng.uniform(0.1, 2.0, size=(3, 7)).astype(np.float32))
    K = torch.full((3, 40, 40), float("nan"))
    [(_, got)] = ops.weighted_gram_panels(Z, a, [16], 8, out=K)
    assert got.data_ptr() == K[:, 16:24].data_ptr()
    assert torch.equal(K[:, 16:24], ref.weighted_gram(Z, a)[:, 16:24])
    assert torch.isnan(K[:, :16]).all() and torch.isnan(K[:, 24:]).all()


def test_weighted_gram_tile_and_shared_z(monkeypatch):
    """An ``a`` with an extra leading (config) dim broadcasts Z up, as in
    the reference.  The port's square build is held against the
    reference's ``tile=(8, 128)`` build (its tiled Pallas kernel in
    interpret mode), which is what a non-binding tile runs there."""
    rng = np.random.default_rng(13)
    Z = rng.normal(size=(2, 3, 20, 5)).astype(np.float32)
    a = rng.uniform(0.1, 2.0, size=(4, 2, 3, 5)).astype(np.float32)
    got = ops.weighted_gram(T(Z), T(a))
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    want = np.asarray(jops.weighted_gram(jnp.asarray(Z), jnp.asarray(a),
                                         tile=(8, 128)))
    assert got.shape == want.shape == (4, 2, 3, 20, 20)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("tile", [(64, 128), (256, 256)])
def test_nonbinding_tile_builds_the_dense_invariants(tile, monkeypatch):
    """A plan under a ``PlanBudget(tile=...)`` that does not bind builds K
    with one square Gram call and no row panel: its invariants are the
    dense plan's bitwise, and within rtol/atol 3e-5 of the reference's
    plan, which builds that K with its tiled Pallas kernel (interpret
    mode)."""
    jprob, tprob = _problems()
    V, T_, N = tprob.X.shape[:3]
    budget = invariants.PlanBudget(tile=tile)
    assert budget.row_chunk(V * T_, N) is None

    def no_panels(*args, **kwargs):
        raise AssertionError("a non-binding budget streamed row panels")

    monkeypatch.setattr(ops, "weighted_gram_panels", no_panels)
    tinvs = plan.compile_problem(tprob, budget=budget).inv
    dense = plan.compile_problem(tprob).inv
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    jinvs = jplan.compile_problem(jprob,
                                  budget=jinv.PlanBudget(tile=tile)).inv
    for name in jinv.PlanInvariants._fields:
        t = getattr(tinvs, name)
        np.testing.assert_allclose(t.numpy(), np.asarray(getattr(jinvs,
                                                                 name)),
                                   rtol=3e-5, atol=3e-5, err_msg=name)
        assert torch.equal(t, getattr(dense, name)), name


# ---------------------------------------------------------------------------
# the streamed build: bitwise the dense one inside the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,d", [(64, 11), (100, 11), (256, 33), (1024, 65)])
def test_streamed_gram_panel_is_the_dense_build(n, d):
    rng = np.random.default_rng(n + d)
    Z = T(rng.normal(size=(2, n, d)).astype(np.float32))
    a = T(rng.uniform(0.1, 2.0, size=(2, d)).astype(np.float32))
    dense = ref.weighted_gram(Z, a)
    want_rs = dense.abs().sum(-1)
    for chunk in (8, 24, 100):
        K, rs = invariants.streamed_gram_panel(Z, a, chunk)
        assert torch.equal(K, dense), chunk
        assert torch.equal(rs, want_rs), chunk
    L = invariants.streamed_lipschitz(Z, a)
    assert torch.equal(L, torch.clamp_min(want_rs.amax(-1), 1e-12))


@pytest.mark.parametrize("materialize_k", [True, False],
                         ids=["materialized", "factored"])
@pytest.mark.parametrize("i", range(4), ids=BUDGET_IDS)
def test_compute_invariants_under_budget_match_reference(i, materialize_k):
    jprob, tprob = _problems()
    jb, tb = _budget_pair(i)
    jinvs = jinv.compute_invariants(jprob, budget=jb,
                                    materialize_k=materialize_k)
    tinvs = invariants.compute_invariants(tprob, budget=tb,
                                          materialize_k=materialize_k)
    dense = invariants.compute_invariants(tprob)
    for name in jinv.PlanInvariants._fields:
        j, t = getattr(jinvs, name), getattr(tinvs, name)
        if j is None:
            assert t is None and name == "K" and not materialize_k
            continue
        _rel_close(t.numpy(), j, 3e-5, name)
        # inside the port: the budgeted build is the dense build, bitwise
        assert torch.equal(t, getattr(dense, name)), name


# ---------------------------------------------------------------------------
# plans and fits: budgeted, factored, replanned
# ---------------------------------------------------------------------------
def _assert_states_close(got, want):
    for name in jcore.DTSVMState._fields:
        np.testing.assert_allclose(
            getattr(got, name), np.asarray(getattr(want, name)), rtol=1e-4,
            atol=1e-5, err_msg=name)


@pytest.mark.parametrize("qp_operator", ["materialized", "factored"])
@pytest.mark.parametrize("i", [0, 2], ids=["chunk8", "tile8"])
def test_budgeted_plan_run_matches_reference(i, qp_operator):
    jprob, tprob = _problems()
    jb, tb = _budget_pair(i)
    kw = dict(qp_iters=25, qp_solver="pallas_fused_multi",
              qp_operator=qp_operator)
    jpl = jplan.compile_problem(jprob, budget=jb, **kw)
    tpl = plan.compile_problem(tprob, budget=tb, **kw)
    assert (tpl.inv.K is None) == (qp_operator == "factored")
    want, _ = jpl.run(iters=4)
    got, _ = tpl.run(iters=4)
    _assert_states_close(convert.to_numpy(got), want)


def test_factored_fit_risks_match_reference():
    data, adj = _data(V=4, T_=2, n=30)
    cfg = dict(C=0.05, iters=10, qp_iters=30, qp_solver="pallas_fused_multi",
               qp_operator="factored")
    jfit = jsolvers.DTSVM(jsolvers.SolverConfig(
        budget=jinv.PlanBudget(max_elems=4 * 2 * 8 * 30), **cfg)).fit(
        data["X"], data["y"], mask=data["mask"], adj=adj)
    tfit = DTSVM(SolverConfig(
        budget=invariants.PlanBudget(max_elems=4 * 2 * 8 * 30), **cfg),
        device="cpu").fit(data["X"], data["y"], mask=data["mask"], adj=adj)
    np.testing.assert_allclose(
        tfit.global_risks(data["X_test"], data["y_test"]),
        jfit.global_risks(data["X_test"], data["y_test"]), atol=1e-3)


@pytest.mark.parametrize("qp_operator", ["materialized", "factored"])
def test_replan_under_budget_matches_reference(qp_operator):
    jprob, tprob = _problems()
    jb, tb = _budget_pair(0)
    kw = dict(qp_iters=25, qp_solver="pallas_fused_multi",
              qp_operator=qp_operator)
    jpl = jplan.compile_problem(jprob, budget=jb, **kw)
    tpl = plan.compile_problem(tprob, budget=tb, **kw)
    V, T_ = jprob.X.shape[:2]
    active = np.ones((V, T_), np.float32)
    active[0, 1] = 0.0                   # node 0 leaves task 1
    couple = np.ones((V,), np.float32)
    couple[2] = 0.0                      # node 2 stops coupling
    events = [dict(active=active), dict(couple=couple),
              dict(active=np.ones((V, T_), np.float32))]
    for ev in events:
        old = tpl
        jpl, tpl = jpl.replan(**ev), tpl.replan(**ev)
        assert tpl.stats == jpl.stats
        assert tpl.budget == tb
        changed = (old.inv.a != tpl.inv.a).any(-1)
        assert 0 < int(changed.sum()) < V * T_
        for name in ("a", "L", "hi", "u"):
            _rel_close(getattr(tpl.inv, name).numpy(),
                       getattr(jpl.inv, name), 3e-5, name)
        if qp_operator == "factored":
            assert tpl.inv.K is None
            assert torch.equal(tpl.inv.L[~changed], old.inv.L[~changed])
        else:
            _rel_close(tpl.inv.K.numpy(), jpl.inv.K, 3e-5, "K")
            assert torch.equal(tpl.inv.K[~changed], old.inv.K[~changed])
            # the rebuilt slices are the dense build's, bitwise
            fresh = invariants.compute_invariants(tpl.prob)
            assert torch.equal(tpl.inv.K, fresh.K)
            assert torch.equal(tpl.inv.L, fresh.L)
    assert tpl.stats["replans"] == 3
    want, _ = jpl.run(iters=3)
    got, _ = tpl.run(iters=3)
    _assert_states_close(convert.to_numpy(got), want)


def test_replan_without_a_change_reuses_everything():
    _, tprob = _problems()
    tpl = plan.compile_problem(tprob, qp_iters=5)
    again = tpl.replan(active=tprob.active.clone())
    assert again.inv.K is tpl.inv.K and again.inv.L is tpl.inv.L
    V, T_ = tprob.X.shape[:2]
    assert again.stats == {"gram_slices_computed": V * T_,
                           "gram_slices_reused": V * T_, "replans": 1}
