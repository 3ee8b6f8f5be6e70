"""The port's CSVM, the ``Solver`` protocol and the evaluation helpers
against the reference, on the CPU.

The JAX side runs its plain path (``REPRO_USE_PALLAS=0``); the port runs
its plain versions on one torch thread.  Tolerances: CSVM's w within
1e-4 of its largest magnitude; b within 1e-3 of the largest magnitude of
(w, b): the bias column carries the weight 1/eps_b = 1000, and an f64 run
of the same 200 FISTA iterations sits 2-6e-4 from both f32 packages' b
on these inputs, so no f32 implementation is nearer than that to the
reference's b.  Risks are equal.  One consensus ``step`` rtol 1e-4,
atol 1e-5.
"""
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import evaluate as jevaluate
from repro.core import csvm as jcsvm
from repro.core import dtsvm as jcore
from repro.core import graph as jgraph
from repro.data import synthetic as jsynthetic
from repro_torch.api import CSVM, DSVM, DTSVM, Solver, SolverConfig
from repro_torch.api import evaluate
from repro_torch.core import csvm
from repro_torch.engine import plan
from repro_torch.kernels import gram as gram_kernel
from repro_torch.kernels import ops, ref

T = torch.from_numpy


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


def _pooled(T_=3, N=40, p=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(T_, N, p)).astype(np.float32)
    y = np.where(X[..., 0] + 0.3 * rng.normal(size=(T_, N)) > 0, 1.0,
                 -1.0).astype(np.float32)
    mask = (rng.uniform(size=(T_, N)) > 0.2).astype(np.float32)
    return X, y, mask


def _network(V=4, T_=2, p=10, seed=0):
    n_train = np.zeros((V, T_), int)
    n_train[:, 0] = jsynthetic.split_counts(24, V)
    n_train[:, 1] = jsynthetic.split_counts(120, V)
    data = jsynthetic.make_multitask_data(V=V, T=T_, p=p, n_train=n_train,
                                          n_test=300, relatedness=0.9,
                                          seed=seed)
    return data, jgraph.make_graph("random", V, degree=0.6, seed=seed)


def _close_wb(w, b, w_ref, b_ref):
    w_ref, b_ref = np.asarray(w_ref), np.asarray(b_ref)
    w_scale = float(np.abs(w_ref).max())
    scale = max(w_scale, float(np.abs(b_ref).max()))
    assert float(np.abs(w.numpy() - w_ref).max()) <= 1e-4 * w_scale
    assert float(np.abs(b.numpy() - b_ref).max()) <= 1e-3 * scale


@pytest.mark.parametrize("C,qp_iters", [(0.05, 200), (0.01, 600)])
def test_csvm_fit_tasks_matches_reference(C, qp_iters):
    X, y, mask = _pooled()
    w, b = csvm.csvm_fit_tasks(T(X), T(y), C, T(mask), qp_iters=qp_iters)
    w_ref, b_ref = jcsvm.csvm_fit_tasks(X, y, C, mask, qp_iters=qp_iters)
    assert w.shape == (3, 4) and b.shape == (3,)
    _close_wb(w, b, w_ref, b_ref)
    w1, b1 = csvm.csvm_fit(T(X[1]), T(y[1]), C, T(mask[1]),
                           qp_iters=qp_iters)
    w1_ref, b1_ref = jcsvm.csvm_fit(X[1], y[1], C, mask[1],
                                    qp_iters=qp_iters)
    _close_wb(w1, b1, w1_ref, b1_ref)
    Xt, yt = T(X[1]), T(y[1])
    assert float(csvm.csvm_risk(w1, b1, Xt, yt)) == \
        float(jcsvm.csvm_risk(w1_ref, b1_ref, X[1], y[1]))


def test_csvm_fit_tasks_is_the_per_task_loop():
    """The batched solve against the per-task loop.  Bitwise wherever the
    batch is two or more tasks (torch's batched CPU products give each
    problem the same bits at any batch size); a one-task fit, which is
    ``csvm_fit``, takes another CPU product for FISTA's matvec, whose
    bits differ.  After 150 iterations w differs by up to 1.8e-6 and b,
    whose column carries the weight 1000, by up to 8.8e-5 of the largest
    magnitude of (w, b); the loop of ``csvm_fit`` is held to 1e-5 (w)
    and 3e-4 (b, a few times that reading) of it."""
    X, y, mask = (T(a) for a in _pooled(T_=4))
    w, b = csvm.csvm_fit_tasks(X, y, 0.05, mask, qp_iters=150)
    for t in (0, 2):
        w2, b2 = csvm.csvm_fit_tasks(X[t:t + 2], y[t:t + 2], 0.05,
                                     mask[t:t + 2], qp_iters=150)
        assert torch.equal(w2, w[t:t + 2]) and torch.equal(b2, b[t:t + 2])
    scale = max(float(w.abs().max()), float(b.abs().max()))
    for t in range(4):
        w1, b1 = csvm.csvm_fit(X[t], y[t], 0.05, mask[t], qp_iters=150)
        assert float((w1 - w[t]).abs().max()) <= 1e-5 * scale
        assert float((b1 - b[t]).abs().max()) <= 3e-4 * scale


def test_csvm_solver_matches_reference():
    data, adj = _network()
    cfg = dict(C=0.01, qp_iters=300)
    got = CSVM(SolverConfig(**cfg), C_scale=2.0, device="cpu").fit(
        data["X"], data["y"], mask=data["mask"], adj=adj)
    want = japi.CSVM(japi.SolverConfig(**cfg), C_scale=2.0).fit(
        data["X"], data["y"], mask=data["mask"], adj=adj)
    _close_wb(got.w_, got.b_, want.w_, want.b_)
    np.testing.assert_array_equal(
        got.global_risks(data["X_test"], data["y_test"]),
        want.global_risks(data["X_test"], data["y_test"]))
    pred = got.predict(data["X_test"])
    assert tuple(pred.shape) == data["y_test"].shape
    np.testing.assert_array_equal(pred.numpy(),
                                  np.asarray(want.predict(data["X_test"])))
    assert got.init_state() == (got.w_, got.b_)


def test_csvm_single_task_layout_and_refusals(monkeypatch):
    """(N, p) data is the (1, 1, N, p) fit; the refusals are the
    reference's ValueErrors; a centralized model has zero residuals."""
    X, y, _ = _pooled(T_=1, N=30)
    flat = CSVM(qp_iters=100, device="cpu").fit(X[0], y[0])
    nested = CSVM(qp_iters=100, device="cpu").fit(X[None], y[None])
    assert torch.equal(flat.w_, nested.w_) and torch.equal(flat.b_,
                                                           nested.b_)
    assert tuple(flat.decision(X[0]).shape) == (1, 30)
    assert tuple(flat.risks(X[0], y[0]).shape) == (1,)
    assert [float(r) for r in flat.residuals()] == [0.0, 0.0]
    with pytest.raises(NotImplementedError, match="single-shot"):
        flat.step(None, None)
    for field, words in ((dict(net=object()), "centralized"),
                         (dict(telemetry=True), "single-shot")):
        with pytest.raises(ValueError, match=words):
            CSVM(SolverConfig(**field), device="cpu").fit(X[0], y[0])
        with pytest.raises(ValueError, match=words):
            japi.CSVM(japi.SolverConfig(**field)).fit(X[0], y[0])
    with pytest.raises(RuntimeError, match="fit"):
        CSVM().predict(X[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CSVM().fit(X[0], y[0])


def test_gram_broadcasts_one_a_over_a_stack_of_z(monkeypatch):
    """CSVM's K: one (p+1,) ``a`` over a (T, N, p+1) Z.  The card path must
    hand the kernel one ``a`` row per problem; here the kernel's wrapper is
    replaced by the plain version and the card route forced, so the shapes
    it receives are checked without a card."""
    rng = np.random.default_rng(1)
    Z = T(rng.normal(size=(3, 7, 5)).astype(np.float32))
    a = T(rng.uniform(0.1, 2.0, size=(5,)).astype(np.float32))
    want = ref.weighted_gram(Z, a.expand(3, 5))
    for t in range(3):
        torch.testing.assert_close(want[t], ref.weighted_gram(Z[t], a),
                                   rtol=1e-6, atol=1e-6)
    assert torch.equal(ops.weighted_gram(Z, a), want)
    seen = []

    def fake_kernel(Zf, af):
        seen.append((tuple(Zf.shape), tuple(af.shape)))
        return ref.weighted_gram(Zf, af)

    monkeypatch.setattr(ops, "_on_card", lambda *t: True)
    monkeypatch.setattr(gram_kernel, "weighted_gram", fake_kernel)
    assert torch.equal(ops.weighted_gram(Z, a), want)
    assert seen == [((3, 7, 5), (3, 5))]


def test_every_solver_is_a_solver():
    for cls in (CSVM, DSVM, DTSVM):
        assert isinstance(cls(), Solver)
    for cls in (japi.CSVM, japi.DSVM, japi.DTSVM):
        assert isinstance(cls(), japi.Solver)


@pytest.mark.parametrize("solver", ["DTSVM", "DSVM"])
def test_init_state_and_step_match_reference(solver):
    """``init_state`` and two one-shot ``step`` calls against the
    reference's; inside the port, ``step`` is the compiled plan's step
    bitwise."""
    data, adj = _network()
    cfg = dict(C=0.05, qp_iters=30, qp_solver="pg")
    ours = {"DTSVM": DTSVM, "DSVM": DSVM}[solver](SolverConfig(**cfg))
    theirs = getattr(japi, solver)(japi.SolverConfig(**cfg))
    prob = ours.make_problem(data["X"], data["y"], data["mask"], adj,
                             device="cpu")
    jprob = theirs.make_problem(data["X"], data["y"], data["mask"], adj)
    st, jst = ours.init_state(prob), theirs.init_state(jprob)
    for name, a, b in zip(st._fields, st, jst):
        assert a.shape == b.shape and not a.any(), name
    for _ in range(2):
        st, jst = ours.step(st, prob), theirs.step(jst, jprob)
    for name, a, b in zip(st._fields, st, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    want, _ = plan.compile_problem(prob, ours.config).run(iters=2)
    for name, a, b in zip(st._fields, st, want):
        assert torch.equal(a, b), name


def test_risk_curve_and_consensus_residuals_match_reference():
    data, adj = _network()
    cfg = dict(C=0.05, iters=4, qp_iters=30)
    ours = DTSVM(SolverConfig(**cfg), device="cpu").fit(
        data["X"], data["y"], mask=data["mask"], adj=adj,
        X_test=data["X_test"], y_test=data["y_test"])
    theirs = japi.DTSVM(japi.SolverConfig(**cfg)).fit(
        data["X"], data["y"], mask=data["mask"], adj=adj,
        X_test=data["X_test"], y_test=data["y_test"])
    curve = evaluate.risk_curve(ours.history_)
    assert isinstance(curve, np.ndarray) and curve.shape == (4, 4, 2)
    np.testing.assert_allclose(curve, jevaluate.risk_curve(theirs.history_),
                               atol=1.0 / 300)
    assert evaluate.risk_curve(None) is None
    got = evaluate.consensus_residuals(ours.state_, ours.problem_)
    want = jevaluate.consensus_residuals(theirs.state_, theirs.problem_)
    np.testing.assert_allclose([float(g) for g in got],
                               [float(w) for w in want], rtol=1e-3,
                               atol=1e-6)
    assert [float(g) for g in got] == [float(g) for g in ours.residuals()]
    # the math layer's own (the reference re-exports it)
    assert np.isfinite(float(jcore.consensus_residuals(
        theirs.state_, theirs.problem_)[0]))
