"""The port's ``OnlineSession`` against the reference's.

Each scenario of the reference's session tests (tests/test_api.py and
tests/test_engine.py) runs here twice: inside the port, held bitwise
where the reference asserts bitwise (one torch thread), and against the
JAX session on the same numpy inputs, the port's final state within
1e-4 of each leaf's largest magnitude (the gap observed is printed: on
this tree 1e-7 to 1e-5).  The JAX side runs its plain path
(``REPRO_USE_PALLAS=0``); the port runs on the CPU.
"""
import numpy as np
import pytest
import torch

from repro.api import OnlineSession as JOnlineSession
from repro.api import SolverConfig as JSolverConfig
from repro.api import solvers as jsolvers
from repro.core import dtsvm as jcore
from repro.core import graph as jgraph
from repro.data import synthetic as jsynthetic
from repro.net import NetConfig as JNetConfig
from repro_torch.api import NetConfig, OnlineSession, SolverConfig
from repro_torch.api import solvers
from repro_torch.core import dtsvm as core
from repro_torch.engine import plan as engine_plan
from repro_torch.figures import fig7_online, golden
from test_torch_api import _roadmap_modules

REL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Bitwise comparisons inside the port need one reduction order; the
    suite's worker processes would oversubscribe the cores besides."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_plain_path(monkeypatch):
    monkeypatch.setenv("REPRO_USE_PALLAS", "0")


def _online_fixture(V=6, T=3, seed=0):
    """tests/test_api.py's Fig.-7 data: 10/10/40 samples, full graph."""
    n = np.zeros((V, T), int)
    n[:, 0] = 10
    n[:, 1] = 10
    n[:, 2] = 40
    data = jsynthetic.make_multitask_data(
        V=V, T=T, p=10, n_train=n, n_test=300, relatedness=0.9, seed=seed)
    return data, jgraph.full(V)


def _make(V=6, T=2, n=9, seed=0, n_test=80):
    """tests/test_engine.py's small data on a random graph."""
    data = jsynthetic.make_multitask_data(
        V=V, T=T, p=10, n_train=np.full((V, T), n, int), n_test=n_test,
        relatedness=0.9, seed=seed)
    return data, jgraph.make_graph("random", V, degree=0.8, seed=0)


def _act(V, T, tasks):
    a = np.zeros((V, T), np.float32)
    for t in tasks:
        a[:, t] = 1.0
    return a


def _pair(data, A, cfg_kw, **kw):
    """The same session in both packages (the port's on the CPU)."""
    common = dict(mask=data["mask"], adj=A, **kw)
    return (OnlineSession(data["X"], data["y"], device="cpu",
                          config=SolverConfig(**cfg_kw), **common),
            JOnlineSession(data["X"], data["y"],
                           config=JSolverConfig(**cfg_kw), **common))


def _assert_equal(a: core.DTSVMState, b: core.DTSVMState):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def _assert_near_reference(state: core.DTSVMState, jstate, label=""):
    """Each leaf within REL of the JAX leaf's largest magnitude."""
    gaps = {}
    for name, got, want in zip(state._fields, state, jstate):
        want = np.asarray(want, np.float64)
        err = float(np.abs(got.numpy().astype(np.float64) - want).max())
        scale = float(np.abs(want).max())
        gaps[name] = err / max(scale, 1e-30)
        assert err <= REL * scale, (label, name, err, scale)
    print(f"{label} port vs JAX, relative gap per leaf: "
          + ", ".join(f"{k} {v:.1e}" for k, v in gaps.items()))


STAGES = [([0, 1, 2], 0.0), ([0, 2], 1.0), ([1, 2], 0.0), ([1, 2], 1.0),
          ([2], 0.0)]


def test_session_replays_online_transfer_bit_for_bit():
    """The five-stage scenario through the session equals the hand-rolled
    per-stage make_problem + run_dtsvm loop bitwise, and the JAX session
    within REL."""
    V, T = 6, 3
    data, A = _online_fixture(V, T)
    cfg = dict(C=0.01, eps1=1.0, eps2=100.0, qp_iters=50)
    state = None
    for tasks, couple in STAGES:
        prob = core.make_problem(data["X"], data["y"], data["mask"], A,
                                 C=0.01, eps1=1.0, eps2=100.0,
                                 active=_act(V, T, tasks),
                                 couple=np.full(V, couple, np.float32),
                                 device="cpu")
        if state is None:
            state = core.init_state(prob)
        state, _ = core.run_dtsvm(prob, 10, qp_iters=50, state=state)
    sess, jsess = _pair(data, A, cfg)
    for s in (sess, jsess):
        for tasks, couple in STAGES:
            s.set_active(_act(V, T, tasks)).set_coupling(
                np.full(V, couple, np.float32))
            s.run(10)
    _assert_equal(sess.state, state)
    assert sess.iteration == jsess.iteration == 50
    _assert_near_reference(sess.state, jsess.state, "five stages")


def test_session_membership_events():
    """The event methods give the reference's masks, and refuse a full
    mask together with nodes= as it does."""
    V, T = 6, 3
    data, A = _online_fixture(V, T)
    sess, jsess = _pair(data, A, {}, active=_act(V, T, [2]),
                        couple=False * np.ones(V))
    for s in (sess, jsess):
        s.add_task(0)
        s.add_task(1, nodes=[0, 1])
        s.drop_task(0, nodes=[3])
        s.set_coupling(True, nodes=[2])
    np.testing.assert_array_equal(sess.active, np.asarray(jsess.active))
    np.testing.assert_array_equal(sess.couple, np.asarray(jsess.couple))
    assert sess.active[0, 1] == 1.0 and sess.active[5, 1] == 0.0
    assert sess.couple[2] == 1.0 and sess.couple[0] == 0.0
    sess.drop_task(0)
    np.testing.assert_array_equal(sess.active[:, 0], np.zeros(V))
    sess.set_coupling(False)
    np.testing.assert_array_equal(sess.couple, np.zeros(V))
    for s in (sess, jsess):
        with pytest.raises(ValueError, match="not both"):
            s.set_coupling(np.ones(V), nodes=[0])


def test_session_dropped_task_state_freezes():
    """A task that leaves keeps its classifier bit for bit."""
    V, T = 6, 3
    data, A = _online_fixture(V, T)
    sess, jsess = _pair(data, A, dict(qp_iters=40))
    for s in (sess, jsess):
        s.run(5)
    r_before = sess.state.r[:, 0].clone()
    assert float(r_before.abs().max()) > 0
    for s in (sess, jsess):
        s.drop_task(0)
        s.run(5)
    assert torch.equal(sess.state.r[:, 0], r_before)
    _assert_near_reference(sess.state, jsess.state, "dropped task")


def test_session_records_history_blocks():
    V, T = 6, 3
    data, A = _online_fixture(V, T)
    sess, jsess = _pair(data, A, dict(qp_iters=40), X_test=data["X_test"],
                        y_test=data["y_test"])
    h1, h2 = sess.run(4), sess.run(3)
    j1, j2 = jsess.run(4), jsess.run(3)
    assert h1.shape == (4, V, T) and h2.shape == (3, V, T)
    assert isinstance(h1, np.ndarray) and len(sess.history) == 2
    assert sess.global_risks().shape == (T,)
    # one test sample of 300 is the resolution of a risk
    gap = max(float(np.abs(h - np.asarray(j)).max())
              for h, j in ((h1, j1), (h2, j2)))
    print(f"history blocks port vs JAX: largest risk gap {gap:.2e}")
    assert gap <= 1.0 / 300 + 1e-6
    np.testing.assert_allclose(sess.global_risks(), jsess.global_risks(),
                               atol=1.0 / 300 + 1e-6)
    _assert_near_reference(sess.state, jsess.state, "history blocks")
    task_res, node_res = sess.residuals()
    jt, jn = jsess.residuals()
    np.testing.assert_allclose([float(task_res), float(node_res)],
                               [float(jt), float(jn)], rtol=1e-3,
                               atol=1e-6)


def test_session_jit_path_close_to_eager():
    """jit=True (the core loop on a fresh problem per run) is numerically
    equivalent to the plan path, within the reference's 1e-4."""
    V, T = 6, 3
    data, A = _online_fixture(V, T)
    cfg = dict(qp_iters=40, eps2=100.0)
    a, ja = _pair(data, A, cfg)
    b, jb = _pair(data, A, cfg, jit=True)
    for s in (a, b, ja, jb):
        s.run(6)
        s.drop_task(0)
        s.set_coupling(False)
        s.run(6)
    for name, x, y in zip(a.state._fields, a.state, b.state):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-4, msg=name)
    _assert_near_reference(b.state, jb.state, "jit=True")


def test_session_jit_path_respects_qp_solver():
    """jit=True routes cfg.qp_solver: an unknown engine fails fast, and
    the fused step engine gives eager mode's classifier."""
    data, A = _make(V=4, T=2, n=6)
    sess = OnlineSession(data["X"], data["y"], mask=data["mask"], adj=A,
                         jit=True, device="cpu",
                         config=SolverConfig(qp_iters=20, qp_solver="nope"))
    with pytest.raises(ValueError, match="unknown QP engine"):
        sess.run(2)
    cfg = dict(qp_iters=40, qp_solver="pallas_fused")
    a, ja = _pair(data, A, cfg)
    b, _ = _pair(data, A, cfg, jit=True)
    a.run(4)
    b.run(4)
    ja.run(4)
    torch.testing.assert_close(a.state.r, b.state.r, atol=1e-5, rtol=1e-5)
    _assert_near_reference(b.state, ja.state, "jit=True pallas_fused")


def test_session_incremental_replan_bitwise_vs_fresh_stages():
    """A session driven through membership events (incremental replan)
    equals per-stage from-scratch compiles bitwise."""
    V, T = 6, 3
    data = jsynthetic.make_multitask_data(V=V, T=T, p=10,
                                          n_train=np.full((V, T), 10, int),
                                          n_test=100, seed=2)
    A = jgraph.make_graph("random", V, degree=0.7, seed=0)
    cfg = dict(C=0.01, eps2=100.0, qp_iters=40)
    sess, jsess = _pair(data, A, cfg)
    pcfg = SolverConfig(**cfg)
    schedule = [lambda s: s.drop_task(1), lambda s: s.set_coupling(True),
                lambda s: s.add_task(1, nodes=[0, 1, 2])]
    state = None
    for i in range(len(schedule) + 1):
        if i:
            for s in (sess, jsess):
                schedule[i - 1](s)
        for s in (sess, jsess):
            s.run(6)
        prob = core.make_problem(data["X"], data["y"], data["mask"], A,
                                 C=0.01, eps2=100.0, active=sess.active,
                                 couple=sess.couple, device="cpu")
        state, _ = engine_plan.compile_problem(prob, pcfg).run(state=state,
                                                               iters=6)
    _assert_equal(sess.state, state)
    stats = sess.plan_stats
    assert stats == jsess.plan_stats
    assert stats["replans"] == 3
    assert stats["gram_slices_reused"] > 0
    _assert_near_reference(sess.state, jsess.state, "incremental replan")


def test_session_threads_qp_modes_through_plan_path():
    """A non-default QP mode takes the plan path with jit=True too, so
    both flavors land on the same factored classifier, bitwise."""
    data, A = _make(V=4, T=2, n=6)
    cfg = dict(qp_iters=40, qp_solver="pallas_fused_multi",
               qp_operator="factored")
    a, ja = _pair(data, A, cfg)
    b, _ = _pair(data, A, cfg, jit=True)
    for s in (a, b, ja):
        s.run(4)
    _assert_equal(a.state, b.state)
    _assert_near_reference(a.state, ja.state, "factored")


def test_event_after_a_run_leaves_the_plan_that_ran_alone():
    """The masks reach a plan as copies: an event after a run on the CPU
    (where a tensor made from a float32 numpy array aliases it) leaves
    that plan's masks, and the log's record of them, as they ran; the
    next run re-plans with the change.  A caller's own arrays are
    copied too."""
    from repro_torch.store import EventLog
    V, T = 6, 3
    data, A = _online_fixture(V, T)
    active, couple = np.ones((V, T), np.float32), np.ones(V, np.float32)
    log = EventLog()
    sess = OnlineSession(data["X"], data["y"], mask=data["mask"], adj=A,
                         active=active, couple=couple, log=log,
                         config=SolverConfig(qp_iters=10), device="cpu")
    active[:, 1] = 0.0                       # the caller's array, not ours
    couple[:] = 0.0
    sess.run(2)
    ran = sess._plan
    want_active, want_couple = ran.prob.active.clone(), ran.prob.couple.clone()
    assert float(want_active.min()) == 1.0 and float(want_couple.min()) == 1.0
    sess.drop_task(0)
    sess.set_coupling(0.0, nodes=[1])
    assert torch.equal(ran.prob.active, want_active)
    assert torch.equal(ran.prob.couple, want_couple)
    np.testing.assert_array_equal(log.records[0]["active"], np.ones((V, T)))
    assert float(sess.problem().active[:, 0].max()) == 0.0
    sess.run(2)
    assert sess._plan is not ran
    assert torch.equal(sess._plan.prob.active, torch.from_numpy(sess.active))
    assert torch.equal(sess._plan.prob.couple, torch.from_numpy(sess.couple))
    assert torch.equal(ran.prob.active, want_active)


def test_session_node_events_and_status_are_the_references():
    """Node membership is a fabric feature: a vmap session refuses every
    node event with the reference's ValueError, and reports all nodes
    alive with no events."""
    data, A = _make(V=4, T=2, n=6)
    sess, jsess = _pair(data, A, {})
    for s in (sess, jsess):
        for event in ("node_enter", "node_leave", "node_crash",
                      "node_recover"):
            with pytest.raises(ValueError, match="fabric feature"):
                getattr(s, event)(1)
    assert sess.net_report_ is None is jsess.net_report_
    st, jst = sess.node_status, jsess.node_status
    np.testing.assert_array_equal(st["alive"], np.asarray(jst["alive"]))
    assert st["events"] == jst["events"] == []


@pytest.mark.parametrize("jit", [False, True])
def test_session_collects_telemetry(jit):
    """``telemetry=True`` (ROADMAP.md item 5, observability, done) runs a
    session, ``jit=True`` too, with the reference session's stream keys,
    shapes and float32 accumulated across a task event, and the state
    bitwise the telemetry-off session's."""
    assert "observability" in _roadmap_modules()[5].lower()
    data, A = _make(V=4, T=2, n=6)
    sess, jsess = _pair(data, A, dict(qp_iters=20, telemetry=True), jit=jit)
    off, _ = _pair(data, A, dict(qp_iters=20), jit=jit)
    for s in (sess, jsess, off):
        s.run(3)
        s.drop_task(1, nodes=[0])
        s.run(2)
    _assert_equal(sess.state, off.state)
    assert off.telemetry_ is None
    assert {k: (v.shape, v.dtype) for k, v in sess.telemetry_.items()} == \
        {k: (v.shape, v.dtype) for k, v in jsess.telemetry_.items()}
    assert sess.telemetry_["dual_residual"].shape == (5,)


@pytest.mark.parametrize("field", [dict(net=NetConfig()),
                                   dict(backend="async")])
def test_session_runs_the_fabric_configs(field):
    """``net`` and ``backend="async"`` (the fabric, ROADMAP.md item 2,
    done) run a session over an identity fabric: bitwise the vmap
    session through a task event, within REL of the JAX session, and
    metered as the reference meters it."""
    assert "fabric" in _roadmap_modules()[2].lower()
    data, A = _make(V=4, T=2, n=6)
    jfield = {k: (JNetConfig() if k == "net" else v)
              for k, v in field.items()}
    vmap, _ = _pair(data, A, dict(qp_iters=20))
    sess = OnlineSession(data["X"], data["y"], mask=data["mask"], adj=A,
                         device="cpu",
                         config=SolverConfig(qp_iters=20, **field))
    jsess = JOnlineSession(data["X"], data["y"], mask=data["mask"], adj=A,
                           config=JSolverConfig(qp_iters=20, **jfield))
    for s in (vmap, sess, jsess):
        s.run(3)
        s.drop_task(1)
        s.run(3)
    _assert_equal(sess.state, vmap.state)
    _assert_near_reference(sess.state, jsess.state, f"async session {field}")
    for k, v in jsess.net_report_.items():
        if k != "bytes_round_series":
            assert sess.net_report_[k] == v, k


def test_churn_variant_is_the_golden_runner():
    """``golden.outputs("fig7_churn")`` is ``churn_marks`` at the
    fixture's regime (the node-churn variant, no longer refused)."""
    assert "fabric" in _roadmap_modules()[2].lower()
    regime = dict(stage_iters=4, seed=0, n_test=300, qp_iters=40)
    marks, info = fig7_online.churn_marks(4, n_test=300, qp_iters=40,
                                          device="cpu")
    got = golden.outputs("fig7_churn", regime, device="cpu")
    assert set(got) == set(marks) == {n for n, _, _ in fig7_online.STAGES}
    for k in marks:
        np.testing.assert_array_equal(got[k], marks[k])
    assert info["session"].node_status["alive"].tolist() == \
        fig7_online.CHURN_ALIVE


def test_effective_backend_and_config_overrides_are_the_references():
    for kw in ({}, dict(backend="shard_map"), dict(net=object()),
               dict(net=object(), backend="async")):
        assert solvers.effective_backend(SolverConfig(**kw)) == \
            jsolvers.effective_backend(JSolverConfig(**kw))
    bad = dict(net=object(), backend="shard_map")
    for fn, cls in ((solvers.effective_backend, SolverConfig),
                    (jsolvers.effective_backend, JSolverConfig)):
        with pytest.raises(ValueError, match="async-backend feature"):
            fn(cls(**bad))
    cfg = solvers._as_solver_config(SolverConfig(C=0.5), dict(iters=3))
    assert cfg == SolverConfig(C=0.5, iters=3)
    assert solvers._as_solver_config(None, {}) == SolverConfig()
    data, A = _make(V=4, T=2, n=6)
    sess = OnlineSession(data["X"], data["y"], adj=A, device="cpu",
                         config=SolverConfig(C=0.5), qp_iters=7)
    assert sess.config == SolverConfig(C=0.5, qp_iters=7)


@pytest.mark.parametrize("qp_solver", ["fista", "pallas_fused_multi"])
def test_fig7_stage_marks_match_the_reference_runner(qp_solver):
    """``stage_marks`` at the golden regime against the JAX session driven
    through the same five stages (the reference's runner lives in
    benchmarks/), per engine: every mark within one test sample; the
    replay audit inside ``stage_marks`` held bitwise; both sessions made
    the same replans."""
    V, T = 6, 3
    marks, info = fig7_online.stage_marks(4, n_test=300, qp_iters=40,
                                          device="cpu", qp_solver=qp_solver)
    n_train = np.zeros((V, T), int)
    n_train[:, :2], n_train[:, 2] = 10, 40
    data = jsynthetic.make_multitask_data(
        V=V, T=T, p=10, n_train=n_train, n_test=300, relatedness=0.9,
        noise=1.0, seed=0)
    jsess = JOnlineSession(
        data["X"], data["y"], mask=data["mask"], adj=jgraph.full(V),
        config=JSolverConfig(C=0.01, eps1=1.0, eps2=100.0, qp_iters=40,
                             qp_solver=qp_solver),
        X_test=data["X_test"], y_test=data["y_test"],
        couple=np.zeros(V, np.float32))
    gap = 0.0
    for name, tasks, couple in fig7_online.STAGES:
        jsess.set_active(_act(V, T, tasks)).set_coupling(couple)
        want = np.asarray(jsess.run(4)).mean(1)[-1]
        gap = max(gap, float(np.abs(marks[name] - want).max()))
    print(f"fig7 {qp_solver} marks port vs JAX: largest gap {gap:.2e}")
    assert gap <= 1.0 / 300 + 1e-6
    assert info["plan_stats"] == info["replay_plan_stats"] == \
        jsess.plan_stats
    assert len(info["stage_s"]) == 5
    d = fig7_online.derived(marks)
    assert set(d) == {"t1_gain_in_stage2", "t2_gain_in_stage4", "t3_final"}
    assert d["t3_final"] == pytest.approx(float(marks["s5_t2_leaves"][2]))


def test_dtsvm_step_is_the_plan_step_and_the_reference_step():
    """The legacy oracle: iterated, bitwise a fresh plan's run with fista
    (both rebuild nothing differently); one step against the reference's
    ``dtsvm_step`` within REL."""
    data, A = _make(V=4, T=2, n=8)
    prob = core.make_problem(data["X"], data["y"], data["mask"], A, C=0.05,
                             eps2=10.0, device="cpu")
    st = core.init_state(prob)
    for _ in range(3):
        st = core.dtsvm_step(st, prob, qp_iters=30)
    want, _ = core.run_dtsvm(prob, 3, qp_iters=30)
    _assert_equal(st, want)
    jprob = jcore.make_problem(data["X"], data["y"], data["mask"], A,
                               C=0.05, eps2=10.0)
    jst = jcore.init_state(jprob)
    for _ in range(3):
        jst = jcore.dtsvm_step(jst, jprob, qp_iters=30)
    _assert_near_reference(st, jst, "dtsvm_step x3")
