"""The port's observability (``repro_torch.obs``) against the reference's
``repro.obs`` (tests/test_obs.py), at tests/test_obs.py's size.

Both packages get the same numpy inputs.  Across the packages the
collector's leaves agree within 3e-5 of each stream's largest magnitude
on identical (prob, hi, new, prev) (``qp_active_frac`` exactly), and a
whole fit's streams within rtol 1e-4 / atol 1e-6 (``qp_active_frac``
within one valid coordinate, 1/sum(mask); the fabric's ``bytes_round``,
``staleness`` and ``nodes_alive`` exactly).  Inside the port
telemetry-on is bitwise telemetry-off (one torch thread).  Snapshots,
event logs and registry files carry the streams across the packages in
both directions.
"""
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro import api as japi
from repro import store as jstore
from repro.api.solvers import SolverConfig as JSolverConfig
from repro.core import dtsvm as jcore
from repro.core import graph as jgraph
from repro.data import synthetic
from repro.engine import invariants as jinv
from repro.net import Membership as JMembership
from repro.net import MembershipEvent as JMembershipEvent
from repro.net import NetConfig as JNetConfig
from repro.net import LinkPolicy as JLinkPolicy
from repro.net import run_async as jrun_async
from repro.obs import __main__ as jobs_main
from repro.obs import telemetry as jtelemetry
from repro_torch import obs
from repro_torch.api import (CSVM, DSVM, DTSVM, LinkPolicy, Membership,
                             MembershipEvent, NetConfig, OnlineSession,
                             PlanBudget, SolverConfig)
from repro_torch.core import dtsvm as core
from repro_torch.engine import compile_problem
from repro_torch.engine import invariants as inv_lib
from repro_torch.net import run_async
from repro_torch.obs import __main__ as obs_main
from repro_torch.obs import telemetry as telemetry_lib
from repro_torch.store import (EventLog, load_session, replay,
                               restore_session, save_session,
                               snapshot_session)

V, T, N, P = 3, 2, 12, 6
LEAF_REL = 3e-5
RTOL, ATOL = 1e-4, 1e-6
#: fabric streams that count events: equal exactly across the packages
EXACT = ("bytes_round", "staleness", "nodes_alive")
_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

#: tests/test_obs.py's engine matrix for the vmap backend
ENGINES = {
    "fista": dict(qp_solver="fista"),
    "pg": dict(qp_solver="pg"),
    "pallas_fused": dict(qp_solver="pallas_fused"),
    "pallas_fused_multi": dict(qp_solver="pallas_fused_multi"),
    "factored": dict(qp_solver="pallas_fused_multi",
                     qp_operator="factored"),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_plain_path(monkeypatch):
    monkeypatch.setenv("REPRO_USE_PALLAS", "0")


def _data():
    data = synthetic.make_multitask_data(
        V=V, T=T, p=P, n_train=np.full((V, T), N, int), n_test=8,
        relatedness=0.9, seed=0)
    adj = jgraph.make_graph("ring", V, seed=0)
    return data["X"], data["y"], data["mask"], adj


def _bitwise(a, b):
    return all(torch.equal(x, z) for x, z in zip(a, b))


def _assert_streams_close(got, want, mask_total, label=""):
    """A fit's streams against the reference's: the same keys, shapes and
    float32; values within RTOL/ATOL, ``qp_active_frac`` within one valid
    coordinate, the fabric's counting streams exactly."""
    assert set(got) == set(want), label
    for k, w in want.items():
        g, w = got[k], np.asarray(w)
        assert g.dtype == np.float32 and g.shape == w.shape, (label, k)
        if k in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {k}")
        elif k == "qp_active_frac":
            assert np.abs(g - w).max(initial=0.0) <= 1.0 / mask_total + 1e-7
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{label} {k}")


# ---------------------------------------------------------------------------
# the collector, leaf by leaf
# ---------------------------------------------------------------------------
def _random_state(rng, p, hi):
    """A state with every leaf random and lam pinned to the box faces at
    a third of the coordinates each."""
    shapes = dict(r=(V, T, 2 * p + 2), alpha=(V, T, p + 1),
                  beta=(V, T, 2 * p + 2))
    st = {k: rng.normal(size=s).astype(np.float32)
          for k, s in shapes.items()}
    lam = (rng.uniform(size=hi.shape) * hi).astype(np.float32)
    face = rng.integers(0, 3, size=hi.shape)
    st["lam"] = np.where(face == 0, 0.0,
                         np.where(face == 1, hi, lam)).astype(np.float32)
    return st


@pytest.mark.parametrize("case", ["all_active", "task_out", "lone_node"])
def test_collect_diagnostics_leaf_parity(case):
    """On identical (prob, hi, new, prev) every stream is within LEAF_REL
    of its largest magnitude, and the box-face fraction exactly equal."""
    X, y, mask, adj = _data()
    active = np.ones((V, T), np.float32)
    if case == "task_out":
        active[1, 0] = active[2, 1] = 0.0
    if case == "lone_node":
        adj = adj.copy()
        adj[0, :] = adj[:, 0] = False
    prob = core.make_problem(X, y, mask, adj, active=active, device="cpu")
    jprob = jcore.make_problem(X, y, mask, adj, active=active)
    hi = inv_lib._masks_part(prob)[4].numpy()
    rng = np.random.default_rng(7)
    new, prev = _random_state(rng, P, hi), _random_state(rng, P, hi)
    tstate = lambda s: core.DTSVMState(**{  # noqa: E731
        k: torch.from_numpy(v) for k, v in s.items()})
    got = obs.collect_diagnostics(prob, torch.from_numpy(hi), tstate(new),
                                  tstate(prev))
    want = jtelemetry.collect_diagnostics(jprob, hi, jcore.DTSVMState(**new),
                                          jcore.DTSVMState(**prev))
    assert set(got) == set(obs.STREAMS) == set(want)
    assert 0.0 < float(got["qp_active_frac"]) < 1.0
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.dtype == np.float32 and g.shape == w.shape, k
        if k == "qp_active_frac":
            assert g == w
        else:
            assert np.abs(g - w).max() <= LEAF_REL * np.abs(w).max(), k
    # the loop's once-per-run terms give the per-call result bitwise
    terms = telemetry_lib.problem_terms(prob)
    again = obs.Telemetry().collect(prob, torch.from_numpy(hi), tstate(new),
                                    tstate(prev), terms=terms)
    assert all(torch.equal(got[k], again[k]) for k in got)


# ---------------------------------------------------------------------------
# telemetry-on is bitwise telemetry-off; the streams are the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(ENGINES))
def test_telemetry_bitwise_invisible_vmap(name):
    X, y, mask, adj = _data()
    kw = dict(iters=4, qp_iters=8, **ENGINES[name])
    off = DTSVM(SolverConfig(**kw), device="cpu").fit(X, y, mask, adj)
    on = DTSVM(SolverConfig(telemetry=True, **kw), device="cpu").fit(
        X, y, mask, adj)
    assert _bitwise(off.state_, on.state_)
    assert off.telemetry_ is None
    assert set(on.telemetry_) == set(obs.STREAMS)


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_fit_streams_match_the_reference(name):
    X, y, mask, adj = _data()
    kw = dict(iters=6, qp_iters=10, telemetry=True, **ENGINES[name])
    got = DTSVM(SolverConfig(**kw), device="cpu").fit(X, y, mask, adj)
    want = japi.DTSVM(JSolverConfig(**kw)).fit(X, y, mask, adj)
    _assert_streams_close(got.telemetry_, want.telemetry_, mask.sum(), name)


def test_telemetry_bitwise_invisible_async():
    X, y, mask, adj = _data()
    kw = dict(iters=4, qp_iters=8, backend="async")
    off = OnlineSession(X, y, mask, adj, device="cpu",
                        config=SolverConfig(net=NetConfig(), **kw))
    on = OnlineSession(X, y, mask, adj, device="cpu",
                       config=SolverConfig(net=NetConfig(), telemetry=True,
                                           **kw))
    off.run(4)
    on.run(4)
    assert _bitwise(off.state, on.state)
    assert set(on.telemetry_) == set(obs.STREAMS) | {"bytes_round",
                                                     "staleness"}
    assert on.telemetry_["staleness"].shape == (4, V)
    np.testing.assert_array_equal(on.telemetry_["bytes_round"],
                                  np.asarray(on._net_series, np.float32))
    jon = japi.OnlineSession(X, y, mask, adj, config=JSolverConfig(
        net=JNetConfig(), telemetry=True, **kw))
    jon.run(4)
    _assert_streams_close(on.telemetry_, jon.telemetry_, mask.sum(), "async")


def _net_case(name, jax_side=False):
    """(NetConfig, Membership or None) of a run_async case."""
    L, Nc = ((JLinkPolicy, JNetConfig) if jax_side
             else (LinkPolicy, NetConfig))
    M, E = ((JMembership, JMembershipEvent) if jax_side
            else (Membership, MembershipEvent))
    if name == "identity":
        return Nc(), None
    if name == "lossy":
        return Nc(policy=L(drop=0.25, delay=1, quant="int16"),
                  schedule="partial:0.75", seed=3), None
    return (Nc(policy=L(drop=0.2, quant="int8"), schedule="partial:0.75",
               seed=3, stale_limit=2, error_feedback=True),
            M(events=(E(round=2, kind="crash", node=1),
                      E(round=4, kind="recover", node=1),
                      E(round=5, kind="leave", node=2))))


@pytest.mark.parametrize("name", ["identity", "lossy", "churn"])
def test_run_async_streams(name):
    """``run_async(telemetry=)``: bitwise the telemetry-off run in the
    port; the streams, the fabric's three among them, the reference's."""
    X, y, mask, adj = _data()
    prob = core.make_problem(X, y, mask, adj, device="cpu")
    jprob = jcore.make_problem(X, y, mask, adj)
    net, mem = _net_case(name)
    off = run_async(prob, 7, net=net, qp_iters=10, membership=mem)
    on = run_async(prob, 7, net=net, qp_iters=10, membership=mem,
                   telemetry=obs.Telemetry())
    assert off.telemetry is None
    assert _bitwise(off.state, on.state)
    assert _bitwise(off.fabric_state, on.fabric_state)
    jnet, jmem = _net_case(name, jax_side=True)
    want = jrun_async(jprob, 7, net=jnet, qp_iters=10, membership=jmem,
                      telemetry=jtelemetry.Telemetry())
    assert ("nodes_alive" in on.telemetry) == (mem is not None)
    _assert_streams_close(on.telemetry, want.telemetry, mask.sum(), name)
    if mem is not None:
        assert on.telemetry["nodes_alive"].tolist() == \
            [3, 3, 2, 2, 3, 2, 2]


@pytest.mark.parametrize("solver", [DTSVM, DSVM])
def test_async_backend_fit_sets_telemetry(solver):
    X, y, mask, adj = _data()
    s = solver(SolverConfig(iters=3, qp_iters=6, backend="async",
                            telemetry=True), device="cpu").fit(
        X, y, mask, adj)
    assert set(s.telemetry_) == set(obs.STREAMS) | {"bytes_round",
                                                    "staleness"}
    assert all(v.shape[0] == 3 and v.dtype == np.float32
               for v in s.telemetry_.values())


def test_stream_subset_selection():
    X, y, mask, adj = _data()
    tel = obs.Telemetry(streams=("dual_residual",))
    assert tel.streams == ("dual_residual",)
    assert repr(tel) == repr(jtelemetry.Telemetry(streams=("dual_residual",)))
    # a custom spec rides through backend_options; config.telemetry
    # still gates collection (setdefault keeps the explicit spec)
    s = DTSVM(SolverConfig(iters=3, qp_iters=4, telemetry=True,
                           backend_options={"telemetry": tel}),
              device="cpu")
    s.fit(X, y, mask, adj)
    assert set(s.telemetry_) == {"dual_residual"}
    with pytest.raises(ValueError, match="unknown telemetry streams"):
        obs.Telemetry(streams=("nope",))
    # the catalog's order, whatever order was asked
    assert obs.Telemetry(streams=("qp_active_frac", "primal_residual")
                         ).streams == ("primal_residual", "qp_active_frac")


def test_zero_iterations_give_empty_streams():
    X, y, mask, adj = _data()
    plan = compile_problem(core.make_problem(X, y, mask, adj, device="cpu"),
                           qp_iters=4)
    st, hist, streams = plan.run(iters=0, telemetry=obs.Telemetry())
    host = obs.materialize(streams)
    assert {k: v.shape for k, v in host.items()} == {
        "primal_residual": (0,), "dual_residual": (0,),
        "disagreement": (0, T), "qp_active_frac": (0,)}


def test_concat_streams_tolerates_missing_keys():
    a = {"x": np.ones((2,), np.float32)}
    b = {"x": np.zeros((3,), np.float32),
         "bytes_round": np.ones((3,), np.float32)}
    out = obs.concat_streams(a, b)
    assert out["x"].shape == (5,)
    assert out["bytes_round"].shape == (3,)
    assert obs.concat_streams(None, b)["x"].shape == (3,)
    assert jtelemetry.concat_streams(a, b).keys() == out.keys()


def test_summarize_is_the_references():
    rng = np.random.default_rng(0)
    streams = {"a": rng.normal(size=5).astype(np.float32),
               "b": rng.normal(size=(5, 2)).astype(np.float32),
               "empty": np.zeros((0,), np.float32)}
    assert obs.summarize(streams) == jobs.summarize(streams)


def test_csvm_rejects_telemetry():
    X, y, mask, adj = _data()
    with pytest.raises(ValueError, match="single-shot"):
        CSVM(telemetry=True).fit(X, y, mask, adj, device="cpu")


def test_config_roundtrip_and_old_dicts_default_off():
    cfg = SolverConfig(iters=3, telemetry=True)
    d = cfg.to_dict()
    assert d["telemetry"] is True
    assert d == JSolverConfig(iters=3, telemetry=True).to_dict()
    assert SolverConfig.from_dict(d).telemetry is True
    d.pop("telemetry")          # a pre-obs config dict
    assert SolverConfig.from_dict(d).telemetry is False


def test_stream_shapes_dtypes_and_convergence():
    """The twin of the reference's convergence test: over a 30-iteration
    fit the residuals and the disagreement fall, the primal residual
    toward 0."""
    X, y, mask, adj = _data()
    t = DTSVM(iters=30, qp_iters=40, telemetry=True, device="cpu").fit(
        X, y, mask, adj).telemetry_
    assert t["primal_residual"].shape == (30,)
    assert t["dual_residual"].shape == (30,)
    assert t["disagreement"].shape == (30, T)
    assert t["qp_active_frac"].shape == (30,)
    for v in t.values():
        assert v.dtype == np.float32 and np.isfinite(v).all()
    assert np.all((t["qp_active_frac"] >= 0) & (t["qp_active_frac"] <= 1))
    assert t["dual_residual"][-1] < t["dual_residual"][0]
    assert t["disagreement"].max(1)[-1] < t["disagreement"].max(1)[0]
    primal = t["primal_residual"]
    assert primal[-1] < 0.25 * primal[0]
    assert primal[-5:].max() < primal[:5].min()


# ---------------------------------------------------------------------------
# sessions: accumulation, save -> restore -> continue, replay
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("jit", [False, True])
def test_session_accumulates_streams_across_stages(jit):
    """Across stages and a membership event; ``jit=True`` must not drop
    the streams (telemetry takes the plan path).  Against the
    reference's session."""
    X, y, mask, adj = _data()
    kw = dict(iters=4, qp_iters=8, telemetry=True)
    sess = OnlineSession(X, y, mask, adj, config=SolverConfig(**kw),
                         jit=jit, device="cpu")
    jsess = japi.OnlineSession(X, y, mask, adj,
                               config=JSolverConfig(**kw), jit=jit)
    for s in (sess, jsess):
        s.run(4)
    assert sess.telemetry_["dual_residual"].shape == (4,)
    for s in (sess, jsess):
        s.drop_task(1, nodes=[0])
        s.run(3)
    assert sess.telemetry_["dual_residual"].shape == (7,)
    assert sess.telemetry_["disagreement"].shape == (7, T)
    _assert_streams_close(sess.telemetry_, jsess.telemetry_, mask.sum(),
                          f"jit={jit}")


def _session_pair(net, log=None):
    X, y, mask, adj = _data()
    kw = dict(iters=4, qp_iters=8, telemetry=True)
    if net:
        kw.update(backend="async", net=NetConfig())
    return OnlineSession(X, y, mask, adj, config=SolverConfig(**kw),
                         log=log, device="cpu")


@pytest.mark.parametrize("net", [False, True], ids=["vmap", "async"])
def test_save_restore_continue_carries_telemetry(tmp_path, net):
    sess = _session_pair(net)
    sess.run(4)
    path = os.path.join(str(tmp_path), "s.msgpack")
    save_session(path, sess)
    back = load_session(path, device="cpu")
    for k in sess.telemetry_:
        np.testing.assert_array_equal(back.telemetry_[k], sess.telemetry_[k])
        assert back.telemetry_[k].dtype == np.float32
    back.run(3)
    sess.run(3)
    assert _bitwise(back.state, sess.state)
    for k in sess.telemetry_:
        np.testing.assert_array_equal(back.telemetry_[k], sess.telemetry_[k])
        assert back.telemetry_[k].shape[0] == 7


def test_reference_snapshot_carries_telemetry_into_the_port(tmp_path):
    X, y, mask, adj = _data()
    cfg = dict(iters=4, qp_iters=8, backend="async", telemetry=True)
    jsess = japi.OnlineSession(X, y, mask, adj, config=JSolverConfig(
        net=JNetConfig(), **cfg))
    jsess.run(4)
    path = os.path.join(str(tmp_path), "ref.msgpack")
    jstore.save_session(path, jsess)
    back = load_session(path, device="cpu", check_fingerprint=False)
    assert set(back.telemetry_) == set(jsess.telemetry_)
    for k, v in jsess.telemetry_.items():
        np.testing.assert_array_equal(back.telemetry_[k], v)
        assert back.telemetry_[k].dtype == np.float32
    back.run(3)
    jsess.run(3)
    _assert_streams_close(back.telemetry_, jsess.telemetry_, mask.sum(),
                          "reference snapshot")


def test_port_snapshot_carries_telemetry_into_the_reference(tmp_path):
    sess = _session_pair(net=True)
    sess.run(4)
    path = os.path.join(str(tmp_path), "port.msgpack")
    save_session(path, sess)
    back = jstore.load_session(path, check_fingerprint=False)
    assert set(back.telemetry_) == set(sess.telemetry_)
    for k, v in sess.telemetry_.items():
        np.testing.assert_array_equal(back.telemetry_[k], v)
    back.run(3)
    sess.run(3)
    _assert_streams_close(sess.telemetry_, back.telemetry_,
                          _data()[2].sum(), "port snapshot")


def test_v1_snapshot_without_obs_block_migrates():
    """A pre-obs (v1) snapshot loads: the migration defaults the obs
    block to None and the session restores with no telemetry."""
    from repro_torch.store import schema

    X, y, mask, adj = _data()
    sess = OnlineSession(X, y, mask, adj, device="cpu",
                         config=SolverConfig(iters=3, qp_iters=8))
    sess.run(3)
    tree = snapshot_session(sess)
    assert tree["schema_version"] == schema.SCHEMA_VERSION >= 2
    assert tree["obs"] is None
    tree.pop("obs")                        # what a v1 writer produced
    tree.pop("membership", None)           # (v3 field, absent in v1 too)
    tree["schema_version"] = 1
    back = restore_session(tree, device="cpu")
    assert back.telemetry_ is None
    assert _bitwise(back.state, sess.state)


def test_replay_reproduces_telemetry():
    log = EventLog()
    sess = _session_pair(net=False, log=log)
    sess.run(4)
    sess.drop_task(0, nodes=[2])
    sess.run(2)
    twin = replay(log, device="cpu")
    assert _bitwise(twin.state, sess.state)
    assert set(twin.telemetry_) == set(sess.telemetry_)
    for k in sess.telemetry_:
        np.testing.assert_array_equal(twin.telemetry_[k], sess.telemetry_[k])


def test_reference_log_replays_telemetry_into_the_port():
    X, y, mask, adj = _data()
    jlog = jstore.EventLog()
    jsess = japi.OnlineSession(X, y, mask, adj, log=jlog, config=JSolverConfig(
        iters=4, qp_iters=8, telemetry=True))
    jsess.run(4)
    jsess.drop_task(0, nodes=[2])
    jsess.run(2)
    log = EventLog()
    log.records = [dict(r) for r in jlog.records]
    twin = replay(log, device="cpu")
    _assert_streams_close(twin.telemetry_, jsess.telemetry_, mask.sum(),
                          "reference log")


# ---------------------------------------------------------------------------
# spans + Chrome trace export
# ---------------------------------------------------------------------------
def test_spans_cover_phase_boundaries():
    obs.clear_spans()
    X, y, mask, adj = _data()
    with obs.span("fit", tag="test"):
        DTSVM(iters=2, qp_iters=4, device="cpu").fit(X, y, mask, adj)
    names = [e["name"] for e in obs.iter_spans()]
    for expected in ("invariant_build", "plan_compile", "scan_execute",
                     "fit"):
        assert expected in names, names
    # nesting: the wrapping span closes last, so it is recorded last
    assert names[-1] == "fit"
    ev = obs.iter_spans()[-1]
    assert ev["ph"] == "X" and ev["dur"] >= 0 and ev["args"] == {
        "tag": "test"}


def _span_args(events):
    return [(e["name"], e.get("args", {})) for e in events
            if e["name"] in ("invariant_build", "plan_compile",
                             "scan_execute", "plan_replan")]


@pytest.mark.parametrize("kw", [
    {}, dict(telemetry=True), dict(budget="panels"),
    dict(qp_solver="pallas_fused_multi", qp_operator="factored"),
], ids=["default", "telemetry", "budgeted", "factored"])
def test_engine_spans_are_the_references(kw):
    """The same fit records the same engine spans, in the same order, with
    the same args, in both packages."""
    X, y, mask, adj = _data()
    budget = kw.pop("budget", None)
    jkw = dict(kw)
    if budget:
        kw["budget"] = PlanBudget(max_elems=2 * N * V)
        jkw["budget"] = jinv.PlanBudget(max_elems=2 * N * V)
    obs.clear_spans()
    DTSVM(SolverConfig(iters=2, qp_iters=4, **kw), device="cpu").fit(
        X, y, mask, adj)
    jobs.clear_spans()
    japi.DTSVM(JSolverConfig(iters=2, qp_iters=4, **jkw)).fit(
        X, y, mask, adj)
    got, want = _span_args(obs.iter_spans()), _span_args(jobs.iter_spans())
    assert got == want
    assert [n for n, _ in got] == ["invariant_build", "plan_compile",
                                   "scan_execute"]


def test_replan_records_plan_replan():
    X, y, mask, adj = _data()
    sess = OnlineSession(X, y, mask, adj, device="cpu",
                         config=SolverConfig(iters=2, qp_iters=4))
    sess.run(2)
    obs.clear_spans()
    sess.drop_task(1, nodes=[0])
    sess.run(2)
    names = [e["name"] for e in obs.iter_spans()]
    assert names == ["plan_replan", "scan_execute"]


def test_chrome_trace_roundtrips_through_validation(tmp_path):
    obs.clear_spans()
    with obs.span("a", k=1):
        with obs.span("b"):
            pass
    path = os.path.join(str(tmp_path), "trace.json")
    tree = obs.save_trace(path)
    loaded = json.loads(open(path).read())
    obs.validate_chrome_trace(loaded)      # raises on malformed
    jobs.validate_chrome_trace(loaded)     # and the reference accepts it
    assert loaded["displayTimeUnit"] == "ms"
    assert [e["name"] for e in loaded["traceEvents"]] == ["b", "a"]
    assert loaded == json.loads(json.dumps(tree))


def test_trace_validation_rejects_malformed():
    with pytest.raises(ValueError):
        obs.validate_chrome_trace({"events": []})
    with pytest.raises(ValueError):
        obs.validate_chrome_trace(
            {"traceEvents": [{"name": "x", "ph": "B", "ts": 0,
                              "dur": 0, "pid": 1, "tid": 1}]})
    with pytest.raises(ValueError):
        obs.validate_chrome_trace(
            {"traceEvents": [{"name": "x", "ph": "X", "ts": -1.0,
                              "dur": 0, "pid": 1, "tid": 1}]})


def test_store_and_serve_phases_emit_spans(tmp_path):
    from repro_torch.serve import PredictModel, PredictServer

    obs.clear_spans()
    X, y, mask, adj = _data()
    sess = OnlineSession(X, y, mask, adj, device="cpu",
                         config=SolverConfig(iters=2, qp_iters=4))
    sess.run(2)
    path = os.path.join(str(tmp_path), "s.msgpack")
    save_session(path, sess)
    load_session(path, device="cpu")
    srv = PredictServer(PredictModel.from_r(sess.state.r), window_ms=0.0,
                        devices=["cpu"])
    try:
        srv.submit(np.ones((2, P), np.float32), node=0,
                   task=0).result(timeout=30)
    finally:
        srv.close()
    names = {e["name"] for e in obs.iter_spans()}
    assert {"store_snapshot", "store_restore", "serve_batch",
            "plan_compile"} <= names


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------
def test_registry_roundtrip_and_version_guard(tmp_path):
    reg = obs.MetricsRegistry()
    reg.record("custom", {"a": 1, "arr": np.arange(3, dtype=np.float32),
                          "t": torch.tensor(2.5), "n": torch.tensor(4)})
    d = reg.to_dict()
    assert d["kind"] == "metrics_registry"
    assert d["obs_schema_version"] == obs.OBS_SCHEMA_VERSION == \
        jobs.OBS_SCHEMA_VERSION
    assert json.loads(json.dumps(d)) == d       # plain JSON throughout
    path = os.path.join(str(tmp_path), "m.json")
    reg.save(path)
    back = obs.MetricsRegistry.load(path)
    assert back.get("custom") == {"a": 1, "arr": [0.0, 1.0, 2.0],
                                  "t": 2.5, "n": 4}
    with pytest.raises(ValueError, match="newer"):
        obs.MetricsRegistry.from_dict(
            dict(d, obs_schema_version=obs.OBS_SCHEMA_VERSION + 1))
    with pytest.raises(ValueError, match="kind"):
        obs.MetricsRegistry.from_dict(dict(d, kind="nope"))
    with pytest.raises(ValueError, match="obs_schema_version"):
        obs.MetricsRegistry.from_dict({"kind": "metrics_registry"})
    with pytest.raises(TypeError, match="no JSON form"):
        obs.MetricsRegistry().record("bad", {"t": torch.ones(3)})
    with pytest.raises(TypeError, match="no JSON form"):
        obs.MetricsRegistry().record("bad", object())


def _session_registry(jax_side):
    X, y, mask, adj = _data()
    kw = dict(iters=3, qp_iters=8, backend="async", telemetry=True)
    if jax_side:
        sess = japi.OnlineSession(X, y, mask, adj, config=JSolverConfig(
            net=JNetConfig(), **kw))
        sess.run(3)
        return jobs.MetricsRegistry.from_session(sess), sess
    sess = OnlineSession(X, y, mask, adj, device="cpu",
                         config=SolverConfig(net=NetConfig(), **kw))
    sess.run(3)
    return obs.MetricsRegistry.from_session(sess), sess


def test_registry_absorbs_session_sources():
    obs.clear_spans()
    reg, sess = _session_registry(jax_side=False)
    reg.record_spans()
    assert {"plan", "net", "telemetry", "spans"} <= set(reg.sections())
    assert reg.get("telemetry")["dual_residual"]["iters"] == 3
    assert reg.get("net")["msgs_sent"] == sess.net_report_["msgs_sent"]
    assert reg.get("spans")["plan_compile"]["count"] == 1
    rendered = reg.render()
    assert "dual_residual" in rendered and "[net]" in rendered
    jreg, jsess = _session_registry(jax_side=True)
    assert reg.sections() == sorted(jreg.sections() + ["spans"])
    assert reg.get("plan") == jreg.get("plan")
    assert set(reg.get("net")) == set(jreg.get("net"))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_registry_files_cross_between_the_packages(tmp_path, writer):
    """One package's file loads in the other and renders the same text;
    each package's ``report`` command prints it."""
    path = os.path.join(str(tmp_path), "m.json")
    reg, _ = _session_registry(jax_side=(writer == "reference"))
    reg.record("custom", {"x": 1.5, "flag": True, "series": list(range(9))})
    reg.save(path)
    mine = obs.MetricsRegistry.load(path)
    theirs = jobs.MetricsRegistry.load(path)
    assert mine.to_dict() == theirs.to_dict()
    assert mine.render() == theirs.render()
    for main in (obs_main.main, jobs_main.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(["report", path]) == 0
        assert buf.getvalue().strip() == mine.render()


# ---------------------------------------------------------------------------
# timing helper
# ---------------------------------------------------------------------------
def test_timeit_contract():
    calls = []

    def fn(a, b=1):
        calls.append((a, b))
        return a + b

    t = obs.timeit(fn, 2, b=3, repeats=4, warmup=2)
    assert isinstance(t, obs.Timing)
    assert t.result == 5
    assert len(calls) == 6                  # warmup + timed
    assert len(t.times_s) == 4
    assert t.best_s <= t.mean_s
    with pytest.raises(ValueError):
        obs.timeit(fn, 1, repeats=0)
    with pytest.raises(ValueError):
        obs.timeit(fn, 1, warmup=-1)
    assert obs.Timing._fields == jobs.Timing._fields


def test_timeit_waits_for_every_tensor_leaf(monkeypatch):
    """The blocking walk reaches tensors inside NamedTuples, tuples,
    lists and dicts and synchronizes each CUDA device once; CPU tensors
    and other leaves need no wait."""
    from repro_torch.obs import timing

    class Fake:
        def __init__(self, dev):
            self.is_cuda, self.device = True, dev

    found = timing._cuda_devices(
        core.DTSVMState(r=torch.ones(1), alpha=[torch.ones(1)],
                        beta={"x": (torch.ones(1), 3)}, lam="s"), set())
    assert found == set()
    synced = []
    # the helper's own view of torch: fake CUDA tensors and a recording
    # synchronize (torch itself is left alone)
    monkeypatch.setattr(timing, "torch", SimpleNamespace(
        Tensor=Fake, cuda=SimpleNamespace(synchronize=synced.append)))
    tree = {"a": (Fake("cuda:0"), [Fake("cuda:1")]),
            "b": core.DTSVMState(r=Fake("cuda:0"), alpha=1, beta=None,
                                 lam="x")}
    t = timing.timeit(lambda: tree, repeats=2, warmup=1)
    assert t.result is tree
    # one wait per device per call: one warmup and two timed calls
    assert sorted(synced) == ["cuda:0"] * 3 + ["cuda:1"] * 3


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_demo_and_report(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    trace = os.path.join(str(tmp_path), "trace.json")
    metrics = os.path.join(str(tmp_path), "metrics.json")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "demo", "--iters", "2",
         "--trace", trace, "--registry", metrics, "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    tree = json.loads(open(trace).read())
    obs.validate_chrome_trace(tree)
    names = {e["name"] for e in tree["traceEvents"]}
    assert {"invariant_build", "plan_compile", "scan_execute",
            "demo_fit"} <= names
    reg = obs.MetricsRegistry.load(metrics)
    assert {"telemetry", "spans"} <= set(reg.sections())
    assert reg.get("telemetry")["dual_residual"]["iters"] == 2
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "report", metrics],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dual_residual" in proc.stdout
    assert proc.stdout.strip() == jobs.MetricsRegistry.load(metrics).render()


def test_cli_demo_defaults_to_the_card(tmp_path, monkeypatch):
    """Without ``--device`` the demo runs on the card, and with none it
    raises before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trace = os.path.join(str(tmp_path), "trace.json")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        obs_main.main(["demo", "--iters", "1", "--trace", trace,
                       "--registry", os.path.join(str(tmp_path), "m.json")])
    assert not os.path.exists(trace)


def test_exports_are_the_references():
    assert obs.__all__ == jobs.__all__
    # the sample-sharded collector comes with the sample_shard backend
    assert "collect_shard_diagnostics" in dir(telemetry_lib)
