"""The port's event log and ``replay`` (``repro_torch.store``) against the
reference's ``repro.store``.

Inside the port a replay is bitwise the live session (one torch thread),
as tests/test_store.py holds the reference's; a log the JAX session
recorded (``jnp`` arrays and the reference's config dict) replays into
the port within 1e-4 of each state leaf's largest magnitude of the live
JAX session (the gap observed is printed).  The configs are the
reference's in-process ones: dense and under a binding ``PlanBudget``.
"""
import numpy as np
import pytest
import torch

from repro.api.session import OnlineSession as JOnlineSession
from repro.api.solvers import SolverConfig as JSolverConfig
from repro.engine.invariants import PlanBudget as JPlanBudget
from repro.store import EventLog as JEventLog
from repro.store import events as jevents
from repro_torch.api import OnlineSession, PlanBudget, SolverConfig
from repro_torch.store import EVENTS, EventLog, replay
from test_torch_api import _roadmap_modules

V, T, N, P = 4, 2, 12, 3
REL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_plain_path(monkeypatch):
    monkeypatch.setenv("REPRO_USE_PALLAS", "0")


def _data(seed=0):
    """tests/test_store.py's data: a ring of 4 nodes, 12 samples of 3."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(V, T, N, P)).astype(np.float32)
    y = np.sign(rng.normal(size=(V, T, N))).astype(np.float32)
    adj = np.zeros((V, V), bool)
    for v in range(V):
        adj[v, (v + 1) % V] = adj[(v + 1) % V, v] = True
    Xte = rng.normal(size=(T, 16, P)).astype(np.float32)
    yte = np.sign(rng.normal(size=(T, 16))).astype(np.float32)
    return X, y, adj, Xte, yte


CONFIGS = {"vmap-dense": dict(iters=3, qp_iters=15),
           "vmap-budgeted": dict(iters=3, qp_iters=15, budget=256)}


def _config(name, jax_side=False):
    kw = dict(CONFIGS[name])
    if "budget" in kw:
        kw["budget"] = (JPlanBudget if jax_side else PlanBudget)(
            max_elems=kw["budget"])
    return (JSolverConfig if jax_side else SolverConfig)(**kw)


def _session(cfg, log=None, jax_side=False):
    X, y, adj, Xte, yte = _data()
    if jax_side:
        return JOnlineSession(X, y, adj=adj, config=cfg, log=log,
                              X_test=Xte, y_test=yte)
    return OnlineSession(X, y, adj=adj, config=cfg, log=log, X_test=Xte,
                         y_test=yte, device="cpu")


def _stage_schedule(sess):
    """The Fig.-7 shape: run, membership events, run, more events, run
    (tests/test_store.py's), then a bulk mask, a full couple mask and an
    unrecorded run."""
    sess.run(3)
    sess.drop_task(1)
    sess.set_coupling(0.0, nodes=[2])
    sess.run(3)
    sess.add_task(1, nodes=[0, 1])
    sess.run(2)
    sess.set_active(np.ones((V, T), np.float32))
    sess.set_coupling(np.array([1, 0, 1, 0], np.float32))
    sess.run(2, record=False)
    return sess


def _assert_sessions_equal(a, b):
    """Bitwise: state, counters, histories, masks and plan counters."""
    for name, x, z in zip(a.state._fields, a.state, b.state):
        assert torch.equal(x, z), name
    assert a.iteration == b.iteration
    assert len(a.history) == len(b.history)
    for ha, hb in zip(a.history, b.history):
        assert torch.equal(torch.from_numpy(ha), torch.from_numpy(hb))
    np.testing.assert_array_equal(a.active, b.active)
    np.testing.assert_array_equal(a.couple, b.couple)
    assert a.plan_stats == b.plan_stats


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_replay_from_log_bitwise(name):
    log = EventLog()
    live = _stage_schedule(_session(_config(name), log=log))
    assert [r["event"] for r in log.records] == [
        "init", "run", "drop_task", "set_coupling", "run", "add_task",
        "run", "set_active", "set_coupling", "run"]
    twin = replay(log, device="cpu")
    _assert_sessions_equal(twin, live)
    # the log is numpy and independent of the live session
    init = log.records[0]
    for key in ("X", "y", "mask", "adj", "active", "couple", "X_test",
                "y_test"):
        assert isinstance(init[key], np.ndarray), key
    assert init["config"] == live.config.to_dict()


def test_replay_prefix_time_travel():
    """``upto`` replays any prefix of the history: the state equals a
    session that only lived that prefix."""
    cfg = _config("vmap-dense")
    log = EventLog()
    sess = _session(cfg, log=log)
    sess.run(3)
    n_prefix = len(log)                      # init + run
    sess.drop_task(1)
    sess.run(2)
    short = _session(cfg)
    short.run(3)
    _assert_sessions_equal(replay(log, upto=n_prefix, device="cpu"), short)


def test_replay_requires_init_and_known_events():
    log = EventLog()
    log.append("run", iters=3, record=True)
    with pytest.raises(ValueError, match="init"):
        replay(log, device="cpu")
    with pytest.raises(ValueError, match="unknown event"):
        EventLog().append("fit")
    log = EventLog()
    _session(_config("vmap-dense"), log=log)
    log.records.append({"event": "fit"})
    with pytest.raises(ValueError, match="cannot replay"):
        replay(log, device="cpu")
    assert EVENTS == jevents.EVENTS


@pytest.mark.parametrize("event", ["node_enter", "node_leave", "node_crash",
                                   "node_recover"])
def test_node_records_replay_into_the_live_refusal(event):
    """A node record replays into the ValueError a live vmap session
    gives (node membership is a fabric feature)."""
    log = EventLog()
    _session(_config("vmap-dense"), log=log).run(1)
    log.append(event, node=1)
    with pytest.raises(ValueError, match="fabric feature"):
        replay(log, device="cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_log_replays_into_the_port(name):
    """A log the JAX session wrote (``jnp`` arrays, the reference's
    config dict) replays into the port within REL of the live JAX
    session; its risk history within one test sample of 16."""
    jlog = JEventLog()
    jlive = _stage_schedule(_session(_config(name, jax_side=True),
                                     log=jlog, jax_side=True))
    twin = replay(jlog, device="cpu")
    assert twin.config == _config(name)
    assert twin.iteration == jlive.iteration
    assert twin.plan_stats == jlive.plan_stats
    gaps = {}
    for field, got, want in zip(twin.state._fields, twin.state,
                                jlive.state):
        want = np.asarray(want, np.float64)
        err = float(np.abs(got.numpy() - want).max())
        gaps[field] = err / float(np.abs(want).max())
        assert err <= REL * float(np.abs(want).max()), (field, err)
    risk_gap = max(float(np.abs(h - np.asarray(j)).max())
                   for h, j in zip(twin.history, jlive.history))
    print(f"{name}: reference log replayed in the port, relative gap per "
          f"leaf {gaps}, risk gap {risk_gap:.2e}")
    assert len(twin.history) == len(jlive.history)
    assert risk_gap <= 1.0 / 16 + 1e-6


@pytest.mark.parametrize("kw", [
    {}, dict(C=0.1, iters=7, qp_iters=9, qp_solver="pallas_fused_multi",
             qp_precision="bf16", box_scale=3.0,
             backend_options={"topology": "ring"}),
    dict(qp_solver="pallas_fused_multi", qp_operator="factored"),
    dict(eps2=100.0, budget="max_elems"), dict(budget="tile"),
])
def test_config_dicts_of_the_reference_load_into_the_port(kw):
    """``replay`` of a reference log rebuilds its config with
    ``SolverConfig.from_dict`` of the reference's ``to_dict``."""
    kw = dict(kw)
    budget = kw.pop("budget", None)
    jkw, pkw = dict(kw), dict(kw)
    if budget == "max_elems":
        jkw["budget"], pkw["budget"] = (JPlanBudget(max_elems=4096),
                                        PlanBudget(max_elems=4096))
    elif budget == "tile":
        jkw["budget"], pkw["budget"] = (JPlanBudget(tile=(8, 128)),
                                        PlanBudget(tile=(8, 128)))
    d = JSolverConfig(**jkw).to_dict()
    cfg = SolverConfig.from_dict(d)
    assert cfg == SolverConfig(**pkw)
    assert cfg.to_dict() == d


@pytest.mark.parametrize("call", ["save", "load"])
def test_save_and_load_refusal_names_the_store_item(call):
    assert "store" in _roadmap_modules()[3].lower()
    with pytest.raises(NotImplementedError, match=r"item 3\b"):
        if call == "save":
            EventLog().save("run.events")
        else:
            EventLog.load("run.events")
