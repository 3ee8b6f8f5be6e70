"""The port's durable sessions (``repro_torch.store``: snapshots, the
step-indexed ``SessionStore``, the schema, event logs and their replay)
against the reference's ``repro.store`` (tests/test_store.py).

Inside the port, as the reference holds its own, save -> restore ->
continue and a replay are bitwise the uninterrupted session (one torch
thread), for the reference's five in-process configs (vmap dense and
budgeted; the async fabric identity, lossy, and with staleness and error
feedback), through disk.  Across the packages files go both ways: a
snapshot or a log that ``repro`` wrote loads into ``repro_torch`` and
continues within 1e-4 of each state leaf's largest magnitude of the JAX
run (the gap observed is printed), and the port's files load into
``repro``.  A snapshot crosses only with ``check_fingerprint=False``: the
fingerprint hashes each package's own K (the two differ in the last
bits), and without the flag the restore raises ``SchemaError``.  The
reference's slow shard_map case runs here too, on a world of CPU ranks;
its sample_shard case is in tests/test_torch_sample_shard.py.
"""
import os

import numpy as np
import pytest
import torch

from repro import checkpoint as jcheckpoint
from repro import store as jstore
from repro.api.session import OnlineSession as JOnlineSession
from repro.api.solvers import SolverConfig as JSolverConfig
from repro.engine.invariants import PlanBudget as JPlanBudget
from repro.net import LinkPolicy as JLinkPolicy
from repro.net import NetConfig as JNetConfig
from repro.store import EventLog as JEventLog
from repro.store import events as jevents
from repro_torch import checkpoint
from repro_torch.api import (LinkPolicy, NetConfig, OnlineSession,
                             PlanBudget, SolverConfig)
from repro_torch.store import (EVENTS, EventLog, SchemaError, SessionStore,
                               load_session, replay, restore_session,
                               save_session, snapshot_session)
from repro_torch.store import schema as schema_lib

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




# ---------------------------------------------------------------------------
# snapshots: save -> restore -> continue (tests/test_store.py's configs)
# ---------------------------------------------------------------------------
def _net(kind, jax_side=False):
    """tests/test_store.py's fabrics: lossy (drops, a delay, int16) and
    churn-ready (int8 with error feedback and bounded staleness)."""
    L, N = (JLinkPolicy, JNetConfig) if jax_side else (LinkPolicy, NetConfig)
    if kind == "identity":
        return N()
    if kind == "lossy":
        return N(policy=L(drop=0.25, delay=1, quant="int16"),
                 schedule="partial:0.75", seed=3)
    return N(policy=L(drop=0.2, quant="int8"), schedule="partial:0.75",
             seed=3, stale_limit=2, error_feedback=True)


STORE_CONFIGS = ("async-identity", "async-lossy", "async-stale-ef",
                 "vmap-budgeted", "vmap-dense")


def _store_config(name, jax_side=False):
    if name.startswith("vmap"):
        return _config(name, jax_side)
    return (JSolverConfig if jax_side else SolverConfig)(
        iters=3, qp_iters=15, net=_net(name.split("-", 1)[1], jax_side))


def _first_stage(sess):
    sess.run(3)
    return sess


def _pending_events(sess):
    sess.drop_task(1)
    sess.set_coupling(0.0, nodes=[2])
    return sess


def _rest(sess):
    """tests/test_store.py's schedule after its first stage."""
    sess.run(3)
    sess.add_task(1, nodes=[0, 1])
    sess.run(2)
    return sess


def _store_schedule(sess):
    return _rest(_pending_events(_first_stage(sess)))


def _assert_store_equal(a, b):
    """Bitwise: state, counters, histories, masks, and the whole fabric
    state and byte series (plan counters restart on a restore)."""
    for name, x, z in zip(a.state._fields, a.state, b.state):
        assert torch.equal(x, z), name
    assert a.iteration == b.iteration
    assert len(a.history) == len(b.history)
    for ha, hb in zip(a.history, b.history):
        assert torch.equal(torch.from_numpy(ha), torch.from_numpy(hb))
    np.testing.assert_array_equal(a.active, b.active)
    np.testing.assert_array_equal(a.couple, b.couple)
    assert (a._net_state is None) == (b._net_state is None)
    if a._net_state is not None:
        for name, x, z in zip(a._net_state._fields, a._net_state,
                              b._net_state):
            assert torch.equal(x, z), name
        assert np.array_equal(np.asarray(a._net_series),
                              np.asarray(b._net_series))
        assert a.net_report_ == b.net_report_


@pytest.mark.parametrize("pending", [False, True],
                         ids=["after-run", "pending-events"])
@pytest.mark.parametrize("name", STORE_CONFIGS)
def test_save_restore_continue_bitwise(tmp_path, name, pending):
    """Snapshot through disk after the first stage, then the rest of the
    schedule on the restored session: bitwise the uninterrupted run.
    ``pending`` saves between the membership events and the next run, so
    ``masks_dirty`` and the stale plan must round-trip."""
    cfg = _store_config(name)
    ref = _store_schedule(_session(cfg))
    twin = _first_stage(_session(cfg))
    if pending:
        _pending_events(twin)
    path = os.path.join(str(tmp_path), "sess.msgpack")
    save_session(path, twin)
    del twin
    back = load_session(path, device="cpu")
    assert back._masks_dirty == pending
    if not pending:
        _pending_events(back)
    _assert_store_equal(_rest(back), ref)


def test_save_restore_continue_shard_map_bitwise(tmp_path):
    """tests/test_store.py's shard_map case: each session runs its own
    world of 4 CPU ranks; the restored one starts a new world and
    continues bitwise the uninterrupted session."""
    X, y, adj, _, _ = _data()
    cfg = SolverConfig(iters=3, qp_iters=15, backend="shard_map",
                       backend_options={"topology": "graph"})
    sessions = []

    def session():
        sessions.append(OnlineSession(X, y, adj=adj, config=cfg,
                                      device="cpu"))
        return sessions[-1]

    try:
        ref = session()
        ref.run(3)
        ref.drop_task(1)
        ref.run(3)
        twin = session()
        twin.run(3)
        path = os.path.join(str(tmp_path), "s.msgpack")
        save_session(path, twin)
        back = load_session(path, device="cpu")
        sessions.append(back)
        back.drop_task(1)
        back.run(3)
        for name, x, z in zip(ref.state._fields, back.state, ref.state):
            assert torch.equal(x, z), name
        assert back.iteration == ref.iteration == 6
        assert back._world is not twin._world
    finally:
        for s in sessions:
            s.close()


def test_fresh_session_snapshot_roundtrip(tmp_path):
    """A never-run session (no state, no plan) round-trips too."""
    cfg = _store_config("vmap-dense")
    sess = _session(cfg)
    path = os.path.join(str(tmp_path), "s.msgpack")
    save_session(path, sess)
    back = load_session(path, device="cpu")
    assert back.state is None and back._plan is None
    back.run(3)
    sess.run(3)
    _assert_store_equal(back, sess)


def test_snapshot_is_numpy_and_restore_needs_a_device():
    """A snapshot holds numpy only (no tensor of any device), and a
    restore resolves its device as every entry point does."""
    sess = _first_stage(_session(_store_config("async-lossy")))
    tree = snapshot_session(sess)

    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [t]
    assert not any(isinstance(x, torch.Tensor) for x in leaves(tree))
    assert tree["schema_version"] == schema_lib.SCHEMA_VERSION
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            restore_session(tree)
    assert restore_session(tree, device="cpu").device.type == "cpu"


def test_session_store_retention_and_resume(tmp_path):
    cfg = _store_config("vmap-dense")
    store = SessionStore(str(tmp_path), keep_last=2)
    assert store.load(device="cpu") is None
    ref = _session(cfg)
    for _ in range(4):
        ref.run(2)
        store.save(ref)
    assert store.steps() == [6, 8]           # keep_last=2 pruned 2, 4
    back = store.load(device="cpu")
    back.run(2)
    ref.run(2)
    _assert_store_equal(back, ref)


def test_session_store_corrupt_head_falls_back(tmp_path):
    store = SessionStore(str(tmp_path))
    sess = _session(_store_config("vmap-dense"))
    sess.run(2)
    store.save(sess)
    sess.run(2)
    store.save(sess)
    with open(os.path.join(str(tmp_path), "ckpt_00000004.msgpack"),
              "wb") as f:
        f.write(b"not msgpack")
    assert store.load(device="cpu").iteration == 2
    with pytest.raises(checkpoint.CheckpointError):
        store.load(fallback=False, device="cpu")


# ---------------------------------------------------------------------------
# schema: fingerprint guard, migrations, version fencing
# ---------------------------------------------------------------------------
def test_restore_fingerprint_guard():
    sess = _session(_store_config("vmap-dense"))
    sess.run(2)
    tree = snapshot_session(sess)
    tree["data"]["X"] = np.asarray(tree["data"]["X"]) + 1e-3  # drifted env
    with pytest.raises(SchemaError, match="fingerprint"):
        restore_session(tree, device="cpu")
    back = restore_session(tree, check_fingerprint=False, device="cpu")
    assert back.iteration == 2


def test_plan_fingerprint_reads_every_leaf_and_the_qp_config():
    sess = _session(_store_config("vmap-dense"))
    sess.run(1)
    plan = sess._plan
    fp = plan.fingerprint()
    assert fp == plan.fingerprint() and len(fp) == 64
    K = plan.inv.K.clone()
    K[0, 0, 0, 0] = torch.nextafter(K[0, 0, 0, 0], torch.tensor(np.inf))
    assert plan.__class__(plan.prob, plan.inv._replace(K=K),
                          qp_iters=plan.qp_iters).fingerprint() != fp
    assert plan.__class__(plan.prob, plan.inv,
                          qp_iters=plan.qp_iters + 1).fingerprint() != fp


def test_schema_newer_version_rejected():
    tree = snapshot_session(_session(_store_config("vmap-dense")))
    tree["schema_version"] = schema_lib.SCHEMA_VERSION + 1
    with pytest.raises(SchemaError, match="newer"):
        restore_session(tree, device="cpu")


def test_schema_missing_stamp_rejected():
    with pytest.raises(SchemaError, match="schema_version"):
        schema_lib.migrate({"kind": "online_session"})
    with pytest.raises(SchemaError, match="event_log"):
        restore_session({**snapshot_session(_session(
            _store_config("vmap-dense"))), "kind": "event_log"},
            device="cpu")


def test_schema_migration_hook_chains():
    """A registered migration upgrades an old snapshot on load; an
    unregistered gap fails loudly."""
    sess = _session(_store_config("vmap-dense"))
    sess.run(2)
    old = snapshot_session(sess)
    old["schema_version"] = 0
    old["legacy_masks"] = {"active": old.pop("active"),
                           "couple": old.pop("couple")}
    with pytest.raises(SchemaError, match="no migration"):
        restore_session(dict(old), device="cpu")

    @schema_lib.register_migration(0)
    def _v0_to_v1(tree):
        legacy = tree.pop("legacy_masks")
        tree["active"] = legacy["active"]
        tree["couple"] = legacy["couple"]
        tree["schema_version"] = 1
        return tree

    try:
        back = restore_session(dict(old), device="cpu")
        assert back.iteration == 2
        back.run(2)
        sess.run(2)
        _assert_store_equal(back, sess)
    finally:
        schema_lib._MIGRATIONS.pop(0)


def _downgrade(tree, to_version):
    """The dict an older writer would have emitted (the inverse of the
    v2 and v3 migrations)."""
    tree = dict(tree)
    tree["net"] = None if tree["net"] is None else dict(tree["net"])
    if to_version <= 2:
        tree.pop("membership", None)
        if tree["net"] is not None:
            fst = dict(tree["net"]["fabric_state"])
            fst.pop("silence", None)
            fst.pop("ef_resid", None)
            tree["net"]["fabric_state"] = fst
    if to_version <= 1:
        tree.pop("obs", None)
    tree["schema_version"] = to_version
    return tree


@pytest.mark.parametrize("old_version", [1, 2])
def test_old_snapshot_migrates_to_v3_and_continues(tmp_path, old_version):
    """A v1/v2 async snapshot loads with zeroed staleness clocks and the
    placeholder EF residual, and the model trajectory continues bitwise
    (everything but the diagnostic clock, which the old writer never
    kept)."""
    cfg = _store_config("async-lossy")
    ref = _first_stage(_session(cfg))
    path = os.path.join(str(tmp_path), "old.msgpack")
    checkpoint.save(path, _downgrade(snapshot_session(ref), old_version))
    back = load_session(path, device="cpu")
    assert not back._net_state.silence.any()
    assert tuple(back._net_state.ef_resid.shape) == (1, 1, 1, 1)
    assert back._node_events == []
    back.run(3)
    ref.run(3)
    for name, x, z in zip(ref.state._fields, ref.state, back.state):
        assert torch.equal(x, z), name
    for name, x, z in zip(ref._net_state._fields, ref._net_state,
                          back._net_state):
        if name != "silence":
            assert torch.equal(x, z), name


def test_churn_session_snapshot_roundtrip_bitwise(tmp_path):
    """A session with node events round-trips with its membership list,
    staleness clocks and EF residuals, and continues bitwise through a
    crash and a recovery, across two round trips."""
    cfg = _store_config("async-stale-ef")
    ref = _session(cfg)
    ref.run(3)
    ref.node_crash(1)
    ref.run(3)
    twin = _session(cfg)
    twin.run(3)
    twin.node_crash(1)
    path = os.path.join(str(tmp_path), "churn.msgpack")
    save_session(path, twin)
    back = load_session(path, device="cpu")
    assert [e.to_dict() for e in back._node_events] == \
        [e.to_dict() for e in twin._node_events]
    back.run(3)
    _assert_store_equal(back, ref)
    ref.node_recover(1)
    ref.run(2)
    back.node_recover(1)
    save_session(path, back)
    back2 = load_session(path, device="cpu")
    back2.run(2)
    _assert_store_equal(back2, ref)
    assert back2.node_status["events"] == ref.node_status["events"]


# ---------------------------------------------------------------------------
# event logs on disk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", STORE_CONFIGS)
def test_replay_from_saved_log_bitwise(tmp_path, name):
    """The log serializes, loads and replays into the live session,
    bitwise, fabric counters included."""
    log = EventLog()
    live = _store_schedule(_session(_store_config(name), log=log))
    path = os.path.join(str(tmp_path), "run.events")
    log.save(path)
    back = EventLog.load(path)
    assert [r["event"] for r in back.records] == \
        [r["event"] for r in log.records]
    _assert_store_equal(replay(back, device="cpu"), live)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_event_log_save_load_roundtrip(tmp_path, name):
    """Every record survives the disk: arrays bitwise, the config dict
    and the scalars equal; a snapshot is no log."""
    log = EventLog()
    _stage_schedule(_session(_config(name), log=log))
    path = os.path.join(str(tmp_path), "run.events")
    log.save(path)
    back = EventLog.load(path)
    assert len(back) == len(log)
    for rec, got in zip(log.records, back.records):
        assert sorted(rec) == sorted(got)
        for key, want in rec.items():
            if isinstance(want, np.ndarray):
                assert got[key].dtype == want.dtype
                assert got[key].tobytes() == want.tobytes(), key
            else:
                assert got[key] == want, key
    path = os.path.join(str(tmp_path), "snap.msgpack")
    save_session(path, _session(_config(name)))
    with pytest.raises(SchemaError, match="event_log"):
        EventLog.load(path)


def test_node_event_log_replays_churn(tmp_path):
    """node_* records replay from disk, including recover-from-snapshot
    rows embedded in the record."""
    log = EventLog()
    sess = _session(_store_config("async-stale-ef"), log=log)
    sess.run(2)
    ckpt = sess.state
    sess.node_crash(2)
    sess.run(2)
    sess.node_recover(2, from_state=ckpt)
    sess.run(2)
    sess.node_leave(0)
    sess.run(2)
    path = os.path.join(str(tmp_path), "churn.events")
    log.save(path)
    twin = replay(EventLog.load(path), device="cpu")
    _assert_store_equal(twin, sess)
    assert twin.node_status["events"] == sess.node_status["events"]


# ---------------------------------------------------------------------------
# files across the packages
# ---------------------------------------------------------------------------
def _assert_close_to(sess, jsess, label):
    """Each state leaf within REL of the JAX leaf's largest magnitude; the
    risk history within one test sample of 16."""
    gaps = {}
    for field, got, want in zip(sess.state._fields, sess.state,
                                jsess.state):
        want = np.asarray(want, np.float64)
        err = float(np.abs(np.asarray(got, np.float64) - want).max())
        gaps[field] = err / float(np.abs(want).max())
        assert err <= REL * float(np.abs(want).max()), (label, field, err)
    assert sess.iteration == jsess.iteration
    assert len(sess.history) == len(jsess.history)
    risk_gap = max(float(np.abs(np.asarray(h) - np.asarray(j)).max())
                   for h, j in zip(sess.history, jsess.history))
    print(f"{label}: relative gap per leaf {gaps}, risk gap {risk_gap:.2e}")
    assert risk_gap <= 1.0 / 16 + 1e-6


@pytest.mark.parametrize("name", STORE_CONFIGS)
def test_reference_snapshot_continues_in_the_port(tmp_path, name):
    """A snapshot ``repro`` wrote after the first stage restores into the
    port only with ``check_fingerprint=False`` and continues within REL
    of the uninterrupted JAX run."""
    jref = _store_schedule(_session(_store_config(name, True),
                                    jax_side=True))
    jtwin = _first_stage(_session(_store_config(name, True), jax_side=True))
    path = os.path.join(str(tmp_path), "ref.msgpack")
    jstore.save_session(path, jtwin)
    with pytest.raises(SchemaError, match="fingerprint"):
        load_session(path, device="cpu")
    back = load_session(path, device="cpu", check_fingerprint=False)
    assert back.config == _store_config(name)
    _assert_close_to(_rest(_pending_events(back)), jref,
                     f"reference snapshot, {name}")
    if jref._net_state is not None:
        assert back.net_report_["msgs_sent"] == jref.net_report_["msgs_sent"]


@pytest.mark.parametrize("name", STORE_CONFIGS)
def test_port_snapshot_continues_in_the_reference(tmp_path, name):
    """The reverse: a port snapshot restores into ``repro`` (with
    ``check_fingerprint=False``, the fingerprints being each package's
    own) and continues within REL of the port's uninterrupted run."""
    ref = _store_schedule(_session(_store_config(name)))
    twin = _first_stage(_session(_store_config(name)))
    path = os.path.join(str(tmp_path), "port.msgpack")
    save_session(path, twin)
    with pytest.raises(jstore.SchemaError, match="fingerprint"):
        jstore.load_session(path)
    back = jstore.load_session(path, check_fingerprint=False)
    assert back.config == _store_config(name, jax_side=True)
    back = _rest(_pending_events(back))
    for field, want, got in zip(ref.state._fields, ref.state, back.state):
        want = want.numpy().astype(np.float64)
        err = float(np.abs(np.asarray(got, np.float64) - want).max())
        assert err <= REL * float(np.abs(want).max()), (field, err)


@pytest.mark.parametrize("name", ["async-stale-ef", "vmap-budgeted"])
def test_logs_cross_between_the_packages(tmp_path, name):
    """A log file ``repro`` wrote replays in the port within REL of the
    live JAX session, and a port log file replays in ``repro`` within REL
    of the live port session."""
    jlog = JEventLog()
    jlive = _store_schedule(_session(_store_config(name, True), log=jlog,
                                     jax_side=True))
    path = os.path.join(str(tmp_path), "ref.events")
    jlog.save(path)
    _assert_close_to(replay(EventLog.load(path), device="cpu"), jlive,
                     f"reference log, {name}")

    log = EventLog()
    live = _store_schedule(_session(_store_config(name), log=log))
    path = os.path.join(str(tmp_path), "port.events")
    log.save(path)
    jtwin = jstore.replay(JEventLog.load(path))
    for field, want, got in zip(live.state._fields, live.state,
                                jtwin.state):
        want = want.numpy().astype(np.float64)
        err = float(np.abs(np.asarray(got, np.float64) - want).max())
        assert err <= REL * float(np.abs(want).max()), (field, err)


def test_port_file_bytes_match_the_reference_layout(tmp_path):
    """The port writes the reference's layout: the same top-level keys,
    the same fabric-state fields, and a step index the reference reads."""
    sess = _first_stage(_session(_store_config("async-lossy")))
    jsess = _first_stage(_session(_store_config("async-lossy", True),
                                  jax_side=True))
    tree, jtree = snapshot_session(sess), jstore.snapshot_session(jsess)
    assert sorted(tree) == sorted(jtree)
    assert sorted(tree["net"]["fabric_state"]) == \
        sorted(jtree["net"]["fabric_state"])
    assert sorted(tree["data"]) == sorted(jtree["data"])
    SessionStore(str(tmp_path)).save(sess)
    step, got = jcheckpoint.restore_latest(str(tmp_path))
    assert step == 3 and got["kind"] == "online_session"
