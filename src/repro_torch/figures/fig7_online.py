"""Fig. 7: online transfer learning, tasks entering and leaving a live
network (twin of ``benchmarks/fig7_online.py``).

Fully connected 6-node network; per node 10/10/40 samples of Tasks
1/2/3.  Five stages (paper): 1) all tasks independent (no coupling);
2) Tasks 1 and 3 couple; 3) Task 1 leaves; 4) Tasks 2 and 3 couple;
5) Task 2 leaves.  The ADMM state carries across the stage switches in
one ``OnlineSession``: only the masks change, and each switch re-plans
only the invariants it touches.

The run is recorded in a ``repro_torch.store.EventLog`` and, after the
last stage, replayed into a twin session that must equal the live one
bitwise (state and the whole risk history): each figure point is
reproducible from its event log alone.

Claims: each target task's risk drops during its coupled stage and the
gain persists after it leaves; the source task is never destroyed.

``churn_marks`` runs the same five stages under node churn over a lossy
fabric (``repro_torch.net``: int8 wire with error feedback, 10% drops,
90% partial activation, bounded staleness): node 3 crashes while Task 1
couples and recovers for Task 2's stage, node 5 leaves for the last.
Its node events go through the same event log, and the replay audit
holds it bitwise too.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.api import OnlineSession, SolverConfig
from repro_torch.core import graph as graph_lib
from repro_torch.data import synthetic
from repro_torch.figures.common import _sync
from repro_torch.net import LinkPolicy, NetConfig
from repro_torch.store import EventLog, replay

V, T = 6, 3
#: (name, active tasks, coupling on) of each stage
STAGES = [("s1_independent", (0, 1, 2), False),
          ("s2_t1_with_t3", (0, 2), True),
          ("s3_t1_leaves", (1, 2), False),
          ("s4_t2_with_t3", (1, 2), True),
          ("s5_t2_leaves", (2,), False)]
#: the churn variant's node event of each stage (None: no event): node 3
#: crashes while Task 1 couples, comes back for Task 2's stage, and node 5
#: leaves for the final solo stage
CHURN_EVENTS = (None, ("crash", 3), None, ("recover", 3), ("leave", 5))
CHURN_ALIVE = [True, True, True, True, True, False]


def _assert_replay_matches(sess: OnlineSession,
                           log: EventLog) -> OnlineSession:
    """Replay the event log into a twin session on the live one's device;
    bitwise or raise.  Returns the twin."""
    twin = replay(log, device=sess.device)
    for name, a, b in zip(sess.state._fields, sess.state, twin.state):
        if not torch.equal(a, b):
            raise AssertionError(f"replayed session diverged from the "
                                 f"live run in {name}")
    if twin.iteration != sess.iteration or \
            len(twin.history) != len(sess.history):
        raise AssertionError("replayed session ran other stages")
    for ha, hb in zip(sess.history, twin.history):
        if not torch.equal(torch.from_numpy(ha), torch.from_numpy(hb)):
            raise AssertionError("replayed risk history diverged from the "
                                 "live run")
    return twin


def make_session(*, seed=0, n_test=1800, qp_iters=100, device=None,
                 log=None, **config) -> OnlineSession:
    """A fresh session on the figure's network and data (couplings off,
    eps2=100 per the paper) on ``device``; ``log`` goes to the session,
    ``config`` holds further ``SolverConfig`` fields
    (``qp_solver``, ``qp_precision``, ``qp_operator``, ``budget``)."""
    n_train = np.zeros((V, T), int)
    n_train[:, 0] = 10
    n_train[:, 1] = 10
    n_train[:, 2] = 40
    data = synthetic.make_multitask_data(
        V=V, T=T, p=10, n_train=n_train, n_test=n_test, relatedness=0.9,
        noise=1.0, seed=seed)
    return OnlineSession(
        data["X"], data["y"], mask=data["mask"], adj=graph_lib.full(V),
        config=SolverConfig(C=0.01, eps1=1.0, eps2=100.0,
                            qp_iters=qp_iters, **config),
        X_test=data["X_test"], y_test=data["y_test"],
        couple=np.zeros(V, np.float32), log=log, device=device)


def enter_stage(sess: OnlineSession, tasks, couple: bool) -> None:
    """The membership events of a stage: ``tasks`` active everywhere,
    the task coupling on or off."""
    active = np.zeros((V, T), np.float32)
    active[:, list(tasks)] = 1.0
    sess.set_active(active).set_coupling(couple)


def stage_marks(stage_iters, *, seed=0, n_test=1800, qp_iters=100,
                device=None, **config):
    """The five-stage protocol, event-logged and replay-audited, on
    ``device`` (``None`` means ``"cuda"``; ``config`` as for
    :func:`make_session`).

    Returns ``(marks, info)``: each stage's final (T,) network-average
    risks, and ``info`` with the wall of each stage's ``run`` and of the
    replay audit (ending, on the card, in a synchronize), the live
    ``session`` and the ``plan_stats`` of it and of its replay."""
    dev = device_lib.resolve(device)
    log = EventLog()
    sess = make_session(seed=seed, n_test=n_test, qp_iters=qp_iters,
                        device=dev, log=log, **config)
    marks, stage_s = {}, []
    for name, tasks, couple in STAGES:
        enter_stage(sess, tasks, couple)
        _sync(dev)
        t0 = time.perf_counter()
        hist = sess.run(stage_iters)
        _sync(dev)
        stage_s.append(time.perf_counter() - t0)
        marks[name] = hist.mean(1)[-1]      # (T,) global risks
    t0 = time.perf_counter()
    twin = _assert_replay_matches(sess, log)
    _sync(dev)
    return marks, {"stage_s": stage_s, "replay_s": time.perf_counter() - t0,
                   "session": sess, "plan_stats": sess.plan_stats,
                   "replay_plan_stats": twin.plan_stats}


def derived(marks: dict) -> dict:
    """The figure's claims as numbers (the reference's ``main`` line)."""
    return {"t1_gain_in_stage2": float(marks["s1_independent"][0]
                                       - marks["s2_t1_with_t3"][0]),
            "t2_gain_in_stage4": float(marks["s3_t1_leaves"][1]
                                       - marks["s4_t2_with_t3"][1]),
            "t3_final": float(marks["s5_t2_leaves"][2])}


def run(fast: bool = False, seed=0, device=None, **config):
    """The paper regime (30 iterations a stage; ``fast``: 15): the
    marks and their derived claims."""
    marks, _ = stage_marks(15 if fast else 30, seed=seed, device=device,
                           **config)
    return marks, derived(marks)


def churn_net(seed: int = 0) -> NetConfig:
    """The churn variant's fabric (``benchmarks/fig7_online.py``)."""
    return NetConfig(policy=LinkPolicy(drop=0.1, quant="int8"),
                     schedule="partial:0.9", seed=seed, stale_limit=3,
                     error_feedback=True)


def churn_marks(stage_iters, *, seed=0, n_test=1800, qp_iters=100,
                device=None, **config):
    """The five stages under node churn over the lossy fabric,
    event-logged and replay-audited, on ``device`` (``None`` means
    ``"cuda"``; ``config`` as for :func:`make_session`, e.g.
    ``qp_solver``).  After the last stage the alive mask must be
    :data:`CHURN_ALIVE`.

    Returns ``(marks, info)`` as :func:`stage_marks` does; ``info`` also
    holds the session's cumulative ``net_report_``."""
    dev = device_lib.resolve(device)
    log = EventLog()
    sess = make_session(seed=seed, n_test=n_test, qp_iters=qp_iters,
                        device=dev, log=log, net=churn_net(seed), **config)
    marks, stage_s = {}, []
    for (name, tasks, couple), event in zip(STAGES, CHURN_EVENTS):
        enter_stage(sess, tasks, couple)
        if event is not None:
            kind, node = event
            getattr(sess, f"node_{kind}")(node)
        _sync(dev)
        t0 = time.perf_counter()
        hist = sess.run(stage_iters)
        _sync(dev)
        stage_s.append(time.perf_counter() - t0)
        marks[name] = hist.mean(1)[-1]      # (T,) global risks
    t0 = time.perf_counter()
    twin = _assert_replay_matches(sess, log)
    _sync(dev)
    alive = np.asarray(sess.node_status["alive"]).tolist()
    if alive != CHURN_ALIVE:
        raise AssertionError(f"the churn session ends with alive mask "
                             f"{alive}, expected {CHURN_ALIVE}")
    return marks, {"stage_s": stage_s, "replay_s": time.perf_counter() - t0,
                   "session": sess, "plan_stats": sess.plan_stats,
                   "replay_plan_stats": twin.plan_stats,
                   "net_report": sess.net_report_}
