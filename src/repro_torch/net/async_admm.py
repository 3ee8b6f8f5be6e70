"""Asynchronous Prop.-1 ADMM over a Fabric: stale mailboxes, real bytes
(twin of ``repro/net/async_admm.py``).

The synchronous step (``engine.plan_step``) touches the network in two
places, both through its ``nbr_reduce`` hook: the f-term sums the
neighbors' previous decision variables (eq. 11), and the beta update
sums their fresh ones (eq. 9).  ``run_async`` runs the same
``plan_step`` with a fabric-backed ``nbr_reduce``: call 1 reads the
mailboxes as they stand, call 2 publishes the nodes' new variables
through the fabric (one metered exchange per round) and reads the
mailboxes after delivery.  The schedule's per-round activations gate
both the state update (inactive nodes freeze) and the sends.

The identity fabric's reduce is the synchronous einsum over the values
the ``vmap`` path sums, so the lossless, zero-delay, full-schedule
configuration gives ``Plan.run``'s trajectory bit for bit
(tests/test_torch_net.py).

The reference's ``lax.scan`` is a Python loop over rounds here.  Every
per-round mask (the schedule's activations and links, the membership's
maintenance masks, the drop stream) is made on the host once per call
and moved to the device in one copy each, so a round reads nothing back
from the device; a mailbox fabric reads its round counter once per call.
Fabric state (mailboxes, delay rings, byte counters) is an input and an
output, so a run can be split across calls (the ``OnlineSession`` does)
without changing the stream: drops are keyed on the absolute round.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import dtsvm as core
from repro_torch.engine import plan as engine_plan
from repro_torch.net import elastic as elastic_lib
from repro_torch.net import fabric as fabric_lib
from repro_torch.net import meter as meter_lib
from repro_torch.net import schedule as schedule_lib
from repro_torch.net.policies import NetConfig
from repro_torch.obs import telemetry as obs_telemetry


class AsyncResult(NamedTuple):
    state: core.DTSVMState
    history: Optional[torch.Tensor]   # (iters, ...) eval_fn outputs or None
    fabric_state: fabric_lib.FabricState
    report: dict                      # byte/message accounting (meter)
    fabric: fabric_lib.Fabric
    #: the per-round convergence streams (float32 numpy; None without a
    #: telemetry spec)
    telemetry: Optional[dict] = None


def _fabric_step(plan: engine_plan.Plan, fab: fabric_lib.Fabric,
                 state: core.DTSVMState, fst: fabric_lib.FabricState,
                 act, links, task_counts, *, rnd: Optional[int],
                 keep: Optional[torch.Tensor]):
    """One async round: ``plan_step`` against a fabric-backed
    ``nbr_reduce``, then the schedule's freeze merge.  Returns (state,
    fabric state, the round's bytes)."""
    calls = {"n": 0}
    cell = {}

    def nbr_reduce(arr):
        calls["n"] += 1
        if calls["n"] == 1:
            # eq. (11): last-received neighbor variables, as they stand
            return fab.reduce(fst)
        # eq. (9): publish this round's fresh variables, then read what
        # the links delivered
        fst2, bytes_now = fab.exchange(fst, arr, act, links,
                                       task_counts=task_counts, rnd=rnd,
                                       keep=keep)
        cell["fst"] = fst2
        cell["bytes"] = bytes_now
        return fab.reduce(fst2)

    # the materialized f32 dual path, as in the reference
    new = engine_plan.plan_step(plan.prob, plan.inv, state,
                                qp_iters=plan.qp_iters,
                                qp_solver=plan.qp_solver,
                                nbr_reduce=nbr_reduce)
    if calls["n"] != 2:
        raise AssertionError(
            f"plan_step called nbr_reduce {calls['n']} times, expected 2 "
            f"(f-term + beta update); the fabric hook needs updating")
    # schedule freeze: a node that did not compute this round keeps its
    # whole state
    on = (act > 0)[:, None, None]
    merged = core.DTSVMState(*(torch.where(on, n, o)
                               for n, o in zip(new, state)))
    return merged, cell["fst"], cell["bytes"]


def run_async(prob: core.DTSVMProblem, iters: int, *,
              net: Optional[NetConfig] = None,
              plan: Optional[engine_plan.Plan] = None,
              fabric: Optional[fabric_lib.Fabric] = None,
              fabric_state: Optional[fabric_lib.FabricState] = None,
              qp_iters: int = 200, qp_solver: str = "fista",
              state: Optional[core.DTSVMState] = None,
              eval_fn: Optional[Callable] = None,
              round0: int = 0, budget=None, telemetry=None,
              membership: Optional[elastic_lib.Membership] = None
              ) -> AsyncResult:
    """Run ``iters`` asynchronous rounds of Prop. 1 over the fabric, on
    the problem's device.

    ``net`` declares the communication model (default: the identity,
    the synchronous trajectory with byte metering).  ``budget``
    (``engine.PlanBudget``) streams the plan's K build when no ``plan``
    is given.  ``plan`` / ``fabric`` / ``fabric_state`` carry compiled
    invariants and live mailboxes across calls; ``round0`` enters the
    schedule at that absolute round (and starts a new fabric's round
    counter there; a carried ``fabric_state`` keeps its own).  A plan
    runs its materialized f32 dual solve: other QP modes raise
    ``ValueError``, as ``backends.run`` does for them.

    ``membership`` (``repro_torch.net.elastic.Membership``) makes the
    node set elastic: its alive mask multiplies the schedule's
    activations, its gone mask withdraws a graceful leaver's links, and
    its gc/fill masks fire ``Fabric.apply_membership`` before the event
    round's exchange.  A trivial membership is exactly ``None``; any
    real event forces mailbox mode.

    ``telemetry`` (a ``repro_torch.obs.Telemetry``) collects its streams
    from every round's committed state, plus ``bytes_round`` (the bytes
    series the loop keeps anyway), ``staleness`` ((rounds, V): each
    node's largest incoming-edge silence after the round) and, under a
    membership, ``nodes_alive``.  The rounds' rows stay on the device and
    are copied to the host once after the loop (``AsyncResult.telemetry``);
    nothing the collector makes enters the carried state.
    """
    net = net if net is not None else NetConfig()
    if plan is None:
        plan = engine_plan.compile_problem(prob, qp_iters=qp_iters,
                                           qp_solver=qp_solver,
                                           budget=budget)
    elif (plan.qp_precision, plan.qp_operator) != ("f32", "materialized"):
        raise ValueError(
            "run_async steps the plan's materialized f32 dual path; got a "
            f"plan with qp_precision={plan.qp_precision!r}, "
            f"qp_operator={plan.qp_operator!r}")
    if state is None:
        state = core.init_state(prob)
    V = prob.X.shape[0]
    dev = prob.X.device
    adj_np = prob.adj.cpu().numpy()

    mem = membership
    if mem is not None and mem.is_trivial:
        mem = None                       # identity: exactly no membership
    sched = schedule_lib.resolve(net.schedule, seed=net.seed)
    acts, links = sched.emit(V, iters, adj=adj_np, round0=round0)
    mm = None
    if mem is not None:
        mm = mem.masks(V, iters, round0=round0)
        acts = np.asarray(acts) * mm["alive"]
        links = elastic_lib.combine_links(links, mm, adj_np)
    acts = torch.as_tensor(np.asarray(acts, np.float32), device=dev)
    has_links = links is not None
    if fabric is None:
        fabric = fabric_lib.build_fabric(prob, net,
                                         force_mailbox=has_links)
    elif has_links and fabric.mode == "buffer":
        raise ValueError("a link-varying schedule (or membership with "
                         "events) needs a mailbox-mode fabric; build it "
                         "with force_mailbox=True")
    if has_links:
        links = torch.as_tensor(np.asarray(links, bool), device=dev)
    if fabric_state is None:
        payload0 = state.r * prob.active[..., None]
        fabric_state = fabric.init_state(payload0, round0=round0)
    task_counts = prob.active.sum(1)                     # (V,) live rows

    # the per-round host inputs of a mailbox fabric: its absolute round
    # (read once) and the drop stream of every round of this call
    k0, keeps = None, None
    if fabric.mode == "mailbox":
        k0 = int(fabric_state.round)
        keeps = fabric.keep_masks(k0, iters)
    if mem is not None:
        gc = torch.as_tensor(mm["gc"], device=dev)
        fill = torch.as_tensor(mm["fill"], device=dev)

    if telemetry is not None:
        terms = obs_telemetry.problem_terms(plan.prob)

    st, fst = state, fabric_state
    hist, bytes_rounds, rows, stale_rounds = [], [], [], []
    for i in range(iters):
        if mem is not None:
            # fires before the round's exchange: GC a leaver's columns,
            # warm-fill a joiner's edges from the current variables
            payload = st.r * plan.prob.active[..., None]
            fst = fabric.apply_membership(fst, gc[i], fill[i], payload)
        new, fst, bytes_now = _fabric_step(
            plan, fabric, st, fst, acts[i],
            links[i] if has_links else None, task_counts,
            rnd=None if k0 is None else k0 + i,
            keep=None if keeps is None else keeps[i])
        if eval_fn is not None:
            hist.append(eval_fn(new))
        bytes_rounds.append(bytes_now)
        if telemetry is not None:
            rows.append(telemetry.collect(plan.prob, plan.inv.hi, new, st,
                                          terms=terms))
            stale_rounds.append(fst.silence.amax(dim=1))
        st = new

    series = (torch.stack(bytes_rounds) if bytes_rounds
              else torch.zeros(0, dtype=torch.float32))
    report = meter_lib.report(fabric, fst, rounds=iters,
                              bytes_per_round=series)
    if mem is not None:
        fired = elastic_lib.events_in(mem, iters, round0)
        report["membership"] = {
            "events": [e.to_dict() for e in fired],
            "final_alive": ([] if iters == 0
                            else [float(a) for a in mm["alive"][-1]]),
            "epochs": len(mem.epochs(V, iters, round0=round0)),
        }
    history = None
    if eval_fn is not None:
        history = torch.stack(hist) if hist else None
    tel_out = None
    if telemetry is not None:
        streams = obs_telemetry.stack_rows(rows, telemetry.streams,
                                           prob.X.shape[1], dev)
        streams["bytes_round"] = series
        streams["staleness"] = (torch.stack(stale_rounds) if stale_rounds
                                else torch.zeros((0, V), device=dev))
        tel_out = obs_telemetry.materialize(streams)
        if mem is not None:
            tel_out["nodes_alive"] = mm["alive"].sum(axis=1).astype(
                np.float32)
    return AsyncResult(state=st, history=history, fabric_state=fst,
                       report=report, fabric=fabric, telemetry=tel_out)
