"""OnlineSession: the paper's Fig. 7 setting as an object (twin of
``repro/api/session.py``).

Tasks enter and leave a live consensus network without restarting: only
the ``active`` (V, T) and ``couple`` (V,) masks change between stages,
while the ADMM state (r, alpha, beta, warm-started duals) carries over:

    sess = OnlineSession(X, y, mask=mask, adj=adj,
                         config=SolverConfig(eps2=100.0, qp_iters=100))
    sess.run(30)                       # stage 1: all tasks independent
    sess.drop_task(1); sess.set_coupling(True)
    sess.run(30)                       # stage 2: task 0 couples with 2
    ...
    sess.risks(X_test, y_test)

The session plans incrementally (``repro_torch.engine``): the first
``run`` compiles the problem's invariants into a ``Plan``; afterwards a
membership event invalidates only what it touches (``Plan.replan``):
the counts, the U/a diagonals, the QP box, and the K slices of the
(v, t) pairs whose ``a`` row changed, which one Gram launch rebuilds (a
binding ``PlanBudget`` streams them through the tiled kernel's panels).
Every untouched slice carries over bit for bit; ``plan_stats`` counts
them.  The session runs on ``device`` (``None`` means ``"cuda"``).

``jit=True`` runs each ``run`` through ``core.run_dtsvm`` on a freshly
made problem, as the reference's jitted path does.  The port has no
tracing compiler, so that path is eager; it compiles a new plan per
``run`` and is numerically equivalent to the plan path (tested).

``log=`` takes an ``repro_torch.store.EventLog`` (anything with an
``append(event, **payload)`` method): the constructor and every
membership event and ``run`` are recorded, every array as a numpy copy,
so that ``repro_torch.store.replay`` rebuilds the session from its
history alone, on any device.

With a communication model (``SolverConfig(net=NetConfig(...))`` or
``backend="async"``) the session runs over the fabric
(``repro_torch.net``): mailboxes, delay rings and byte counters carry
across ``run`` calls, a task membership change warm-fills the changed
tasks' mailboxes from the neighbors' current variables before the next
round (the Fig. 7 join), metered as ``warmfill_msgs``, and
``net_report_`` holds the cumulative byte accounting.  The identity
``NetConfig()`` gives the vmap session bitwise, stage for stage.  The
node set is elastic too: ``node_enter`` / ``node_leave`` /
``node_crash`` / ``node_recover`` schedule membership events at the
session's current absolute round, and ``node_recover(v,
from_state=...)`` grafts node v's rows of a saved state.

``repro_torch.store`` snapshots a session to disk and restores it
(``save_session``/``load_session``, ``SessionStore``); on one device the
restored session continues bitwise.

With ``SolverConfig(telemetry=True)`` every ``run`` collects the
per-iteration convergence streams (``repro_torch.obs``), and
``telemetry_`` accumulates them across runs; the state stays bitwise the
telemetry-off session's.

With ``backend="shard_map"`` every ``run`` goes through the
decentralized backend (``core.dtsvm_dist``): one rank per node, each
compiling its node's plan for the run, as the reference's plan-less
branch does (the config's ``budget`` passed on).  ``"sample_shard"``
takes the same branch (``dist.sample``): each ``run`` sends every rank
its rows and builds its panel of K again.  The session starts its
``repro_torch.dist.World`` (V ranks for ``shard_map``,
``backend_options["n_shards"]`` or the default count for
``sample_shard``) at the first ``run`` and keeps it across runs (a
``backend_options["world"]`` is used instead); ``close`` stops it, as
does garbage collection.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.api import backends, evaluate
from repro_torch.api.solvers import (SolverConfig, _as_solver_config,
                                     effective_backend)
from repro_torch.core import dtsvm as core
from repro_torch.core import dtsvm_dist
from repro_torch.dist import sharding
from repro_torch.engine import plan as engine_plan
from repro_torch.net import elastic
from repro_torch.net import meter
from repro_torch.obs import telemetry as obs_telemetry


def _numpy(x, dtype=np.float32) -> np.ndarray:
    """A numpy copy of an array, a tensor on any device, or anything
    ``np.array`` takes (e.g. a reference log's arrays)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype, copy=True)


def _node_index(nodes, V: int):
    return slice(None) if nodes is None else np.asarray(nodes, int)


class OnlineSession:
    """Carry ADMM state across task enter/leave events (paper Fig. 7)."""

    def __init__(self, X, y, mask=None, adj=None, *,
                 config: Optional[SolverConfig] = None,
                 active=None, couple=None, X_test=None, y_test=None,
                 jit: bool = False, log=None, device=None, **overrides):
        self.config = _as_solver_config(config, overrides)
        self.device = dev = device_lib.resolve(device)
        on_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        self._X = on_dev(_numpy(X))
        self._y = on_dev(_numpy(y))
        V, T, N, p = self._X.shape
        self._mask = on_dev(np.ones((V, T, N), np.float32) if mask is None
                            else _numpy(mask))
        self._adj = on_dev(np.zeros((V, V), bool) if adj is None
                           else _numpy(adj, bool))
        self.V, self.T = V, T
        self._active = (np.ones((V, T), np.float32) if active is None
                        else _numpy(active))
        self._couple = (np.ones((V,), np.float32) if couple is None
                        else _numpy(couple))
        self._jit = jit
        self._test = None
        if X_test is not None:
            self._test = evaluate.broadcast_test_set(
                _numpy(X_test), _numpy(y_test), V, dev)
        self.state: Optional[core.DTSVMState] = None
        self.iteration = 0
        self.history = []            # one (iters, V, T) risk block per run()
        self._plan: Optional[engine_plan.Plan] = None
        self._masks_dirty = False    # membership changed since last plan
        # node-level membership: the absolute-round event list; every run
        # passes the whole list and the fabric replays past events into
        # its starting status
        self._node_events = []
        # the async backend's live fabric, its state, and the per-round
        # bytes across all stages
        self._net_fabric = None
        self._net_state = None
        self._net_series = []
        #: the shard_map or sample_shard backend's rank world, started at
        #: the first run
        self._world = None
        #: the fabric's cumulative byte accounting; a vmap session has none
        self.net_report_: Optional[dict] = None
        #: the convergence streams of every run so far, when
        #: config.telemetry (the iteration axis counts rounds)
        self.telemetry_: Optional[dict] = None
        if jit and self._effective_backend() == "async":
            raise ValueError("jit=True is a vmap-session feature; the "
                             "async fabric already scans its rounds — "
                             "drop jit or the net config")
        self._log = log
        self._emit("init", X=_numpy(self._X), y=_numpy(self._y),
                   mask=_numpy(self._mask), adj=_numpy(self._adj, bool),
                   config=self.config.to_dict(),
                   active=self._active.copy(), couple=self._couple.copy(),
                   jit=jit,
                   X_test=None if X_test is None else _numpy(X_test),
                   y_test=None if y_test is None else _numpy(y_test))

    def _emit(self, event: str, **payload) -> None:
        """Append one record to the session's event log, if any."""
        if self._log is not None:
            self._log.append(event, **payload)

    # ------------------------------------------------------------------
    # membership events
    # ------------------------------------------------------------------
    @property
    def active(self) -> np.ndarray:
        """(V, T) activity mask (copy; mutate via the event methods)."""
        return self._active.copy()

    @property
    def couple(self) -> np.ndarray:
        """(V,) task-coupling mask (copy)."""
        return self._couple.copy()

    def add_task(self, task: int, nodes: Optional[Sequence[int]] = None
                 ) -> "OnlineSession":
        """Activate ``task`` at ``nodes`` (default: everywhere)."""
        self._active[_node_index(nodes, self.V), task] = 1.0
        self._masks_dirty = True
        self._emit("add_task", task=int(task), nodes=None if nodes is None
                   else [int(n) for n in nodes])
        return self

    def drop_task(self, task: int, nodes: Optional[Sequence[int]] = None
                  ) -> "OnlineSession":
        """Deactivate ``task``; its per-node state freezes but persists,
        so the task re-enters later exactly where it left off."""
        self._active[_node_index(nodes, self.V), task] = 0.0
        self._masks_dirty = True
        self._emit("drop_task", task=int(task), nodes=None if nodes is None
                   else [int(n) for n in nodes])
        return self

    def set_active(self, active) -> "OnlineSession":
        """Replace the whole (V, T) activity mask at once (bulk form of
        ``add_task``/``drop_task``)."""
        self._active = _numpy(active).reshape(self.V, self.T)
        self._masks_dirty = True
        self._emit("set_active", active=self._active.copy())
        return self

    def set_coupling(self, on: Union[bool, float, np.ndarray],
                     nodes: Optional[Sequence[int]] = None
                     ) -> "OnlineSession":
        """Turn cross-task consensus on/off, per node or globally."""
        if np.ndim(on) == 0:
            self._couple[_node_index(nodes, self.V)] = float(on)
        else:
            if nodes is not None:
                raise ValueError(
                    "pass either a full (V,) couple mask OR a scalar with "
                    "nodes=, not both")
            self._couple = _numpy(on).reshape(self.V)
        self._masks_dirty = True
        self._emit("set_coupling",
                   on=float(on) if np.ndim(on) == 0 else _numpy(on),
                   nodes=None if nodes is None
                   else [int(n) for n in nodes])
        return self

    # ------------------------------------------------------------------
    # node-level membership (repro_torch.net.elastic)
    # ------------------------------------------------------------------
    def _membership(self) -> Optional[elastic.Membership]:
        if not self._node_events:
            return None
        return elastic.Membership(events=tuple(self._node_events))

    def _node_event(self, kind: str, node: int) -> None:
        if self._effective_backend() != "async":
            raise ValueError(
                "node membership events are a fabric feature — configure "
                "a communication model (SolverConfig(net=NetConfig(...))) "
                "or backend='async' first")
        self._node_events.append(elastic.MembershipEvent(
            round=self.iteration, kind=kind, node=int(node)))
        # a buffer-mode (identity) fabric has no per-receiver mailboxes
        # to collect or fill: drop it, so the next run builds a mailbox
        # fabric warm from the current state (its byte counters restart)
        if self._net_fabric is not None and self._net_fabric.mode == "buffer":
            self._net_fabric = None
            self._net_state = None

    def node_enter(self, node: int) -> "OnlineSession":
        """A new node joins at the current round: it starts computing and
        its incident mailboxes warm-fill (metered as ``warmfill_msgs``).
        A no-op on a live node."""
        self._node_event("enter", node)
        self._emit("node_enter", node=int(node))
        return self

    def node_leave(self, node: int) -> "OnlineSession":
        """A graceful departure: the neighbors withdraw the node's links
        and drop its mailbox contributions at once."""
        self._node_event("leave", node)
        self._emit("node_leave", node=int(node))
        return self

    def node_crash(self, node: int) -> "OnlineSession":
        """An abrupt death: the neighbors keep spending bytes into its
        mailbox, and its stale values stay in theirs until the
        bounded-staleness policy (``NetConfig.stale_limit``) ages them
        out."""
        self._node_event("crash", node)
        self._emit("node_crash", node=int(node))
        return self

    def node_recover(self, node: int, from_state=None) -> "OnlineSession":
        """The crashed node rejoins; its incident mailboxes warm-fill like
        an enter.  ``from_state`` (a ``DTSVMState`` of either package,
        e.g. one saved before the crash) grafts its row ``node`` over
        the session's: the node restarts from that state."""
        if from_state is not None and self.state is None:
            raise RuntimeError("run() the session before recovering "
                               "a node from a snapshot state")
        self._node_event("recover", node)
        rows = None
        if from_state is not None:
            grafted = []
            for cur, src in zip(self.state, from_state):
                src = (src.to(cur.device) if isinstance(src, torch.Tensor)
                       else torch.from_numpy(_numpy(src)).to(cur.device))
                cur = cur.clone()
                cur[node] = src[node]
                grafted.append(cur)
            self.state = core.DTSVMState(*grafted)
            rows = {k: _numpy(v[node])
                    for k, v in zip(core.DTSVMState._fields, from_state)}
        self._emit("node_recover", node=int(node), rows=rows)
        return self

    @property
    def node_status(self) -> dict:
        """Current per-node membership: ``{"alive": (V,) bool mask,
        "events": [event dicts fired so far]}``."""
        mem = self._membership()
        alive = (np.ones(self.V, bool) if mem is None
                 else mem.alive_at(self.V, self.iteration) > 0)
        return {"alive": alive,
                "events": [] if mem is None
                else [e.to_dict() for e in mem.events]}

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def problem(self) -> core.DTSVMProblem:
        """The current-stage problem: same arrays, fresh masks.

        The masks are COPIED here: on the CPU a tensor made from a
        float32 numpy array aliases it, and the membership events mutate
        ``_active``/``_couple`` in place, so an uncopied mask would
        rewrite the masks of a plan compiled for the old ones.
        """
        cfg = self.config
        return core.make_problem(
            self._X, self._y, self._mask, self._adj, C=cfg.C,
            eps1=cfg.eps1, eps2=cfg.eps2, eta1=cfg.eta1, eta2=cfg.eta2,
            box_scale=cfg.box_scale, active=self._active.copy(),
            couple=self._couple.copy(), device=self.device)

    def _current_plan(self) -> engine_plan.Plan:
        """The stage's Plan: compiled once, then incrementally re-planned
        (the masks copied, as in ``problem``)."""
        if self._plan is None:
            self._plan = engine_plan.compile_problem(
                self.problem(), self.config)
        elif self._masks_dirty:
            self._plan = self._plan.replan(active=self._active.copy(),
                                           couple=self._couple.copy())
        self._masks_dirty = False
        return self._plan

    @property
    def plan_stats(self) -> dict:
        """Invariant-reuse counters of the incremental planner (empty
        before the first ``run``)."""
        return {} if self._plan is None else dict(self._plan.stats)

    def _effective_backend(self) -> str:
        return effective_backend(self.config)

    def _async_net_kwargs(self, was_dirty: bool, old_active,
                          plan: engine_plan.Plan) -> dict:
        """The carried fabric for the async backend, with the Fig. 7
        warm-fill of the changed tasks when the task membership changed
        since the last run."""
        cfg = self.config
        if (was_dirty and self._net_state is not None
                and old_active is not None):
            changed = plan.prob.active.cpu().numpy() != old_active
            if changed.any():
                payload = self.state.r * plan.prob.active[..., None]
                self._net_state = self._net_fabric.warm_fill(
                    self._net_state, payload,
                    torch.as_tensor(changed, dtype=torch.float32,
                                    device=self.device))
        kw = dict(plan=plan, fabric=self._net_fabric,
                  fabric_state=self._net_state, round0=self.iteration,
                  meter_out={})
        if cfg.net is not None:
            kw["net"] = cfg.net
        mem = self._membership()
        if mem is not None:
            kw["membership"] = mem
        return kw

    def run(self, iters: Optional[int] = None, *, record: bool = True):
        """Advance the live network ``iters`` ADMM iterations under the
        CURRENT membership masks.  Returns the (iters, V, T) risk curve
        (numpy) when a test set was given (and ``record``), else None."""
        cfg = self.config
        backend = self._effective_backend()
        iters = iters if iters is not None else cfg.iters
        self._emit("run", iters=int(iters), record=bool(record))
        ev = None
        if record and self._test is not None:
            Xte, yte = self._test
            ev = lambda st: core.risks(st.r, Xte, yte)  # noqa: E731
        default_qp_mode = (cfg.qp_precision, cfg.qp_operator) == (
            "f32", "materialized")
        # the legacy path runs the core loop, which only knows the
        # materialized f32 operator: other QP modes and telemetry take
        # the plan path, which threads them through
        if self._jit and backend == "vmap" and default_qp_mode \
                and not cfg.telemetry:
            prob = self.problem()
            if self.state is None:
                self.state = core.init_state(prob)
            self.state, hist = core.run_dtsvm(
                prob, iters, cfg.qp_iters, state=self.state, eval_fn=ev,
                qp_solver=cfg.qp_solver)
        else:
            was_dirty = self._masks_dirty
            old_active = (None if self._plan is None
                          else self._plan.prob.active.cpu().numpy())
            # vmap and async run the session's plan; shard_map and
            # sample_shard compile per call in their ranks (the
            # reference's plan-less branch)
            plan = (self._current_plan() if backend in ("vmap", "async")
                    else None)
            prob = plan.prob if plan is not None else self.problem()
            if self.state is None:
                self.state = core.init_state(prob)
            options = dict(cfg.backend_options)
            if plan is not None:
                options["plan"] = plan
            else:
                if cfg.budget is not None:
                    options.setdefault("budget", cfg.budget)
                if "world" not in options:
                    options["world"] = self._rank_world(backend)
            if backend == "async":
                options.update(self._async_net_kwargs(was_dirty,
                                                      old_active, plan))
            if cfg.telemetry:
                options["telemetry"] = obs_telemetry.Telemetry()
                options["telemetry_out"] = {}
            self.state, hist = backends.run(
                prob, iters, backend=backend, qp_iters=cfg.qp_iters,
                qp_solver=cfg.qp_solver, qp_precision=cfg.qp_precision,
                qp_operator=cfg.qp_operator, state=self.state, eval_fn=ev,
                **options)
            if backend == "async":
                out = options["meter_out"]
                self._net_fabric = out["fabric"]
                self._net_state = out["fabric_state"]
                self._net_series.extend(
                    out["report"]["bytes_round_series"])
            if cfg.telemetry:
                streams = options["telemetry_out"].get("streams")
                if streams is not None:
                    self.telemetry_ = obs_telemetry.concat_streams(
                        self.telemetry_, streams)
        self.iteration += iters
        if backend == "async":
            # cumulative accounting: the fabric counters carry across
            # stages, so the report is made against the total rounds
            self.net_report_ = meter.report(
                self._net_fabric, self._net_state, rounds=self.iteration,
                bytes_per_round=np.asarray(self._net_series))
            mem = self._membership()
            if mem is not None:
                self.net_report_["membership"] = {
                    "events": [e.to_dict() for e in mem.events],
                    "final_alive": [float(a) for a in
                                    mem.alive_at(self.V, self.iteration)],
                }
        hist = evaluate.risk_curve(hist)
        if hist is None:
            return None
        self.history.append(hist)
        return hist.copy()

    def _rank_world(self, backend: str):
        """The session's rank world, started once: one rank per node
        (shard_map), or the sample world of ``n_shards`` ranks
        (sample_shard)."""
        if self._world is None or self._world.closed:
            if backend == "sample_shard":
                self._world = sharding.make_sample_world(
                    self._X.shape[2],
                    self.config.backend_options.get("n_shards"),
                    device=self.device)
            else:
                self._world = dtsvm_dist.make_node_world(self.V,
                                                         self.device)
        return self._world

    def close(self) -> None:
        """Stop the session's rank world, if it started one (a later
        ``run`` starts a new one)."""
        if self._world is not None:
            self._world.close()

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _require_state(self) -> core.DTSVMState:
        if self.state is None:
            raise RuntimeError("run() the session first")
        return self.state

    def risks(self, X_test=None, y_test=None) -> torch.Tensor:
        """(V, T) risks on the given (or construction-time) test set."""
        st = self._require_state()
        if X_test is None:
            if self._test is None:
                raise ValueError("no test set given")
            Xte, yte = self._test
            return core.risks(st.r, Xte, yte)
        return evaluate.risks_of_state(st, X_test, y_test)

    def global_risks(self, X_test=None, y_test=None) -> np.ndarray:
        """(T,) network-average risks."""
        return evaluate.global_risks(self.risks(X_test, y_test))

    def residuals(self):
        """(task, node) consensus residuals under the current masks."""
        return core.consensus_residuals(self._require_state(), self.problem())
