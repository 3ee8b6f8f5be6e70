"""Durable ``OnlineSession``s: snapshot, restore, and a step-indexed store
(twin of ``repro/store/session_store.py``).

A snapshot is a plain pytree of numpy arrays (``schema`` stamps its
version) serialized by ``repro_torch.checkpoint`` in the reference's file
format: every array round-trips as raw bytes, so on one device a restored
session CONTINUES BITWISE where the saved one stopped, on the ``vmap``
backend and over the fabric (live mailboxes, delay rings, drop stream),
dense and budgeted (tests/test_torch_store.py).  The layout is the
reference's, so a snapshot crosses between the packages in both
directions.

What is stored, and what is rebuilt:

- stored: the problem data (X, y, mask, adj), the config
  (``SolverConfig.to_dict``), the membership masks, the node-churn event
  list, the ADMM state, the iteration counter, the recorded history
  blocks, the fabric state and per-round byte series of an async session,
  the accumulated telemetry streams (the ``obs`` block, when the session
  collects them), and the compiled plan's content FINGERPRINT
  (``Plan.fingerprint``).
- rebuilt: the plan's invariants (K dominates a snapshot's would-be
  size), by a fresh ``compile_problem`` on restore.  A fresh build equals
  the one the session ran, so the stored fingerprint is checked against
  the rebuild, and an environment that builds other invariants fails
  loudly.  The fingerprint hashes the port's own leaves: a snapshot
  written by the reference, or on another device (the card's K differs
  from the CPU's in the last bits), restores with
  ``check_fingerprint=False`` and then continues within the tolerance
  between the two, not bitwise.  ``plan_stats`` restart on restore.

Restores take ``device=None``, which means ``"cuda"``
(``repro_torch.device``).  ``SessionStore`` puts snapshots on the
``ckpt_<step>.msgpack`` / ``LATEST`` index (step = the session's
iteration counter), with retention (``keep_last``) and the corrupt-head
fallback of ``repro_torch.checkpoint``.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch import device as device_lib
from repro_torch.api.session import OnlineSession
from repro_torch.api.solvers import SolverConfig
from repro_torch.core import dtsvm as core
from repro_torch.engine import plan as engine_plan
from repro_torch.net import elastic as elastic_lib
from repro_torch.net import fabric as fabric_lib
from repro_torch.net import meter as meter_lib
from repro_torch.net.policies import NetConfig
from repro_torch.obs import spans as obs_spans
from repro_torch.store import schema


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def snapshot_session(sess: OnlineSession) -> dict:
    """The session as a plain, versioned pytree of numpy arrays (see the
    module doc for what is stored and what rebuilt).  Serialize it with
    ``repro_torch.checkpoint.save`` or hand it to a ``SessionStore``."""
    with obs_spans.span("store_snapshot", iteration=int(sess.iteration)):
        return _snapshot_session(sess)


def _snapshot_session(sess: OnlineSession) -> dict:
    state = None
    if sess.state is not None:
        state = {k: _host(v) for k, v in sess.state._asdict().items()}
    plan = None
    if sess._plan is not None:
        plan = {"fingerprint": sess._plan.fingerprint(),
                "active": _host(sess._plan.prob.active),
                "couple": _host(sess._plan.prob.couple)}
    net = None
    if sess._net_state is not None:
        net = {"fabric_state": fabric_lib.snapshot_state(sess._net_state),
               "mode": sess._net_fabric.mode,
               "series": np.asarray(sess._net_series, np.float32)}
    test = None
    if sess._test is not None:
        test = {"X": _host(sess._test[0]), "y": _host(sess._test[1])}
    return schema.stamp("online_session", {
        "config": sess.config.to_dict(),
        "data": {"X": _host(sess._X), "y": _host(sess._y),
                 "mask": _host(sess._mask), "adj": _host(sess._adj)},
        "active": sess._active.copy(),
        "couple": sess._couple.copy(),
        "masks_dirty": bool(sess._masks_dirty),
        "jit": bool(sess._jit),
        "test": test,
        "state": state,
        "iteration": int(sess.iteration),
        "history": [np.asarray(h) for h in sess.history],
        "plan": plan,
        "net": net,
        # v2: the accumulated telemetry streams (float32 numpy), or None
        "obs": (None if sess.telemetry_ is None else {"telemetry": {
            k: np.asarray(v, np.float32)
            for k, v in sess.telemetry_.items()}}),
        # v3: the absolute-round node event list IS the membership state;
        # restore replays it, so the staleness and EF arrays of the fabric
        # state line up with it
        "membership": (None if not sess._node_events
                       else [e.to_dict() for e in sess._node_events]),
    })


def _problem_for(sess: OnlineSession, active, couple) -> core.DTSVMProblem:
    """The session's problem under EXPLICIT masks: the snapshot's plan may
    predate pending membership events (``masks_dirty``), so the rebuild
    uses the masks the plan was compiled with, not the session's."""
    cfg = sess.config
    return core.make_problem(
        sess._X, sess._y, sess._mask, sess._adj, C=cfg.C, eps1=cfg.eps1,
        eps2=cfg.eps2, eta1=cfg.eta1, eta2=cfg.eta2,
        box_scale=cfg.box_scale, active=np.array(active, np.float32),
        couple=np.array(couple, np.float32), device=sess.device)


def restore_session(tree: Any, *, check_fingerprint: bool = True,
                    device=None) -> OnlineSession:
    """A live ``OnlineSession`` on ``device`` (``None`` means ``"cuda"``)
    from a snapshot pytree, the port's or the reference's.

    Runs the schema migrations first (``schema.migrate``), then recompiles
    the plan and checks its fingerprint against the stored one: a mismatch
    raises ``SchemaError`` unless ``check_fingerprint=False``, the way out
    for a snapshot from the other package or another device.  An async
    session comes back with its fabric rebuilt from the config and its
    mailboxes, delay rings and counters restored bitwise, so the message
    stream, the round-keyed drop stream included, goes on where it
    stopped.
    """
    with obs_spans.span("store_restore"):
        return _restore_session(tree, check_fingerprint=check_fingerprint,
                                device=device)


def _tensor(x, dev: torch.device) -> torch.Tensor:
    """A float32 tensor on ``dev`` from a snapshot leaf (a read-only numpy
    view of the file, or the reference's in-memory array), copied; the
    dtype is pinned, whatever width was stored."""
    return torch.from_numpy(np.array(x, np.float32)).to(dev)


def _restore_session(tree: Any, *, check_fingerprint: bool,
                     device) -> OnlineSession:
    dev = device_lib.resolve(device)
    tree = schema.migrate(tree)
    if tree.get("kind") != "online_session":
        raise schema.SchemaError(
            f"expected an 'online_session' snapshot, got kind="
            f"{tree.get('kind')!r}")
    cfg = SolverConfig.from_dict(tree["config"])
    d = tree["data"]
    sess = OnlineSession(
        d["X"], d["y"], mask=d["mask"], adj=d["adj"], config=cfg,
        active=np.asarray(tree["active"]), couple=np.asarray(tree["couple"]),
        jit=bool(tree["jit"]), device=dev)
    if tree["test"] is not None:
        sess._test = (_tensor(tree["test"]["X"], dev),
                      _tensor(tree["test"]["y"], dev))
    if tree["state"] is not None:
        sess.state = core.DTSVMState(**{
            k: _tensor(tree["state"][k], dev)
            for k in core.DTSVMState._fields})
    sess.iteration = int(tree["iteration"])
    sess.history = [np.array(h) for h in tree["history"]]
    sess._masks_dirty = bool(tree["masks_dirty"])
    mem = tree.get("membership")
    if mem is not None:
        sess._node_events = [elastic_lib.MembershipEvent.from_dict(e)
                             for e in mem]

    pl = tree["plan"]
    if pl is not None:
        plan = engine_plan.compile_problem(
            _problem_for(sess, pl["active"], pl["couple"]), cfg)
        if check_fingerprint and plan.fingerprint() != pl["fingerprint"]:
            raise schema.SchemaError(
                "rebuilt plan fingerprint does not match the snapshot: this "
                "environment builds other invariants than the one that "
                "saved the session (the other package, another device, or "
                "drift); restore_session(..., check_fingerprint=False) to "
                "continue anyway")
        sess._plan = plan

    net = tree["net"]
    if net is not None:
        netcfg = cfg.net if cfg.net is not None else NetConfig()
        prob = (sess._plan.prob if sess._plan is not None
                else sess.problem())
        fab = fabric_lib.build_fabric(
            prob, netcfg, force_mailbox=(net["mode"] == "mailbox"))
        sess._net_fabric = fab
        sess._net_state = fabric_lib.restore_state(net["fabric_state"],
                                                   device=dev)
        sess._net_series = [float(b) for b in np.asarray(net["series"])]
        sess.net_report_ = meter_lib.report(
            fab, sess._net_state, rounds=sess.iteration,
            bytes_per_round=np.asarray(sess._net_series))

    obs = tree.get("obs")
    if obs is not None:
        # host-side diagnostics: float32 numpy copies, never tensors
        sess.telemetry_ = {k: np.array(v, np.float32)
                           for k, v in obs["telemetry"].items()}
    return sess


def save_session(path: str, sess: OnlineSession) -> None:
    """One session snapshot at an explicit path (atomic write)."""
    checkpoint.save(path, snapshot_session(sess))


def load_session(path: str, *, check_fingerprint: bool = True,
                 device=None) -> OnlineSession:
    """Inverse of ``save_session`` on ``device`` (``CheckpointError`` on a
    bad file, ``SchemaError`` on an unmigratable one)."""
    return restore_session(checkpoint.load(path),
                           check_fingerprint=check_fingerprint,
                           device=device)


class SessionStore:
    """A step-indexed directory of session snapshots with retention.

    Snapshots land on the ``repro_torch.checkpoint`` index
    (``ckpt_<iteration>.msgpack`` + ``LATEST``), so ``keep_last``
    pruning, atomic writes and the corrupt-head fallback all apply::

        store = SessionStore(dir, keep_last=3)
        store.save(sess)                # after every stage
        sess = store.load()             # newest readable snapshot
    """

    def __init__(self, root: str, *, keep_last: Optional[int] = None):
        self.root = os.fspath(root)
        self.keep_last = keep_last

    def save(self, sess: OnlineSession) -> str:
        """Snapshot ``sess`` as step ``sess.iteration``; returns the
        written path (older steps pruned per ``keep_last``)."""
        return checkpoint.save_step(self.root, sess.iteration,
                                    snapshot_session(sess),
                                    keep_last=self.keep_last)

    def load(self, *, fallback: bool = True, check_fingerprint: bool = True,
             device=None) -> Optional[OnlineSession]:
        """The newest readable snapshot as a live session on ``device``
        (None when the store is empty).  ``fallback`` walks back past
        corrupt heads (``repro_torch.checkpoint.restore_latest``)."""
        step, tree = checkpoint.restore_latest(self.root, fallback=fallback)
        if step is None:
            return None
        return restore_session(tree, check_fingerprint=check_fingerprint,
                               device=device)

    def steps(self):
        """Sorted iteration numbers with a snapshot on disk."""
        return checkpoint.available_steps(self.root)
