"""Append-only event logs: an ``OnlineSession`` as its decisions (twin of
``repro/store/events.py``).

An event log is a session's HISTORY: the constructor arguments plus
every membership event and ``run`` call, in order.  The port's engine
is deterministic given that history on one device, so ``replay``
rebuilds the exact session from the log alone (tests/test_torch_store.py;
``figures.fig7_online`` audits its figure by a replay).  Records are
plain dicts whose arrays are numpy, so a log is independent of the
framework and the device: a log the reference recorded replays here too,
within the tolerance between the two packages.  ``save``/``load`` put a
log on disk in the reference's format (``repro_torch.checkpoint``,
stamped with the store schema), so a log crosses between the packages
as a file too.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import checkpoint
from repro_torch.store import schema

# the event vocabulary; "init" is always record 0.  The node_* records
# are a fabric session's: a vmap session refuses them live and in a
# replay alike.
EVENTS = ("init", "add_task", "drop_task", "set_active", "set_coupling",
          "run", "node_enter", "node_leave", "node_crash", "node_recover")


class EventLog:
    """An append-only list of session events (see module docstring).

    Sessions built with ``OnlineSession(..., log=log)`` append to it on
    construction and on every membership event / ``run`` call; any
    object with an ``append(event, **payload)`` method works, so tests
    can interpose."""

    def __init__(self, records: Optional[List[Dict[str, Any]]] = None):
        self.records: List[Dict[str, Any]] = (list(records)
                                              if records else [])

    def append(self, event: str, **payload) -> None:
        """Append one event record (the session calls this; event must
        be in ``EVENTS``)."""
        if event not in EVENTS:
            raise ValueError(f"unknown event {event!r}; expected one of "
                             f"{EVENTS}")
        self.records.append({"event": event, **payload})

    def __len__(self) -> int:
        return len(self.records)

    def save(self, path: str) -> None:
        """Serialize the log (atomic write, versioned schema)."""
        checkpoint.save(path, schema.stamp("event_log",
                                           {"records": self.records}))

    @classmethod
    def load(cls, path: str) -> "EventLog":
        """Read a log written by ``save`` (schema-migrated)."""
        tree = schema.migrate(checkpoint.load(path))
        if tree.get("kind") != "event_log":
            raise schema.SchemaError(
                f"expected an 'event_log' artifact, got kind="
                f"{tree.get('kind')!r}")
        return cls(records=tree["records"])


def _nodes(rec: Dict[str, Any]):
    n = rec.get("nodes")
    return None if n is None else [int(v) for v in n]


def replay(log: EventLog, upto: Optional[int] = None, *, device=None):
    """Re-execute a log into a fresh ``OnlineSession`` on ``device``
    (``None`` means ``"cuda"``).

    ``upto`` stops after that many records (prefix replay: time-travel to
    any point of the session's life).  On the device that recorded it,
    the result is bitwise the session that wrote the log.
    """
    from repro_torch.api.session import OnlineSession  # the session knows
    from repro_torch.api.solvers import SolverConfig   # no log; deferred
    records = log.records[:upto]
    if not records or records[0].get("event") != "init":
        raise ValueError("log does not start with an 'init' record — "
                         "was the session built with log=?")
    init = records[0]
    sess = OnlineSession(
        init["X"], init["y"], mask=init["mask"], adj=init["adj"],
        config=SolverConfig.from_dict(init["config"]),
        active=np.asarray(init["active"]),
        couple=np.asarray(init["couple"]), jit=bool(init["jit"]),
        X_test=init["X_test"], y_test=init["y_test"], device=device)
    for rec in records[1:]:
        ev = rec["event"]
        if ev == "add_task":
            sess.add_task(int(rec["task"]), _nodes(rec))
        elif ev == "drop_task":
            sess.drop_task(int(rec["task"]), _nodes(rec))
        elif ev == "set_active":
            sess.set_active(np.asarray(rec["active"]))
        elif ev == "set_coupling":
            on = rec["on"]
            sess.set_coupling(on if np.ndim(on) == 0 else np.asarray(on),
                              _nodes(rec))
        elif ev == "run":
            sess.run(int(rec["iters"]), record=bool(rec["record"]))
        elif ev in ("node_enter", "node_leave", "node_crash"):
            getattr(sess, ev)(int(rec["node"]))
        elif ev == "node_recover":
            rows = rec.get("rows")
            if rows is None:
                sess.node_recover(int(rec["node"]))
            else:
                # the grafted rows are in the record (broadcast to whole
                # state leaves: node_recover reads only its node's row)
                from repro_torch.core.dtsvm import DTSVMState
                v = int(rec["node"])
                sess.node_recover(v, from_state=DTSVMState(*(
                    np.broadcast_to(np.asarray(rows[k], np.float32)[None],
                                    tuple(getattr(sess.state, k).shape))
                    for k in DTSVMState._fields)))
        else:
            raise ValueError(f"cannot replay event {ev!r}")
    return sess
