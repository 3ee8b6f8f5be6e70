"""repro_torch.store: durable sessions, event logs and their replay (twin
of ``repro/store/``).

A ``SessionStore`` snapshots an ``OnlineSession`` onto the step-indexed
msgpack files of ``repro_torch.checkpoint`` (retention and corrupt-head
fallback included), and an ``EventLog`` records the session's decisions
so that ``replay`` rebuilds it from its history alone.  On one device both
are BITWISE: a restored or replayed session continues the trajectory of
the uninterrupted one, async sessions with live mailboxes, delay rings
and round-keyed drop streams included (tests/test_torch_store.py).

    from repro_torch.store import SessionStore, EventLog, replay
    store = SessionStore("ckpts/", keep_last=3)
    log = EventLog()
    sess = OnlineSession(X, y, mask=mask, adj=adj, config=cfg, log=log)
    sess.run(30); store.save(sess); log.save("run.events")
    ...
    sess = store.load()                           # state-based resume
    twin = replay(EventLog.load("run.events"))    # history-based rebuild

Snapshots and logs are the reference's files: each package loads the
other's (a snapshot across packages or devices with
``check_fingerprint=False``, see ``session_store``).
"""
from repro_torch.store.events import EVENTS, EventLog, replay
from repro_torch.store.schema import (SCHEMA_VERSION, SchemaError, migrate,
                                      register_migration)
from repro_torch.store.session_store import (SessionStore, load_session,
                                             restore_session, save_session,
                                             snapshot_session)

__all__ = [
    "EVENTS",
    "EventLog",
    "SCHEMA_VERSION",
    "SchemaError",
    "SessionStore",
    "load_session",
    "migrate",
    "register_migration",
    "replay",
    "restore_session",
    "save_session",
    "snapshot_session",
]
