"""repro_torch.store: event logs and their replay (twin of
``repro/store/``, so far its ``events`` module).

    from repro_torch.store import EventLog, replay
    log = EventLog()
    sess = OnlineSession(X, y, mask=mask, adj=adj, config=cfg, log=log)
    sess.run(30); sess.drop_task(1); sess.run(30)
    twin = replay(log)                 # bitwise the live session

``replay`` also takes a log that ``repro.store.EventLog`` recorded.
Snapshots (``SessionStore``), the schema and the on-disk form of a log
are ROADMAP.md, 'Modules to port', item 3 (store and checkpoint).
"""
from repro_torch.store.events import EVENTS, EventLog, replay

__all__ = ["EVENTS", "EventLog", "replay"]
