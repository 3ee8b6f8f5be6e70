"""The durable-session schema: version stamp + migration registry (twin
of ``repro/store/schema.py``; the two packages read and write one
schema).

Every artifact ``repro_torch.store`` writes — session snapshots
(``session_store``) and event logs (``events``) — carries a
``schema_version`` int and a ``kind`` tag at its top level.  Readers
call ``migrate`` before touching any other field: snapshots written by
an older code version are upgraded in memory, step by registered step,
until they reach the current ``SCHEMA_VERSION``; snapshots from a NEWER
writer fail loudly (downgrades are not a thing we guess at).

Version table
-------------

=======  ==================================================================
version  contents
=======  ==================================================================
1        initial schema: ``online_session`` snapshots (config dict, data
         arrays, membership masks, ADMM state, plan fingerprint, fabric
         state + byte series, history blocks) and ``event_log`` records
         (``init`` / ``add_task`` / ``drop_task`` / ``set_active`` /
         ``set_coupling`` / ``run``).
2        adds the ``obs`` block to ``online_session`` snapshots: the
         accumulated device-side telemetry streams
         (``OnlineSession.telemetry_``), or None when telemetry was off.
         ``event_log`` records are unchanged.
3        node churn (``net.elastic``): ``online_session`` snapshots
         gain a ``membership`` block (the node event list), and async
         fabric states gain the ``silence`` (V, V) staleness clocks and
         ``ef_resid`` error-feedback residuals.  ``event_log`` grows the
         ``node_enter`` / ``node_leave`` / ``node_crash`` /
         ``node_recover`` record kinds (old logs simply never contain
         them — no record rewrite needed).
=======  ==================================================================

Writing a migration
-------------------

When the schema changes, bump ``SCHEMA_VERSION`` and register an
upgrader from the previous version::

    @register_migration(1)
    def _v1_to_v2(tree):
        tree["net"] = tree.pop("fabric", None)     # whatever changed
        tree["schema_version"] = 2
        return tree

``migrate`` chains upgraders, so a v1 file still loads after three more
bumps as long as each step is registered.  The same mechanism guards
the on-disk step index of ``repro_torch.checkpoint``: ``SessionStore.load``
runs ``migrate`` on whatever ``restore_latest`` hands back.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np

SCHEMA_VERSION = 3

# from-version -> upgrader(tree) -> tree (with schema_version bumped)
_MIGRATIONS: Dict[int, Callable[[dict], dict]] = {}


class SchemaError(RuntimeError):
    """A snapshot's schema version cannot be brought to the current one."""


def register_migration(from_version: int):
    """Decorator: register ``fn`` as the upgrader FROM ``from_version``.

    ``fn`` receives the decoded snapshot dict, mutates/returns it, and
    MUST set a strictly larger ``schema_version`` — ``migrate`` chains
    registered steps until the current version is reached.
    """
    def deco(fn: Callable[[dict], dict]):
        _MIGRATIONS[int(from_version)] = fn
        return fn
    return deco


@register_migration(1)
def _v1_to_v2(tree: dict) -> dict:
    """v1 -> v2: ``online_session`` snapshots gain the ``obs`` block
    (accumulated telemetry streams).  Pre-obs sessions carry None —
    exactly a fresh session that never ran with telemetry on.  Event
    logs pass through untouched (they flow through the same chain)."""
    if tree.get("kind") == "online_session":
        tree.setdefault("obs", None)
    tree["schema_version"] = 2
    return tree


@register_migration(2)
def _v2_to_v3(tree: dict) -> dict:
    """v2 -> v3: node churn.  ``online_session`` snapshots gain the
    ``membership`` block (None — a pre-churn session never fired a node
    event), and a stored async fabric state gains zeroed ``silence``
    staleness clocks ((V, V), from the byte-counter shape) plus the
    (1, 1, 1, 1) placeholder ``ef_resid`` — exactly the state a
    pre-churn run would have produced, since nothing was ever silent
    under the old semantics (no staleness policy) and error feedback
    did not exist.  Event logs pass through untouched."""
    if tree.get("kind") == "online_session":
        tree.setdefault("membership", None)
        net = tree.get("net")
        if net is not None:
            fst = net["fabric_state"]
            V = np.asarray(fst["msgs_sent"]).shape[0]
            fst.setdefault("silence", np.zeros((V, V), np.int32))
            fst.setdefault("ef_resid", np.zeros((1, 1, 1, 1), np.float32))
    tree["schema_version"] = 3
    return tree


def migrate(tree: Any) -> dict:
    """Bring a decoded snapshot to ``SCHEMA_VERSION`` (in memory).

    Raises ``SchemaError`` when the stamp is missing, newer than this
    code, or older with no registered migration path.
    """
    if not isinstance(tree, dict) or "schema_version" not in tree:
        raise SchemaError(
            "not a repro_torch.store artifact: missing 'schema_version' "
            f"(got {type(tree).__name__})")
    v = int(tree["schema_version"])
    if v > SCHEMA_VERSION:
        raise SchemaError(
            f"snapshot schema v{v} is newer than this code "
            f"(v{SCHEMA_VERSION}); upgrade repro_torch to read it")
    while v < SCHEMA_VERSION:
        fn = _MIGRATIONS.get(v)
        if fn is None:
            raise SchemaError(
                f"no migration registered from schema v{v} "
                f"(current v{SCHEMA_VERSION}); cannot upgrade")
        tree = fn(tree)
        nv = int(tree["schema_version"])
        if nv <= v:
            raise SchemaError(
                f"migration from v{v} did not advance the version "
                f"(still v{nv})")
        v = nv
    return tree


def stamp(kind: str, tree: dict) -> dict:
    """Attach the current version + kind tag to a fresh artifact."""
    out = dict(tree)
    out["schema_version"] = SCHEMA_VERSION
    out["kind"] = kind
    return out
