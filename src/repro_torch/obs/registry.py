"""MetricsRegistry: one versioned JSON document for every counter (twin of
``repro/obs/registry.py``; the document format is the reference's, so
either package loads and renders the other's files).

Schema (version :data:`OBS_SCHEMA_VERSION`)::

    {
      "kind": "metrics_registry",
      "obs_schema_version": 1,
      "sections": {<name>: <plain JSON payload>, ...}
    }

Section conventions (a convention, not a closed set — ``record`` takes
any JSON-able payload):

=============  =========================================================
section        payload
=============  =========================================================
``plan``       ``Plan.stats`` / ``OnlineSession.plan_stats`` — the
               gram-slices computed/reused/replans counters
``net``        ``net.meter.report`` — bytes/messages/delivery per run,
               plus ``max_silence`` / ``stale_edges`` and, on churn
               sessions, the ``membership`` event summary
``serve``      ``PredictServer.stats()`` — p50/p99 latency, rps,
               rows/batch, pad_ratio
``telemetry``  ``obs.telemetry.summarize`` of the collected streams
               (first/last/min/max per stream), not the raw arrays
``spans``      per-name span count + total duration (ms) from the span
               recorder
=============  =========================================================
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import spans as spans_lib
from repro_torch.obs import telemetry as telemetry_lib

#: registry JSON schema version; ``from_dict`` refuses newer documents.
OBS_SCHEMA_VERSION = 1


def _plain(obj: Any) -> Any:
    """Recursively coerce a payload to plain JSON types (numpy scalars
    and 0-d torch tensors on any device to python numbers, arrays to
    lists); raises ``TypeError`` on anything with no JSON form."""
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _plain(obj.tolist())
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, torch.Tensor) and obj.ndim == 0:
        return _plain(obj.item())
    raise TypeError(f"metrics payload of type {type(obj).__name__} has "
                    f"no JSON form; convert it before record()")


class MetricsRegistry:
    """Named sections of plain-JSON metrics with one version stamp."""

    def __init__(self):
        self._sections: Dict[str, Any] = {}

    # -- building ----------------------------------------------------------
    def record(self, section: str, payload: Any) -> "MetricsRegistry":
        """Set ``section`` to ``payload`` (coerced to plain JSON;
        replaces any previous payload).  Returns self for chaining."""
        self._sections[str(section)] = _plain(payload)
        return self

    def record_spans(self, events: Optional[List[dict]] = None
                     ) -> "MetricsRegistry":
        """Summarize the span recorder (or the given events) into a
        ``spans`` section: per-name call count and total duration, ms."""
        agg: Dict[str, dict] = {}
        for ev in (spans_lib.iter_spans() if events is None else events):
            row = agg.setdefault(ev["name"], {"count": 0, "total_ms": 0.0})
            row["count"] += 1
            row["total_ms"] += float(ev.get("dur", 0.0)) / 1e3
        return self.record("spans", agg)

    @classmethod
    def from_session(cls, sess) -> "MetricsRegistry":
        """A registry absorbing an ``OnlineSession``'s counters:
        ``plan`` (plan_stats), ``net`` (net_report_, when async) and
        ``telemetry`` (stream summaries, when collected)."""
        reg = cls()
        reg.record("plan", getattr(sess, "plan_stats", {}) or {})
        if getattr(sess, "net_report_", None) is not None:
            reg.record("net", sess.net_report_)
        if getattr(sess, "telemetry_", None) is not None:
            reg.record("telemetry",
                       telemetry_lib.summarize(sess.telemetry_))
        return reg

    @classmethod
    def from_solver(cls, solver) -> "MetricsRegistry":
        """A registry absorbing a fitted solver's counters (``net`` and
        ``telemetry``, when present)."""
        reg = cls()
        if getattr(solver, "net_report_", None) is not None:
            reg.record("net", solver.net_report_)
        if getattr(solver, "telemetry_", None) is not None:
            reg.record("telemetry",
                       telemetry_lib.summarize(solver.telemetry_))
        return reg

    # -- reading -----------------------------------------------------------
    def sections(self) -> List[str]:
        """Sorted section names."""
        return sorted(self._sections)

    def get(self, section: str) -> Any:
        """One section's payload (KeyError on unknown)."""
        return self._sections[section]

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        """The versioned plain-JSON document (see module docstring)."""
        return {
            "kind": "metrics_registry",
            "obs_schema_version": OBS_SCHEMA_VERSION,
            "sections": dict(self._sections),
        }

    @classmethod
    def from_dict(cls, tree: dict) -> "MetricsRegistry":
        """Inverse of ``to_dict``; refuses non-registry documents and
        versions newer than this code."""
        if not isinstance(tree, dict) \
                or tree.get("kind") != "metrics_registry":
            raise ValueError("not a metrics registry document: expected "
                             "kind='metrics_registry'")
        v = int(tree.get("obs_schema_version", -1))
        if v < 0:
            raise ValueError("metrics registry document has no "
                             "'obs_schema_version'")
        if v > OBS_SCHEMA_VERSION:
            raise ValueError(
                f"metrics registry schema v{v} is newer than this code "
                f"(v{OBS_SCHEMA_VERSION}); upgrade repro_torch to read it")
        reg = cls()
        for name, payload in dict(tree.get("sections", {})).items():
            reg.record(name, payload)
        return reg

    def save(self, path: str) -> None:
        """Write the document to ``path`` as JSON."""
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "MetricsRegistry":
        """Read a registry JSON written by ``save`` (either package's)."""
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    # -- rendering ---------------------------------------------------------
    def render(self) -> str:
        """A human-readable report (what ``python -m repro_torch.obs
        report`` prints): one block per section, one ``key: value`` line
        per scalar, nested dicts indented."""
        lines = [f"metrics registry (schema v{OBS_SCHEMA_VERSION}, "
                 f"{len(self._sections)} sections)"]

        def emit(prefix: str, val: Any):
            if isinstance(val, dict):
                for k in sorted(val):
                    emit(f"{prefix}{k}.", val[k])
            elif isinstance(val, list) and len(val) > 6:
                lines.append(f"  {prefix[:-1]}: [{len(val)} values]")
            else:
                lines.append(f"  {prefix[:-1]}: {val}")

        for name in self.sections():
            lines.append(f"[{name}]")
            emit("", self._sections[name])
        return "\n".join(lines)
