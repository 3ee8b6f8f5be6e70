"""Host-side span tracing: phase timings as Chrome-trace events (twin of
``repro/obs/spans.py``).

A *span* wraps one real phase boundary of the system — invariant/K
builds, plan compiles, scan executions, session replans, store
snapshot/restore, serve batch windows — and records a wall-clock
``(name, start, duration)`` triple into a process-wide buffer.  The
buffer exports as Chrome trace-event JSON (``to_chrome_trace`` /
``save_trace``), so ``chrome://tracing`` and Perfetto open it directly.

The recorder is deliberately dumb and cheap: ``perf_counter_ns`` on
enter/exit, one lock-protected list append, no allocation in the body.
Spans NEVER touch device values — they time host phases only, so
wrapping a traced region times the *trace*, not the execution (the
execution is timed by wrapping the blocking call, e.g. ``Plan.run``).
Each span is also a ``torch.profiler.record_function`` range, so under a
``torch.profiler`` trace the phases line up with the device timeline.

Span taxonomy (the names the instrumented call sites use):

===================  ====================================================
name                 phase
===================  ====================================================
``invariant_build``  ``engine.invariants.compute_invariants`` (the K
                     build, dense or budgeted)
``plan_compile``     ``engine.compile_problem`` (validation + build)
``plan_replan``      ``Plan.replan`` (incremental invariant rebuild)
``scan_execute``     ``Plan.run``'s ADMM scan (trace + dispatch)
``store_snapshot``   ``store.snapshot_session``
``store_restore``    ``store.restore_session``
``serve_batch``      one ``PredictServer`` padded-bucket GEMM batch
===================  ====================================================

Callers may add their own names freely — the taxonomy is a convention,
not a schema.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Iterator, List, Optional

from torch.profiler import record_function as _record_function

#: recorder capacity: beyond this many events new spans are counted
#: (``dropped_spans``) but not stored, so a long-lived serve process
#: cannot grow the buffer without bound.
MAX_EVENTS = 100_000

_LOCK = threading.Lock()
_EVENTS: List[dict] = []
_DROPPED = 0
_T0_NS = time.perf_counter_ns()


@contextmanager
def span(name: str, **attrs) -> Iterator[None]:
    """Record one host-side phase as a Chrome-trace complete event.

    ``attrs`` (plain JSON-able values) land in the event's ``args`` and
    show up in the trace viewer's detail pane::

        with obs.span("scan_execute", iters=30):
            state, hist = plan.run(state, iters=30)
    """
    global _DROPPED
    t0 = time.perf_counter_ns()
    ctx = _record_function(name)
    ctx.__enter__()
    try:
        yield
    finally:
        ctx.__exit__(None, None, None)
        dur = time.perf_counter_ns() - t0
        ev = {
            "name": name,
            "ph": "X",
            "ts": (t0 - _T0_NS) / 1e3,          # microseconds
            "dur": dur / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if attrs:
            ev["args"] = attrs
        with _LOCK:
            if len(_EVENTS) < MAX_EVENTS:
                _EVENTS.append(ev)
            else:
                _DROPPED += 1


def iter_spans() -> List[dict]:
    """A copy of the recorded events (Chrome-trace event dicts)."""
    with _LOCK:
        return list(_EVENTS)


def dropped_spans() -> int:
    """Events discarded because the buffer hit :data:`MAX_EVENTS`."""
    with _LOCK:
        return _DROPPED


def clear_spans() -> None:
    """Reset the recorder (buffer and drop counter)."""
    global _DROPPED
    with _LOCK:
        _EVENTS.clear()
        _DROPPED = 0


def to_chrome_trace(events: Optional[List[dict]] = None) -> dict:
    """The recorded (or given) events as a Chrome trace-event document:
    ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` — the JSON-object
    trace format ``chrome://tracing`` / Perfetto load directly."""
    return {
        "traceEvents": iter_spans() if events is None else list(events),
        "displayTimeUnit": "ms",
    }


def save_trace(path: str, events: Optional[List[dict]] = None) -> dict:
    """Write :func:`to_chrome_trace` to ``path`` as JSON; returns the
    written document (validated first, so a bad event fails here, not
    in the viewer)."""
    tree = to_chrome_trace(events)
    validate_chrome_trace(tree)
    with open(path, "w") as fh:
        json.dump(tree, fh, default=str)
    return tree


def validate_chrome_trace(tree: dict) -> None:
    """Raise ``ValueError`` unless ``tree`` is a well-formed complete-
    event Chrome trace (the subset this recorder emits): a dict with a
    ``traceEvents`` list whose entries carry a str ``name``, ``ph`` of
    ``"X"``, non-negative numeric ``ts``/``dur``, and int ``pid``/
    ``tid``."""
    if not isinstance(tree, dict) or not isinstance(
            tree.get("traceEvents"), list):
        raise ValueError("not a Chrome trace: expected a dict with a "
                         "'traceEvents' list")
    for i, ev in enumerate(tree["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not a dict")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"traceEvents[{i}] has no str 'name'")
        if ev.get("ph") != "X":
            raise ValueError(
                f"traceEvents[{i}] ph={ev.get('ph')!r}; this recorder "
                f"emits complete events ('X') only")
        for key in ("ts", "dur"):
            v = ev.get(key)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v < 0:
                raise ValueError(
                    f"traceEvents[{i}].{key} must be a non-negative "
                    f"number, got {v!r}")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                raise ValueError(
                    f"traceEvents[{i}].{key} must be an int")
