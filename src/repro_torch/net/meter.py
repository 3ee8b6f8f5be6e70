"""Byte and message accounting (twin of ``repro/net/meter.py``).

The fabric counts transmissions in units of per-task wire vectors (one
(2p+2)-vector in the edge's wire format); this module turns its counters
into a JSON-ready report, key for key the reference's:

    bytes_sent        total charged bytes across all edges and rounds
    bytes_per_round   average, and the full per-round series
    bytes_per_edge    (V, V) matrix [receiver, sender]
    msgs_sent /
    msgs_delivered    task-vector counts; their gap is in-transit loss
                      plus what still sits in the delay rings
    delivery_rate     delivered / sent (1.0 on a perfect fabric)
    warmfill_msgs     out-of-band deliveries (mailbox bootstrap, Fig. 7
                      task-entry refreshes, node enter/recover fills),
                      kept out of the per-round totals
    bytes_per_message per-edge wire size of one task vector (min/max)
    max_silence /
    stale_edges       the oldest edge-silence clock at run end, and how
                      many edges sit past the ``stale_limit``

Everything is plain python floats and lists; the counters are read from
the device once per report.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _np(x, dtype=np.float64) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def report(fabric, fstate, *, rounds: int,
           bytes_per_round: Optional[np.ndarray] = None) -> dict:
    """Aggregate one run's fabric counters into a JSON-ready dict."""
    msgs_sent = _np(fstate.msgs_sent)
    msgs_deliv = _np(fstate.msgs_delivered)
    bytes_m = _np(fabric.bytes_m)
    bytes_edge = msgs_sent * bytes_m
    total = float(bytes_edge.sum())
    series = (None if bytes_per_round is None
              else _np(bytes_per_round))
    sent = float(msgs_sent.sum())
    onwire = bytes_m[bytes_m > 0]
    rep = {
        "mode": fabric.mode,
        "rounds": int(rounds),
        "edges": int(np.count_nonzero(fabric.adj_np)),
        "payload_dim": int(fabric.D),
        "msgs_sent": sent,
        "msgs_delivered": float(msgs_deliv.sum()),
        "delivery_rate": float(msgs_deliv.sum() / sent) if sent else 1.0,
        "bytes_sent": total,
        "bytes_per_round": total / rounds if rounds else 0.0,
        "bytes_per_edge": bytes_edge.tolist(),
        "bytes_per_message_min": float(onwire.min()) if onwire.size else 0.0,
        "bytes_per_message_max": float(onwire.max()) if onwire.size else 0.0,
        "warmfill_msgs": float(_np(fstate.warmfill_msgs)),
    }
    silence = _np(getattr(fstate, "silence", 0))
    adj = fabric.adj_np
    on_edges = silence[adj] if silence.ndim == 2 else np.zeros(0)
    rep["max_silence"] = float(on_edges.max()) if on_edges.size else 0.0
    limit = getattr(fabric, "stale_limit", None)
    rep["stale_limit"] = None if limit is None else int(limit)
    rep["stale_edges"] = (0 if limit is None
                          else int(np.count_nonzero(on_edges > limit)))
    if series is not None:
        rep["bytes_round_series"] = series.tolist()
        # the per-round series counts the bytes edge-wise accounting does
        # (up to f32 accumulation); keep both as a consistency check
        rep["bytes_sent_series_total"] = float(series.sum())
    return rep


def merge_reports(a: dict, b: dict) -> dict:
    """Combine the standalone reports of two sequential ``run_async``
    calls that did NOT share a fabric state.  (The OnlineSession carries
    one fabric state across stages, so its cumulative ``net_report_``
    comes straight from the carried counters instead.)"""
    out = dict(b)
    out["rounds"] = a["rounds"] + b["rounds"]
    for k in ("msgs_sent", "msgs_delivered", "bytes_sent", "warmfill_msgs"):
        out[k] = a[k] + b[k]
    out["bytes_per_round"] = out["bytes_sent"] / max(out["rounds"], 1)
    out["delivery_rate"] = (out["msgs_delivered"] / out["msgs_sent"]
                            if out["msgs_sent"] else 1.0)
    if "bytes_round_series" in a and "bytes_round_series" in b:
        out["bytes_round_series"] = (list(a["bytes_round_series"])
                                     + list(b["bytes_round_series"]))
        out["bytes_sent_series_total"] = (a["bytes_sent_series_total"]
                                          + b["bytes_sent_series_total"])
    out["bytes_per_edge"] = (np.asarray(a["bytes_per_edge"])
                             + np.asarray(b["bytes_per_edge"])).tolist()
    return out


def summarize(rep: dict) -> str:
    """One human line for example scripts and benchmark stdout."""
    return (f"{rep['rounds']} rounds, {rep['msgs_sent']:.0f} msgs "
            f"({rep['delivery_rate']:.0%} delivered), "
            f"{rep['bytes_sent'] / 1024:.1f} KiB total "
            f"({rep['bytes_per_round']:.0f} B/round)")
