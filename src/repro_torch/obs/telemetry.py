"""Device-side convergence telemetry: per-iteration ADMM diagnostics (twin
of ``repro/obs/telemetry.py``).

A :class:`Telemetry` spec threads through ``Plan.run`` and the async
fabric's round loop and collects one small dict of diagnostics per ADMM
iteration.  Everything here is plain torch on the *outputs* of the step:
the collector never reaches into a kernel and never reads a value back
to the host inside the loop (no ``.item()``, no ``.cpu()``, no
``bool(tensor)``), so on the card it only enqueues launches.  The loop
stacks the rows once at its end (:func:`stack_rows`) and
:func:`materialize` copies them to the host in one transfer, after the
loop.  Two invariants hold:

- telemetry-on is **bitwise identical** to telemetry-off on every model
  output: the collector reads ``new`` and ``prev`` and writes nothing
  into the state the loop carries;
- telemetry adds **no synchronization** to the loop.

Stream catalog (all float32; ``iters`` is the loop's length):

====================  ========  =========================================
stream                shape     meaning
====================  ========  =========================================
``primal_residual``   (iters,)  max consensus-constraint violation —
                                the larger of the task residual
                                (|w0b0 - task mean| over active tasks)
                                and the node residual (|r - neighbor
                                mean|), the quantity Prop. 1 drives to 0
``dual_residual``     (iters,)  max |r_k - r_{k-1}| over active entries
``disagreement``      (iters,T) per-task max over nodes of
                                ||c_v - c̄_t||_2 where c = w0+wt (the
                                working classifier)
``qp_active_frac``    (iters,)  fraction of valid dual coordinates at a
                                box face (lam <= 0 or lam >= hi) after
                                the inner QP
====================  ========  =========================================

The async backend adds ``bytes_round`` (the fabric's bytes per round),
``staleness`` ((rounds, V): each node's oldest incoming-edge silence, in
rounds) and, under a node membership, ``nodes_alive``.  The
``"shard_map"`` backend collects on the caller's side, from each round's
full state as it comes back from the ranks (``api.backends``), with the
same :meth:`Telemetry.collect`.  The ``"sample_shard"`` backend collects
inside its ranks with :func:`collect_shard_diagnostics`: the state
streams from the replicated ``r``, the box-face fraction from per-rank
partial sums combined by one all-reduce.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: every stream ``collect_diagnostics`` knows how to compute, in the
#: order they are collected.
STREAMS: Tuple[str, ...] = ("primal_residual", "dual_residual",
                            "disagreement", "qp_active_frac")


class Telemetry:
    """An immutable telemetry spec: which streams to collect.

    Instances are plain host-side configuration and carry no tensors.
    The default collects every stream in :data:`STREAMS`.
    """

    def __init__(self, streams: Sequence[str] = STREAMS):
        unknown = sorted(set(streams) - set(STREAMS))
        if unknown:
            raise ValueError(f"unknown telemetry streams {unknown}; "
                             f"available: {list(STREAMS)}")
        self.streams: Tuple[str, ...] = tuple(
            s for s in STREAMS if s in set(streams))

    def collect(self, prob, hi, new_state, prev_state, *,
                terms: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """Per-iteration diagnostics for one step ``prev -> new``
        (delegates to :func:`collect_diagnostics`; ``terms`` as there)."""
        return collect_diagnostics(prob, hi, new_state, prev_state,
                                   streams=self.streams, terms=terms)

    def __repr__(self):
        return f"Telemetry(streams={list(self.streams)})"


def problem_terms(prob) -> dict:
    """The collector's terms that depend on the problem alone: a loop
    computes them once and passes them to every :func:`collect_diagnostics`
    call (the same ops on the same inputs, so the same bits as computing
    them each iteration)."""
    act = prob.active[..., None]                       # (V, T, 1)
    A = prob.adj.to(torch.float32)                     # (V, V)
    deg_raw = (A[:, :, None] * prob.active[None, :, :]).sum(1)
    return {
        "act": act,
        "n_act": torch.clamp_min(act.sum(1, keepdim=True), 1.0),
        "A": A,
        "deg": torch.clamp_min(deg_raw, 1.0)[..., None],     # (V, T, 1)
        "has_nbr": (deg_raw[..., None] > 0).to(torch.float32),
        "cnt": torch.clamp_min(prob.active.sum(0), 1.0),     # (T,)
        "n_valid": torch.clamp_min(prob.mask.sum(), 1.0),
    }


def collect_diagnostics(prob, hi, new_state, prev_state, *,
                        streams: Sequence[str] = STREAMS,
                        terms: Optional[dict] = None
                        ) -> Dict[str, torch.Tensor]:
    """One iteration's diagnostics from the step's inputs and outputs.

    ``prob`` is the ``DTSVMProblem``, ``hi`` the (V, T, N) QP box ceiling
    (``PlanInvariants.hi``), ``new_state``/``prev_state`` the post- and
    pre-step ``DTSVMState``; ``terms`` is :func:`problem_terms` of
    ``prob`` (computed here when omitted).  Returns ``{stream: 0-d or
    (T,) f32 tensor}`` on the state's device for the requested streams;
    nothing is read back to the host.
    """
    t = problem_terms(prob) if terms is None else terms
    out: Dict[str, torch.Tensor] = {}
    r = new_state.r
    p = prob.X.shape[-1]
    act = t["act"]
    want = set(streams)

    if "primal_residual" in want:
        # task residual: shared-block deviation from the task mean,
        # active tasks only (the r-layout's [w0, b0] head)
        w0b0 = r[..., : p + 1] * act
        mean_t = w0b0.sum(1, keepdim=True) / t["n_act"]
        task_res = ((w0b0 - mean_t) * act).abs().amax()
        # node residual: deviation from the active-neighbor mean
        r_act = r * act
        nbr_mean = (t["A"][:, :, None, None] * r_act[None]).sum(1) / t["deg"]
        node_res = (((r - nbr_mean) * act).abs() * t["has_nbr"]).amax()
        out["primal_residual"] = torch.maximum(task_res, node_res)

    if "dual_residual" in want:
        out["dual_residual"] = ((new_state.r - prev_state.r).abs()
                                * act).amax()

    if "disagreement" in want:
        # working classifier c = (w0+wt, b0+bt); per-task active mean
        c = (r[..., : p + 1] + r[..., p + 1:]) * act   # (V, T, p+1)
        cbar = c.sum(0) / t["cnt"][:, None]                      # (T, p+1)
        diff = (c - cbar[None]) * act
        norms = torch.sqrt((diff * diff).sum(-1))                # (V, T)
        out["disagreement"] = norms.amax(0)                      # (T,)

    if "qp_active_frac" in want:
        lam = new_state.lam
        at_face = ((lam <= 0.0) | (lam >= hi)).to(torch.float32)
        out["qp_active_frac"] = (at_face * prob.mask).sum() / t["n_valid"]
    return out


def collect_shard_diagnostics(prob, hi_rows, new_state, prev_state,
                              streams: Sequence[str], group=None
                              ) -> Dict[str, torch.Tensor]:
    """The sample-sharded variant of :func:`collect_diagnostics`, called
    in every rank of a ``"sample_shard"`` world (twin of the reference's,
    which psums over a mesh axis).

    In such a rank the consensus leaves (``r``, ``active``, ``adj``) are
    replicated while ``lam``, ``mask`` and ``hi_rows`` are the rank's row
    panel: the state streams compute exactly as in the dense collector,
    and ``qp_active_frac`` sums the rank's box-face and valid counts and
    combines them over ``group`` (``(ranks, process group)``; None: the
    whole world) with one all-reduce of the pair, so every rank holds the
    same value.  Both sums count 0/1 values, exactly in float32.
    """
    from repro_torch.dist import collectives

    state_streams = tuple(s for s in streams if s != "qp_active_frac")
    out = collect_diagnostics(prob, hi_rows, new_state, prev_state,
                              streams=state_streams)
    if "qp_active_frac" in set(streams):
        lam = new_state.lam
        at_face = ((lam <= 0.0) | (lam >= hi_rows)).to(torch.float32)
        sums = collectives.all_reduce(
            torch.stack([(at_face * prob.mask).sum(), prob.mask.sum()]),
            "sum", group=group)
        out["qp_active_frac"] = sums[0] / torch.clamp_min(sums[1], 1.0)
    return out


def stack_rows(rows: List[Dict[str, torch.Tensor]], streams: Sequence[str],
               n_tasks: int, device) -> Dict[str, torch.Tensor]:
    """A loop's per-iteration rows as ``{stream: (iters, ...) tensor}``,
    one ``torch.stack`` per stream, still on the device (zero-length
    streams of the catalog's shapes when the loop ran no iteration)."""
    if rows:
        return {k: torch.stack([row[k] for row in rows]) for k in rows[0]}
    return {k: torch.zeros((0, n_tasks) if k == "disagreement" else (0,),
                           dtype=torch.float32, device=device)
            for k in streams}


def materialize(streams: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Bring stacked device streams to the host as float32 numpy: the one
    sync point, AFTER the loop that produced them.  Every stream goes in
    one flat buffer, so the host waits for one copy."""
    if not streams:
        return {}
    host = torch.cat([v.to(torch.float32).reshape(-1)
                      for v in streams.values()]).cpu().numpy()
    out, at = {}, 0
    for k, v in streams.items():
        out[k] = host[at: at + v.numel()].reshape(tuple(v.shape)).copy()
        at += v.numel()
    return out


def concat_streams(old: Optional[Dict[str, np.ndarray]],
                   new: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Append one run's materialized streams to an accumulated set
    (stream-wise ``np.concatenate`` over the iteration axis; ``old`` may
    be None).  Streams absent from either side pass through unchanged —
    an async stage contributes ``bytes_round``, a vmap stage does not."""
    if old is None:
        return dict(new)
    out = dict(old)
    for k, v in new.items():
        out[k] = (np.concatenate([old[k], v], axis=0)
                  if k in old else np.asarray(v))
    return out


def summarize(streams: Dict[str, np.ndarray]) -> Dict[str, dict]:
    """Per-stream scalar summary (for the metrics registry / CLI): the
    iteration count plus first/last/min/max of the per-iteration scalar
    (multi-dim streams reduce with max over their trailing axes)."""
    out = {}
    for k, v in streams.items():
        v = np.asarray(v, np.float32)
        flat = v.reshape(v.shape[0], -1).max(axis=1) if v.ndim > 1 else v
        out[k] = {
            "iters": int(flat.shape[0]),
            "first": float(flat[0]) if flat.size else None,
            "last": float(flat[-1]) if flat.size else None,
            "min": float(flat.min()) if flat.size else None,
            "max": float(flat.max()) if flat.size else None,
        }
    return out
