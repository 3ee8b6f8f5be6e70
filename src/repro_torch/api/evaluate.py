"""Shared evaluation: per-node and network-average test risks (twin of
``repro/api/evaluate.py``).

Every experiment of the paper evaluates each (node, task) classifier
against one shared per-task test set; the test set goes to the device of
the fitted state.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dtsvm as core


def broadcast_test_set(X_test, y_test, V: int, device) -> Tuple[torch.Tensor,
                                                                torch.Tensor]:
    """Tile a per-task test set to every node: (T, n, p) -> (V, T, n, p).
    Accepts a single-task (n, p) set too."""
    X_test = torch.as_tensor(X_test, dtype=torch.float32, device=device)
    y_test = torch.as_tensor(y_test, dtype=torch.float32, device=device)
    if X_test.ndim == 2:
        X_test = X_test[None]
        y_test = y_test[None]
    if X_test.ndim != 3:
        raise ValueError(f"X_test must be (T, n, p) or (n, p); "
                         f"got shape {tuple(X_test.shape)}")
    return (X_test[None].expand((V,) + X_test.shape),
            y_test[None].expand((V,) + y_test.shape))


def risk_eval_fn(V: int, X_test, y_test, device) -> Callable:
    """Per-iteration eval hook for ``fit``/``run``: state -> (V, T) risks."""
    Xte, yte = broadcast_test_set(X_test, y_test, V, device)
    return lambda st: core.risks(st.r, Xte, yte)


def risks_of_state(state: core.DTSVMState, X_test, y_test) -> torch.Tensor:
    """(V, T) per-node risks of a fitted state on the shared test set.

    Also takes sweep-stacked states (leaves (S, V, T, ...), e.g. a
    ``SweepResult``'s): leading axes before (V, T) broadcast through,
    giving (S, V, T)."""
    V = state.r.shape[-3]
    Xte, yte = broadcast_test_set(X_test, y_test, V, state.r.device)
    return core.risks(state.r, Xte, yte)


def global_risks(risks_vt) -> np.ndarray:
    """Network-average (over nodes) risk per task: (V, T) -> (T,)."""
    if isinstance(risks_vt, torch.Tensor):
        risks_vt = risks_vt.detach().cpu().numpy()
    return np.asarray(risks_vt).mean(axis=0)


def risk_curve(history) -> Optional[np.ndarray]:
    """Stacked per-iteration eval history as a numpy array (or None)."""
    if history is None:
        return None
    if isinstance(history, torch.Tensor):
        history = history.detach().cpu().numpy()
    return np.asarray(history)


def consensus_residuals(state: core.DTSVMState, prob: core.DTSVMProblem):
    """(task_residual, node_residual), from the math layer."""
    return core.consensus_residuals(state, prob)
