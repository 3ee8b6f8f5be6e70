"""BAD: host-sync-in-hot-path — host round-trips in functions reachable
from a hot root (bare names match HOT_ROOTS; the helper is reached
through the same-module call graph)."""
import numpy as np
import torch


def _log_residual(r):
    print("residual", r)
    return r.sum().item()


def plan_step(state, g):
    nrm = np.linalg.norm(g)
    v = float(state)
    host = g.cpu()
    torch.cuda.synchronize()
    _log_residual(nrm)
    return state - v * g + host.numpy() + g.tolist()[0]
