"""GOOD: the step only enqueues tensor work; numpy, float() and syncs
live in host-side code, not reachable from a hot root."""
import numpy as np
import torch


def plan_step(state, g):
    return state - torch.linalg.vector_norm(g) * g


def summarize(hist):
    torch.cuda.synchronize()
    return float(np.mean(torch.stack(hist).cpu().numpy()))
