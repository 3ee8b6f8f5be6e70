"""GOOD: the kernel wrapper stays observation-free: it returns tensors
only; diagnostics are computed by the engine step."""
import torch


def fused_step(K, q, lam, hi):
    return torch.minimum(torch.clamp_min(lam + q - K @ lam, 0.0), hi)
