"""GOOD: hot-path contractions use the mul+reduce form; einsum in a
host-side diagnostic (not reachable from a hot root) is fine."""
import torch


def consensus_update(r, adj):
    return (adj[:, :, None, None] * r[None]).sum(1)


def gram_diagnostic(Z, a):
    return torch.einsum("nd,d,md->nm", Z, a, Z)
