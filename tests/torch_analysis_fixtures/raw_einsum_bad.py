"""BAD: raw-einsum-in-plan — einsum in the hot set without an
attestation of its summation order."""
import torch


def consensus_update(r, adj):
    return torch.einsum("uv,vtd->utd", adj, r)
