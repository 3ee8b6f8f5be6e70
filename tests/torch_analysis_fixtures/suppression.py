"""Suppression mechanics fixture: a reasoned noqa suppresses (same
line or line above); a bare noqa does not and is itself a finding; an
unknown rule id and an unparseable directive are flagged."""
import torch


def consensus_update(r, adj):
    # repro: noqa[raw-einsum-in-plan] — fixture attestation: stands in for a memory-bound contraction
    a = torch.einsum("uv,vtd->utd", adj, r)
    b = torch.einsum("uv,vtd->utd", adj, r)  # repro: noqa[raw-einsum-in-plan]
    c = torch.einsum("uv,vtd->utd", adj, r)  # repro: noqa[no-such-rule] — not a rule
    d = torch.einsum("uv,vtd->utd", adj, r)  # repro: skip-this-line
    return a + b + c + d


def plan_step(state, g):
    return torch.einsum("nd,d->n", state, g)  # repro: noqa[*] — fixture: wildcard attestation
