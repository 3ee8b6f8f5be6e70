"""GOOD: Gram builds go through the budget route, which streams row
panels when the budget binds."""
from repro_torch.engine import invariants


def build_invariants(Z, a, budget):
    return invariants.gram_and_lipschitz(Z, a, budget)
