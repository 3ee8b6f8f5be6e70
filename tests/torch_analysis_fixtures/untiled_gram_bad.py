"""BAD: untiled-gram-call — a direct weighted_gram call builds the dense
(N, N) K whatever budget the caller holds."""
from repro_torch.kernels import ops


def build_invariants(Z, a, budget):
    return ops.weighted_gram(Z, a)
