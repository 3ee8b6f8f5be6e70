"""Fig. 4: converged global risks over the (C, eps2) grid, eps1 = 1 (twin
of ``benchmarks/fig4_c_sweep.py``).  The data regime of Fig. 3; the grid
runs as one batched ``sweep_fit`` per seed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.figures.common import build, run_sweep

#: the paper regime (``run(fast=False)`` of the reference): 3 x 4 grid,
#: 60 iterations, seeds 0-4
C_GRID = (0.001, 0.01, 0.1)
E2_GRID = (0.1, 1.0, 10.0, 100.0)
ITERS = 60


def sweep_grid(c_grid, e2_grid, seeds, iters, *, V=10,
               n_per_task=(50, 400), degree=0.8667, qp_iters=100,
               device=None):
    """``({(C, eps2): (T,) mean risks}, s per config and iteration)``."""
    keys = [(c, e2) for c in c_grid for e2 in e2_grid]
    cfgs = [dict(C=c, eps2=e2) for (c, e2) in keys]
    acc = {k: [] for k in keys}
    per_iter = []
    for seed in seeds:
        data, A = build(V, list(n_per_task), degree=degree, seed=seed)
        res, dt = run_sweep(data, A, cfgs, iters, qp_iters=qp_iters,
                            device=device)
        finals = res.final_risks()                  # (S, V, T)
        for s, k in enumerate(keys):
            acc[k].append(finals[s].mean(0))
        per_iter.append(dt / (len(cfgs) * iters))
    risks = {k: np.mean(acc[k], 0) for k in keys}
    return risks, float(np.mean(per_iter))
