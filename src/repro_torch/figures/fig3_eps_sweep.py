"""Fig. 3: converged global risks over the (eps1, eps2) grid (twin of
``benchmarks/fig3_eps_sweep.py``).

Paper setup: 10 nodes of degree 0.87, Task 1 with 50 training samples,
Task 3 with 400, 1800 test samples.  The whole eps grid runs as one
batched ``sweep_fit`` per seed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.figures.common import build, run_csvm_per_task, run_sweep

#: the paper regime (``run(fast=False)`` of the reference): 4 x 4 eps
#: grid, 60 iterations, seeds 0-4
EPS_GRID = (0.1, 1.0, 10.0, 100.0)
ITERS = 60


def sweep_grid(eps_grid, seeds, iters, *, V=10, n_per_task=(50, 400),
               degree=0.8667, qp_iters=100, device=None):
    """``({(eps1, eps2): (T,) mean risks}, csvm (T,), s per config and
    iteration)``."""
    keys = [(e1, e2) for e1 in eps_grid for e2 in eps_grid]
    cfgs = [dict(eps1=e1, eps2=e2) for (e1, e2) in keys]
    acc = {k: [] for k in keys}
    csvm_acc, per_iter = [], []
    for seed in seeds:
        data, A = build(V, list(n_per_task), degree=degree, seed=seed)
        res, dt = run_sweep(data, A, cfgs, iters, qp_iters=qp_iters,
                            device=device)
        finals = res.final_risks()                  # (S, V, T)
        for s, k in enumerate(keys):
            acc[k].append(finals[s].mean(0))
        per_iter.append(dt / (len(cfgs) * iters))
        csvm_acc.append(run_csvm_per_task(data, device=device))
    risks = {k: np.mean(acc[k], 0) for k in keys}
    return risks, np.mean(csvm_acc, 0), float(np.mean(per_iter))
