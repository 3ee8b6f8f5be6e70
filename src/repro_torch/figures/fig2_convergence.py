"""Fig. 2: evolution of the global risks, DTSVM vs DSVM vs CSVM on two
networks (twin of ``benchmarks/fig2_convergence.py``).

Task 1 (target) has ``n_tgt`` training samples in all, Task 3 (source)
``n_src``; C=0.01, eps1=eps2=eta1=eta2=1, the paper's setup.  The figure
shows DTSVM's converged target risk at or below DSVM's and CSVM's.
"""
from __future__ import annotations

import numpy as np

from repro_torch.figures.common import (build, run_csvm_per_task, run_dsvm,
                                        run_dtsvm)

#: the figure's networks at its paper regime (``run(fast=False)`` of the
#: reference): (name, V, degree, target samples); 100 iterations, seeds
#: 0-3, 800 source samples, 1800 test samples
NETS = [("net1_V20_deg0.64_n200", 20, 0.6368, 200),
        ("net2_V10_deg0.89_n200", 10, 0.8889, 200),
        ("net1_V20_deg0.64_n40", 20, 0.6368, 40),
        ("net2_V10_deg0.89_n40", 10, 0.8889, 40)]
ITERS = 100


def curves_for(V, deg, n_tgt, seeds, iters, *, n_src=800, n_test=1800,
               relatedness=0.93, noise=1.0, qp_solver="fista", device=None):
    """Seed-averaged global risk curves of one network regime:
    ``(dtsvm (iters, T), dsvm (iters, T), csvm (T,), s_per_iter)``."""
    h_t, h_d, csv_r, times = [], [], [], []
    for seed in seeds:
        data, A = build(V, [n_tgt, n_src], degree=deg, seed=seed,
                        noise=noise, relatedness=relatedness,
                        n_test=n_test)
        _, hist_t, dt_t, _ = run_dtsvm(data, A, iters, qp_solver=qp_solver,
                                       device=device)
        _, hist_d, _, _ = run_dsvm(data, A, iters, qp_solver=qp_solver,
                                   device=device)
        h_t.append(hist_t.mean(1))      # (iters, T) global risk
        h_d.append(hist_d.mean(1))
        csv_r.append(run_csvm_per_task(data, device=device))
        times.append(dt_t / iters)
    return (np.mean(h_t, 0), np.mean(h_d, 0), np.mean(csv_r, 0),
            float(np.mean(times)))
