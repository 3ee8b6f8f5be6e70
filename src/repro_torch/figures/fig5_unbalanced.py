"""Fig. 5: scarce and unbalanced target labels (twin of
``benchmarks/fig5_unbalanced.py``).

Paper setup: a fully connected 4-node network; Task 1 has 12 training
samples with unbalanced labels (down to 2 positives), Task 3 200
balanced ones.  Each imbalance scenario batches DTSVM and the DSVM
baseline (as sweep-config overrides) into one ``sweep_fit``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.figures.common import (build, run_csvm_per_task,
                                        run_sweep)
from repro_torch.api import dsvm_overrides

#: the paper regime (``run(fast=False)`` of the reference): three
#: scenarios, 60 iterations, seeds 0-14
POS_FRACS = (2 / 12, 4 / 12, 6 / 12)
ITERS = 60


def scenario_risks(pos_fracs, seeds, iters, *, V=4, n_per_task=(12, 200),
                   n_test=1800, csvm_qp_iters=600, device=None):
    """Target-task risks per imbalance scenario: {pos_frac: (dtsvm, dsvm,
    csvm)}, and the mean wall per config and iteration."""
    per_iter = []
    out = {}
    cfgs = [dict(), dsvm_overrides(V)]
    for pf in pos_fracs:
        accs_t, accs_d, accs_c = [], [], []
        for seed in seeds:
            pos = np.full((V, 2), 0.5)
            pos[:, 0] = pf          # unbalanced target labels
            data, A = build(V, list(n_per_task), graph_kind="full",
                            seed=seed, pos_frac=pos, n_test=n_test)
            res, dt = run_sweep(data, A, cfgs, iters, device=device)
            finals = res.final_risks()              # (2, V, T)
            accs_t.append(finals[0].mean(0)[0])
            accs_d.append(finals[1].mean(0)[0])
            accs_c.append(run_csvm_per_task(data, qp_iters=csvm_qp_iters,
                                            device=device)[0])
            per_iter.append(dt / (len(cfgs) * iters))
        out[pf] = (float(np.mean(accs_t)), float(np.mean(accs_d)),
                   float(np.mean(accs_c)))
    return out, float(np.mean(per_iter))
