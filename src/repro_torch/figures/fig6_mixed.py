"""Fig. 6 and Table I: a mixed DSVM/DTSVM network (twin of
``benchmarks/fig6_mixed.py``).

6 nodes, each with a few target-task (Task 2) samples; nodes 1-3 also
hold source-task (Task 3) samples and run DTSVM, nodes 4-6 lack the
source data and run plain DSVM but keep exchanging decision variables
with their DTSVM neighbors.  The all-DSVM and the mixed network batch
into one ``sweep_fit`` per seed (active/couple are per-config leaves).
"""
from __future__ import annotations

import numpy as np

from repro_torch.api import dsvm_overrides
from repro_torch.core import graph as graph_lib
from repro_torch.data import synthetic
from repro_torch.figures.common import run_sweep

#: the paper regime (``run(fast=False)`` of the reference): 80
#: iterations, seeds 0-19, 4 target and 200 source samples per node
ITERS = 80


def _mixed_masks(V=6, src_nodes=(0, 1, 2)):
    active = np.ones((V, 2), np.float32)
    couple = np.zeros((V,), np.float32)
    for v in range(V):
        if v in src_nodes:
            couple[v] = 1.0          # DTSVM node: task coupling on
        else:
            active[v, 1] = 0.0       # no source-task data or training
    return active, couple


def mixed_network_risks(seeds, iters, *, V=6, n_tgt=4, n_src=200,
                        n_test=1800, src_nodes=(0, 1, 2), device=None):
    """Per-node target-task risks of the all-DSVM vs the mixed network:
    (left, right) (seeds, V) arrays, and the mean wall per config and
    iteration."""
    left, right, per_iter = [], [], []
    for seed in seeds:
        n_train = np.zeros((V, 2), int)
        n_train[:, 0] = n_tgt                  # scarce target everywhere
        n_train[list(src_nodes), 1] = n_src    # source only at nodes 1-3
        data = synthetic.make_multitask_data(
            V=V, T=2, p=10, n_train=n_train, n_test=n_test,
            relatedness=0.93, noise=1.3, seed=seed)
        A = graph_lib.make_graph("random", V, degree=0.8, seed=seed)
        # LEFT: everyone trains Task 2 with plain DSVM (no source task)
        active_l = np.ones((V, 2), np.float32)
        active_l[:, 1] = 0.0
        # RIGHT: nodes 1-3 run DTSVM with the source task, 4-6 run DSVM
        active_r, couple_r = _mixed_masks(V, src_nodes)
        cfgs = [dsvm_overrides(V, active=active_l),
                dict(eps2=10.0, active=active_r, couple=couple_r)]
        res, dt = run_sweep(data, A, cfgs, iters, device=device)
        finals = res.final_risks()             # (2, V, T)
        left.append(finals[0][:, 0])           # per-node task-2 risk
        right.append(finals[1][:, 0])
        per_iter.append(dt / (len(cfgs) * iters))
    return np.stack(left), np.stack(right), float(np.mean(per_iter))
