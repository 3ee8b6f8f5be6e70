"""The quickstart experiment through the port (twin of
``examples/quickstart.py``).

Two related binary tasks over a 10-node network: the target task has 40
training samples in all (4 per node), the source task 600.  DTSVM
transfers through the consensus constraints and beats per-task DSVM on
the target.

    python -m repro_torch.quickstart                 # on the card
    python -m repro_torch.quickstart --device cpu    # plain versions
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api import DSVM, DTSVM, SolverConfig
from repro_torch.core import graph
from repro_torch.data import synthetic


def data_and_graph():
    """The quickstart's data (numpy, the reference's exactly) and graph."""
    V, T = 10, 2
    n_train = np.zeros((V, T), int)
    n_train[:, 0] = synthetic.split_counts(40, V)    # scarce target task
    n_train[:, 1] = synthetic.split_counts(600, V)   # rich source task
    data = synthetic.make_multitask_data(
        V=V, T=T, p=10, n_train=n_train, n_test=1800,
        relatedness=0.92, noise=1.0, seed=0)
    adj = graph.make_graph("random", V, degree=0.8, seed=0)
    return data, adj


def main(device=None, **overrides) -> dict:
    """Fit DTSVM and DSVM with the quickstart's config (``overrides``
    replace config fields, e.g. ``qp_solver="pallas_fused_multi"``).
    Returns the (T,) global risks of both and DTSVM's consensus
    residuals, as plain floats."""
    data, adj = data_and_graph()
    cfg = SolverConfig(C=0.01, eps1=1.0, eps2=1.0, iters=60, qp_iters=100)
    cfg = cfg.replace(**overrides) if overrides else cfg
    dtsvm = DTSVM(cfg, device=device).fit(data["X"], data["y"],
                                          mask=data["mask"], adj=adj)
    dsvm = DSVM(cfg, device=device).fit(data["X"], data["y"],
                                        mask=data["mask"], adj=adj)
    tr, nr = dtsvm.residuals()
    return {
        "dtsvm": [float(r) for r in dtsvm.global_risks(data["X_test"],
                                                       data["y_test"])],
        "dsvm": [float(r) for r in dsvm.global_risks(data["X_test"],
                                                     data["y_test"])],
        "residuals": [float(tr), float(nr)],
    }


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--qp-solver", default="fista")
    args = ap.parse_args()
    out = main(device=args.device, qp_solver=args.qp_solver)
    r_t, r_d = out["dtsvm"], out["dsvm"]
    print(f"target task:  DTSVM risk={r_t[0]:.3f}   DSVM risk={r_d[0]:.3f}"
          f"   (transfer gain {r_d[0] - r_t[0]:+.3f})")
    print(f"source task:  DTSVM risk={r_t[1]:.3f}   DSVM risk={r_d[1]:.3f}")
    print("consensus residuals: task={:.2e} node={:.2e}".format(
        *out["residuals"]))


if __name__ == "__main__":
    _cli()
