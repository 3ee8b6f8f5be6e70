"""DTSVM (Prop. 1), its DSVM baseline, the box-QP solvers and graphs, and
the consensus substrate that lifts Prop. 1 to deep networks, with the
multi-task decomposition w_t = w0 + wt over parameter trees."""
from repro_torch.core import consensus, multitask  # noqa: F401
