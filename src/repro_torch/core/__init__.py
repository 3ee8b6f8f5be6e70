"""DTSVM (Prop. 1), its DSVM baseline, the box-QP solvers and graphs, and
the consensus substrate that lifts Prop. 1 to deep networks."""
from repro_torch.core import consensus  # noqa: F401
