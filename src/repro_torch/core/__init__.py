"""DTSVM (Prop. 1), its DSVM baseline, the box-QP solvers and graphs."""
