"""The plan/execute layer: invariants once per fit, then the light ADMM
step with a pluggable dual QP engine."""
