"""Synthetic data (numpy; exactly the arrays ``repro.data`` makes)."""
