"""Entry points (twin of ``repro/launch/``): serving so far."""
