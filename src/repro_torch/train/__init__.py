"""Step functions (twin of ``repro/train/``): the serving half so far."""
