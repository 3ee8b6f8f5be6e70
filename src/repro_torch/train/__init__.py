"""Step functions (twin of ``repro/train/``): the allreduce train step,
prefill and decode."""
