"""Hand kernels for Hopper (``csrc/``), their wrappers, their plain
PyTorch versions (``ref``) and the dispatch between them (``ops``)."""
