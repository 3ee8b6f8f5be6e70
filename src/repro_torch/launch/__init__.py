"""Entry points (twin of ``repro/launch/``): serving (``serve``) and
training (``train``: the allreduce and the ADMM-consensus trainers on the
token stream, with checkpoint and resume)."""
