"""Entry points (twin of ``repro/launch/``): serving (``serve``),
training (``train``: the allreduce and the ADMM-consensus trainers on the
token stream, with checkpoint and resume) and the one-card dry run
(``dryrun``: each step run on fake tensors for its peak bytes and FLOPs
against the card's memory, beside ``costs``' analytic model), with the
card's mesh and peak rates (``mesh``)."""
