"""repro_torch.dist: the rank worlds of the multi-device backends (twin of
``repro/dist/``, whose device meshes a world of processes replaces):
``world`` (the ranks), ``collectives`` (staged gloo collectives and the
rank counters), ``sharding`` (sample and sweep worlds, rank payloads) and
``sample`` (the ``"sample_shard"`` backend)."""
from repro_torch.dist.world import RankError, World, context

__all__ = ["RankError", "World", "context"]
