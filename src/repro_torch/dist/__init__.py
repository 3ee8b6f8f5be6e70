"""repro_torch.dist: the rank worlds of the multi-device backends (twin of
``repro/dist/``, whose device meshes a world of processes replaces)."""
from repro_torch.dist.world import RankError, World, context

__all__ = ["RankError", "World", "context"]
