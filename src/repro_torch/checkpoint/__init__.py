"""repro_torch.checkpoint: msgpack pytree checkpoints on a step index
(twin of ``repro/checkpoint/``), in the reference's file format."""
from repro_torch.checkpoint.msgpack_ckpt import (  # noqa: F401
    CheckpointError,
    available_steps,
    gc_steps,
    latest_step,
    load,
    restore_latest,
    save,
    save_step,
)
