"""Checkpointing: atomic, step-indexed, resumable save/restore of the full
training state (params + optimizer + data cursor), in the reference's
on-disk format (the counterpart of ``repro.checkpoint``)."""
from repro_torch.checkpoint.store import (
    CheckpointManager,
    load_pytree,
    save_pytree,
)

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]
