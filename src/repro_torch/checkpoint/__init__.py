"""Atomic, verified, async checkpoints with keep-last-k and auto-resume
(:mod:`repro_torch.checkpoint.checkpointer`), in the reference's on-disk
format."""

from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    CheckpointCorruptionError,
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)
