"""Checkpoints in the reference's on-disk format (``checkpoint.py``)."""
from repro_torch.checkpointing.checkpoint import (  # noqa: F401
    latest_step, restore_checkpoint, save_checkpoint, state_shardings,
)
