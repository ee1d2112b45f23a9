"""Fault-tolerant checkpointing of nested tensors and arrays."""
from repro_torch.checkpoint.checkpointer import (
    COMMITTED,
    Checkpointer,
    latest_step,
    restore,
    save,
)

__all__ = ["COMMITTED", "Checkpointer", "latest_step", "restore", "save"]
