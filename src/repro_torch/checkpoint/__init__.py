"""Tree checkpointing (npz, the reference's file format; restore onto the
caller's device)."""

from repro_torch.checkpoint.store import latest_step, restore, save

__all__ = ["latest_step", "restore", "save"]
