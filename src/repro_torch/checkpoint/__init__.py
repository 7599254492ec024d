"""npz checkpoints, held against ``repro.checkpoint``."""

from repro_torch.checkpoint.checkpoint import latest_step, restore, save

__all__ = ["save", "restore", "latest_step"]
