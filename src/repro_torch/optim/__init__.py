"""Optimizers, held against ``repro.optim``."""

from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    apply_updates,
    global_norm,
    momentum,
    sgd,
)

__all__ = ["Optimizer", "sgd", "momentum", "adamw", "apply_updates",
           "global_norm"]
