"""Optimizers, held against ``repro.optim``."""

from repro_torch.optim.optimizers import (
    Optimizer,
    apply_updates,
    global_norm,
    sgd,
)

__all__ = ["Optimizer", "sgd", "apply_updates", "global_norm"]
