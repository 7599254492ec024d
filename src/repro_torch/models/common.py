"""Parameter initialization and the loss shared by the port's models.

Held against ``repro.models.common`` (``cross_entropy_loss`` and the
``"normal"`` / ``"ones"`` / ``"zeros"`` init recipes of ``_init_leaf``).
Initialization draws from an explicit ``torch.Generator``; it gives other
numbers than the reference's jax keys for the same seed, so tests carry
weights across with ``repro_torch.models.convert`` instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float = 1.0


def _fan_in(shape: Tuple[int, ...]) -> int:
    if len(shape) == 1:
        return shape[0]
    # contraction dim convention: second-to-last (HWIO convs: cin)
    return shape[-2]


def init_leaf(spec: ParamSpec, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, device=device)
    if spec.init == "normal":
        std = spec.scale / math.sqrt(max(_fan_in(spec.shape), 1))
        x = torch.randn(spec.shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        return (x * std).to(device)
    raise ValueError(f"unknown init {spec.init!r}")


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in f32. logits (..., V), labels (...)."""
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.mean(logz - gold)
