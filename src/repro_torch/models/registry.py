"""Model factory and batch constructor.

Held against ``repro.models.registry`` (``build_model``,
``make_train_batch``) for the families the port builds: ``"dense"``.
Tokens come from an explicit ``torch.Generator``; they are other numbers
than the reference's ``jax.random.randint`` for the same seed, so tests
carry batches across as numpy.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: ArchConfig) -> DecoderLM:
    if cfg.family == "dense":
        return DecoderLM(cfg)
    raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not "
                              "ported yet")


def make_train_batch(cfg: ArchConfig, batch: int, seq: int,
                     generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random next-token batch on the generator's device: tokens
    (batch, seq) int64 in [0, vocab), labels = tokens."""
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=generator, device=generator.device)
    return {"tokens": tokens, "labels": tokens}
