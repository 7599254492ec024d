"""Model factory and batch constructors.

Held against ``repro.models.registry`` (``build_model``,
``train_batch_struct``, ``prefill_batch_struct``,
``decode_inputs_struct``, ``make_train_batch``, ``make_decode_inputs``)
for every family of the
configuration registry: ``"dense"``, ``"moe"`` and ``"vlm"`` build
``DecoderLM``; ``"ssm"`` builds ``RWKVLM`` for a config named ``rwkv*``
and raises for any other, as the reference does; ``"hybrid"`` builds
``HybridLM`` and ``"encdec"`` ``EncDecLM``. Tokens, image embeddings and
audio frames come from an explicit ``torch.Generator``; they are other
numbers than the reference's ``jax.random`` draws for the same seed, so
tests carry batches across as numpy. The ``*_struct`` functions give
meta tensors (shapes and dtypes, no storage) for the dry run, with int32
tokens as the reference's.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.rwkv6 import RWKVLM
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: ArchConfig, remat: bool = True):
    """The family's model; ``remat`` recomputes each layer's activations
    in the backward pass (training), as the reference's default."""
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, remat=remat)
    if cfg.family == "ssm":
        if cfg.name.startswith("rwkv"):
            return RWKVLM(cfg, remat=remat)
        raise NotImplementedError(f"ssm arch {cfg.name}")
    if cfg.family == "hybrid":
        return HybridLM(cfg, remat=remat)
    if cfg.family == "encdec":
        return EncDecLM(cfg, remat=remat)
    raise ValueError(f"unknown family {cfg.family}")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_struct(cfg: ArchConfig, batch: int, seq: int
                       ) -> Dict[str, torch.Tensor]:
    s = {"tokens": _meta((batch, seq), torch.int32),
         "labels": _meta((batch, seq), torch.int32)}
    if cfg.family == "vlm":
        s["image_embeds"] = _meta((batch, cfg.num_image_tokens,
                                   cfg.d_model), torch.bfloat16)
    if cfg.family == "encdec":
        s["frames"] = _meta((batch, cfg.encoder_seq, cfg.d_model),
                            torch.bfloat16)
    return s


def prefill_batch_struct(cfg: ArchConfig, batch: int, seq: int
                         ) -> Dict[str, torch.Tensor]:
    s = train_batch_struct(cfg, batch, seq)
    s.pop("labels")
    return s


def decode_inputs_struct(model, cfg: ArchConfig, batch: int,
                         cache_len: int) -> Dict[str, object]:
    return {"token": _meta((batch,), torch.int32),
            "pos": _meta((batch,), torch.int32),
            "cache": model.abstract_cache(batch, cache_len)}


def make_train_batch(cfg: ArchConfig, batch: int, seq: int,
                     generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random next-token batch on the generator's device: tokens
    (batch, seq) int64 in [0, vocab), labels = tokens; for the VLM
    family also image_embeds (batch, num_image_tokens, d_model), for the
    encoder-decoder family frames (batch, encoder_seq, d_model), each
    bf16 normals times 0.02."""
    dev = generator.device
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=generator, device=dev)
    out = {"tokens": tokens, "labels": tokens}
    if cfg.family == "vlm":
        out["image_embeds"] = torch.randn(
            (batch, cfg.num_image_tokens, cfg.d_model), generator=generator,
            device=dev).to(torch.bfloat16) * 0.02
    if cfg.family == "encdec":
        out["frames"] = torch.randn(
            (batch, cfg.encoder_seq, cfg.d_model), generator=generator,
            device=dev).to(torch.bfloat16) * 0.02
    return out


def make_decode_inputs(model, cfg: ArchConfig, batch: int,
                       cache_len: int, generator: torch.Generator
                       ) -> Dict[str, object]:
    """One decode step's inputs at the cache's last position: token
    (batch,), pos (batch,) = cache_len - 1, a zero cache."""
    dev = generator.device
    token = torch.randint(0, cfg.vocab_size, (batch,), generator=generator,
                          device=dev)
    pos = torch.full((batch,), cache_len - 1, dtype=torch.int64, device=dev)
    return {"token": token, "pos": pos,
            "cache": model.init_cache(batch, cache_len, dev)}
