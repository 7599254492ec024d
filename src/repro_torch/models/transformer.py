"""Decoder-only transformer LM, dense family.

Held against ``repro.models.transformer.DecoderLM`` (family ``"dense"``):
``param_specs``, ``init``, ``forward`` and ``loss``. Parameters are a flat
dict in the reference's leaf order (``embed.head``, ``embed.tok``,
``final_norm.gamma``, ``layers.attn.wk``, ...); the ``layers.*`` leaves
carry a leading stacked layer axis, as the reference's scanned layers
do. A Python loop over that axis replaces ``lax.scan``. The reference's
remat (``jax.checkpoint``) is a memory policy with no effect on the
numbers and is left out.

Not ported yet: the MoE, VLM and MLA variants, decode and prefill.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (
    ParamSpec,
    apply_norm,
    cross_entropy_loss,
    init_params,
    norm_specs,
    stack_specs,
    subtree,
)
from repro_torch.models.convert import in_leaf_order
from repro_torch.models.layers import (
    attention_specs,
    attention_train,
    embed_tokens,
    embedding_specs,
    lm_head,
    mlp_apply,
    mlp_specs,
)

Tree = Dict[str, torch.Tensor]


def _prefixed(prefix: str, specs: Dict[str, ParamSpec]
              ) -> Dict[str, ParamSpec]:
    return {prefix + k: v for k, v in specs.items()}


class DecoderLM:
    """The dense decoder LM (pre-norm attention + MLP blocks)."""

    def __init__(self, cfg: ArchConfig):
        if cfg.family != "dense" or cfg.moe is not None \
                or cfg.mla is not None:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} (moe={cfg.moe is not None},"
                f" mla={cfg.mla is not None}) is not ported yet; the port "
                "builds the dense family")
        self.cfg = cfg

    def param_specs(self) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        layer = {
            **_prefixed("ln1.", norm_specs(cfg, cfg.d_model)),
            **_prefixed("attn.", attention_specs(cfg)),
            **_prefixed("ln2.", norm_specs(cfg, cfg.d_model)),
            **_prefixed("ffn.", mlp_specs(cfg)),
        }
        specs = {
            **_prefixed("embed.", embedding_specs(cfg)),
            **_prefixed("final_norm.", norm_specs(cfg, cfg.d_model)),
            **_prefixed("layers.", stack_specs(cfg.n_layers, layer)),
        }
        return in_leaf_order(specs)

    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None) -> Tree:
        """Fresh parameters from ``generator`` (drawn in leaf order)."""
        return init_params(self.param_specs(), generator, device)

    def _block(self, lp: Tree, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(cfg, x, lp, "ln1.")
        x = x + attention_train(cfg, subtree(lp, "attn."), h)
        h2 = apply_norm(cfg, x, lp, "ln2.")
        return x + mlp_apply(cfg, subtree(lp, "ffn."), h2)

    def forward(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        """-> logits (B, S, V). (The reference also returns an auxiliary
        loss; the dense family's is 0.)"""
        cfg = self.cfg
        x = embed_tokens(cfg, subtree(params, "embed."), batch["tokens"])
        layers = subtree(params, "layers.")
        for i in range(cfg.n_layers):
            x = self._block({k: v[i] for k, v in layers.items()}, x)
        x = apply_norm(cfg, x, params, "final_norm.")
        return lm_head(cfg, subtree(params, "embed."), x)

    def loss(self, params: Tree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        # next-token prediction
        return cross_entropy_loss(self.forward(params, batch)[:, :-1, :],
                                  batch["labels"][:, 1:])
