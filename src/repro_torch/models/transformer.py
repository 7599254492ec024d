"""Decoder-only transformer LM covering the dense, MoE and VLM families,
with prefill and one-token decode against a KV cache.

Held against ``repro.models.transformer.DecoderLM``: ``param_specs``,
``init``, ``forward``, ``loss``, ``cache_struct``, ``init_cache``,
``decode_step`` and ``prefill``. Parameters are a flat dict in the
reference's leaf order (``embed.head``, ``embed.tok``,
``final_norm.gamma``, ``layers.attn.wk``, ``prefix_layers.0.ffn.wo``,
...); the ``layers.*`` leaves carry a leading stacked layer axis, as the
reference's scanned layers do, and MoE configs with ``first_k_dense``
put that many dense layers ahead of them (``prefix_layers.<i>.*``). A
Python loop over the layers replaces ``lax.scan``. With ``remat`` (the
default, as the reference's) each stacked layer's training body runs
under ``models.common.remat``: its activations are recomputed in the
backward pass instead of kept, with the same numbers.

MoE layers route through ``models.moe`` and MLA attention through
``models.mla``. The VLM family prepends stub image-patch embeddings
(``batch["image_embeds"]``, (B, num_image_tokens, D)) to the token
embeddings; its loss skips the image positions.

The KV cache is a dict of stacked bfloat16 tensors, ``k``/``v`` (L, B,
S, KV, hd), or ``ckv`` (L, B, S, kv_lora + rope) for MLA; a sliding
window caps S (a ring buffer). ``decode_step`` writes into the cache it
is given and returns that same dict: a caller must not reuse a cache it
has passed in as the state before the step.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (
    ParamSpec,
    abstract_params,
    apply_norm,
    cross_entropy_loss,
    init_params,
    norm_specs,
    prefixed,
    remat,
    shard_hint,
    stack_specs,
    subtree,
    unstack,
)
from repro_torch.models.convert import in_leaf_order
from repro_torch.models.layers import (
    attention_decode,
    attention_prefill_kv,
    attention_specs,
    attention_train,
    embed_tokens,
    embedding_specs,
    lm_head,
    mlp_apply,
    mlp_specs,
)

Tree = Dict[str, torch.Tensor]
CACHE_DTYPE = torch.bfloat16



class DecoderLM:
    """families: dense | moe | vlm (pre-norm attention + FFN blocks)."""

    def __init__(self, cfg: ArchConfig, remat: bool = True):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise NotImplementedError(
                f"{cfg.name}: DecoderLM builds the dense, moe and vlm "
                f"families, not {cfg.family!r}")
        self.cfg = cfg
        self.remat = remat
        self.n_prefix = cfg.moe.first_k_dense if cfg.moe else 0
        self.n_scanned = cfg.n_layers - self.n_prefix

    # ------------------------------------------------------------------ #
    # params
    # ------------------------------------------------------------------ #
    def _layer_specs(self, moe_layer: bool,
                     dense_ff: Optional[int] = None) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        attn = (mla_mod.mla_specs(cfg) if cfg.mla is not None
                else attention_specs(cfg))
        ffn = (moe_mod.moe_specs(cfg) if moe_layer
               else mlp_specs(cfg, d_ff=dense_ff))
        return {
            **prefixed("ln1.", norm_specs(cfg, cfg.d_model)),
            **prefixed("attn.", attn),
            **prefixed("ln2.", norm_specs(cfg, cfg.d_model)),
            **prefixed("ffn.", ffn),
        }

    def param_specs(self) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        specs = {
            **prefixed("embed.", embedding_specs(cfg)),
            **prefixed("final_norm.", norm_specs(cfg, cfg.d_model)),
            **prefixed("layers.", stack_specs(
                self.n_scanned, self._layer_specs(cfg.moe is not None))),
        }
        for i in range(self.n_prefix):
            specs.update(prefixed(f"prefix_layers.{i}.", self._layer_specs(
                False, dense_ff=cfg.moe.dense_d_ff)))
        return in_leaf_order(specs)

    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None) -> Tree:
        """Fresh parameters from ``generator`` (drawn in leaf order)."""
        return init_params(self.param_specs(), generator, device)

    def abstract_params(self) -> Tree:
        return abstract_params(self.param_specs())

    def _layers(self, params: Tree):
        """Every layer's params in order: the prefix (dense) layers, then
        views of the stacked ones."""
        for i in range(self.n_prefix):
            yield subtree(params, f"prefix_layers.{i}.")
        yield from unstack(params, "layers.", self.n_scanned)

    # ------------------------------------------------------------------ #
    # forward (train / prefill)
    # ------------------------------------------------------------------ #
    def _embed_inputs(self, params: Tree, batch: Dict[str, torch.Tensor]
                      ) -> torch.Tensor:
        x = embed_tokens(self.cfg, subtree(params, "embed."),
                         batch["tokens"])
        if self.cfg.family == "vlm":
            img = batch["image_embeds"].to(x.dtype)           # (B, Ni, D)
            x = torch.cat([img, x], dim=1)
        return x

    def _train_block(self, lp: Tree, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.cfg
        h = apply_norm(cfg, x, lp, "ln1.")
        if cfg.mla is not None:
            x = x + mla_mod.mla_train(cfg, subtree(lp, "attn."), h)
        else:
            x = x + attention_train(cfg, subtree(lp, "attn."), h)
        h2 = apply_norm(cfg, x, lp, "ln2.")
        ffn = subtree(lp, "ffn.")
        if "router" in ffn:                # MoE layer (prefix layers are dense)
            f, aux = moe_mod.moe_apply(cfg, ffn, h2)
        else:
            f, aux = mlp_apply(cfg, ffn, h2), None
        return shard_hint(x + f, ("batch", "act_seq", "act_embed")), aux

    def _remat_block(self, lp: Tree, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, ...]:
        """``_train_block`` as a tuple of tensors, for ``remat``."""
        x, aux = self._train_block(lp, x)
        return (x,) if aux is None else (x, aux)

    def _head(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(self.cfg, x, params, "final_norm.")
        return lm_head(self.cfg, subtree(params, "embed."), x)

    def forward(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, S_total, V), aux_loss scalar float32)."""
        x = self._embed_inputs(params, batch)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, lp in enumerate(self._layers(params)):
            if self.remat and i >= self.n_prefix:     # the scanned layers
                x, *rest = remat(self._remat_block, lp, x)
                aux = rest[0] if rest else None
            else:
                x, aux = self._train_block(lp, x)
            if aux is not None:
                aux_total = aux_total + aux
        return self._head(params, x), aux_total

    def loss(self, params: Tree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        logits, aux = self.forward(params, batch)
        if self.cfg.family == "vlm":
            logits = logits[:, self.cfg.num_image_tokens:, :]
        # next-token prediction
        return cross_entropy_loss(logits[:, :-1, :],
                                  batch["labels"][:, 1:]) + aux

    # ------------------------------------------------------------------ #
    # decode
    # ------------------------------------------------------------------ #
    def cache_struct(self, batch_size: int, cache_len: int
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        cfg = self.cfg
        if cfg.sliding_window:
            cache_len = min(cache_len, cfg.sliding_window)
        L = cfg.n_layers
        if cfg.mla is not None:
            m = cfg.mla
            return {"ckv": ((L, batch_size, cache_len,
                             m.kv_lora_rank + m.qk_rope_head_dim),
                            CACHE_DTYPE)}
        shape = (L, batch_size, cache_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": (shape, CACHE_DTYPE), "v": (shape, CACHE_DTYPE)}

    def cache_axes(self) -> Dict[str, tuple]:
        """Logical sharding axes of ``cache_struct``'s entries."""
        if self.cfg.mla is not None:
            return {"ckv": ("layers", "batch", "seq", "kv_lora")}
        ax = ("layers", "batch", "seq", "kv_heads", "head_dim")
        return {"k": ax, "v": ax}

    def init_cache(self, batch_size: int, cache_len: int,
                   device: Optional[torch.device] = None) -> Tree:
        return {k: torch.zeros(sh, dtype=dt, device=device)
                for k, (sh, dt) in self.cache_struct(batch_size,
                                                     cache_len).items()}

    def abstract_cache(self, batch_size: int, cache_len: int) -> Tree:
        return self.init_cache(batch_size, cache_len, torch.device("meta"))

    def _decode_block(self, lp: Tree, x: torch.Tensor, cache_l: Tree,
                      pos: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(cfg, x, lp, "ln1.")
        if cfg.mla is not None:
            a, _ = mla_mod.mla_decode(cfg, subtree(lp, "attn."), h,
                                      cache_l["ckv"], pos)
        else:
            a, _, _ = attention_decode(cfg, subtree(lp, "attn."), h,
                                       cache_l["k"], cache_l["v"], pos)
        x = x + a
        h2 = apply_norm(cfg, x, lp, "ln2.")
        ffn = subtree(lp, "ffn.")
        if "router" in ffn:
            return x + moe_mod.moe_apply_token(cfg, ffn, h2)
        return x + mlp_apply(cfg, ffn, h2)

    def decode_step(self, params: Tree, token: torch.Tensor,
                    pos: torch.Tensor, cache: Tree
                    ) -> Tuple[torch.Tensor, Tree]:
        """token (B,) int; pos (B,) absolute position; cache stacked (L, ...).

        Writes this token's k/v (or latent) into ``cache`` in place and
        returns (logits (B, V), cache), the same dict."""
        x = subtree(params, "embed.")["tok"][token]            # (B, D)
        x = shard_hint(x, ("batch", "act_embed"))
        for i, lp in enumerate(self._layers(params)):
            x = self._decode_block(lp, x, {k: c[i] for k, c in cache.items()},
                                   pos)
        return self._head(params, x), cache

    # ------------------------------------------------------------------ #
    # prefill (forward + cache construction)
    # ------------------------------------------------------------------ #
    def _cache_entry(self, lp: Tree, x: torch.Tensor) -> Tree:
        cfg = self.cfg
        h = apply_norm(cfg, x, lp, "ln1.")
        if cfg.mla is not None:
            return {"ckv": mla_mod.mla_prefill_cache(
                cfg, subtree(lp, "attn."), h).to(CACHE_DTYPE)}
        k, v = attention_prefill_kv(cfg, subtree(lp, "attn."), h)
        return {"k": k.to(CACHE_DTYPE), "v": v.to(CACHE_DTYPE)}

    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Tree]:
        """Full-sequence forward that also returns the KV cache:
        (logits (B, S_total, V), cache with S = S_total)."""
        x = self._embed_inputs(params, batch)
        cache: Optional[Tree] = None
        for i, lp in enumerate(self._layers(params)):
            entry = self._cache_entry(lp, x)
            if cache is None:
                cache = {k: e.new_empty((self.cfg.n_layers,) + e.shape)
                         for k, e in entry.items()}
            for k, e in entry.items():
                cache[k][i] = e
            x, _ = self._train_block(lp, x)
        return self._head(params, x), cache
