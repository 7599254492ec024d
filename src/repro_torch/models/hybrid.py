"""Zamba2-style hybrid LM: a Mamba2 backbone and one shared attention + MLP
block run at the start of every ``attn_every``-layer segment
(arXiv:2411.15242).

Held against ``repro.models.hybrid.HybridLM``: ``param_specs``,
``init``, ``forward``, ``loss``, ``cache_struct``, ``init_cache``,
``decode_step`` and ``prefill``. The Mamba layers are a two-level stack,
``segments.*`` (n_segments, per_segment, ...), walked by two Python
loops (the reference's nested ``lax.scan``); with ``remat``, the
default, each segment (the shared block and its Mamba layers) runs
under ``models.common.remat``, as the reference's. The shared block's
weights (``shared_block.*``) are one set of leaves used at every call
site, so autograd sums its gradient over the sites and the datacenter
step quantizes it once. In ``forward`` and ``prefill`` every Mamba layer
starts from a zero state.

The cache holds the attention keys and values per segment (``attn_k``,
``attn_v`` (n_segments, B, S, KV, hd) bfloat16) and the recurrent state
per layer (``ssm`` (n_segments, per_segment, B, H, P, N) float32,
``conv`` (n_segments, per_segment, B, K - 1, conv_dim) bfloat16).
``decode_step`` writes into the cache it is given and returns that same
dict (a leaf whose dtype the step's output does not share, the conv
state under float32 weights, is replaced by a new one of the output's
dtype, as the reference's scan stacks its outputs; the step reads the
old one).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import mamba2
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
    store_layer,
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



class HybridLM:
    def __init__(self, cfg: ArchConfig, remat: bool = True):
        if cfg.family != "hybrid" or cfg.attn_every <= 0 \
                or cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: HybridLM needs the hybrid family "
                             "with n_layers a multiple of attn_every > 0")
        self.cfg = cfg
        self.n_segments = cfg.n_layers // cfg.attn_every
        self.per_segment = cfg.attn_every
        self.remat = remat

    # ------------------------------------------------------------------ #
    def param_specs(self) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        mamba_layer = {**prefixed("ln.", norm_specs(cfg, cfg.d_model)),
                       **prefixed("mamba.", mamba2.mamba_specs(cfg))}
        specs = {
            **prefixed("embed.", embedding_specs(cfg)),
            **prefixed("final_norm.", norm_specs(cfg, cfg.d_model)),
            **prefixed("shared_block.ln1.", norm_specs(cfg, cfg.d_model)),
            **prefixed("shared_block.attn.", attention_specs(cfg)),
            **prefixed("shared_block.ln2.", norm_specs(cfg, cfg.d_model)),
            **prefixed("shared_block.mlp.", mlp_specs(cfg)),
            # two-level stack: (n_segments, per_segment, ...)
            **prefixed("segments.", stack_specs(
                self.n_segments, stack_specs(self.per_segment,
                                             mamba_layer))),
        }
        return in_leaf_order(specs)

    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None) -> Tree:
        return init_params(self.param_specs(), generator, device)

    def abstract_params(self) -> Tree:
        return abstract_params(self.param_specs())

    def _segments(self, params: Tree):
        """Per segment: the per-layer params of its Mamba layers."""
        for seg in unstack(params, "segments.", self.n_segments):
            yield list(unstack(seg, "", self.per_segment))

    def _zero_states(self, B: int, device):
        s, _, H, conv_dim = mamba2.mamba_dims(self.cfg)
        return (torch.zeros((B, H, s.head_dim, s.state_dim),
                            dtype=torch.float32, device=device),
                torch.zeros((B, s.conv_width - 1, conv_dim),
                            dtype=torch.bfloat16, device=device))

    # ------------------------------------------------------------------ #
    def _shared_block_seq(self, sp: Tree, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(cfg, x, sp, "ln1.")
        x = x + attention_train(cfg, subtree(sp, "attn."), h)
        h2 = apply_norm(cfg, x, sp, "ln2.")
        return x + mlp_apply(cfg, subtree(sp, "mlp."), h2)

    def _head(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(self.cfg, x, params, "final_norm.")
        return lm_head(self.cfg, subtree(params, "embed."), x)

    def forward(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, S, V), a float32 zero: no auxiliary loss)."""
        cfg = self.cfg
        x = embed_tokens(cfg, subtree(params, "embed."), batch["tokens"])
        shared = prefixed("shared.", subtree(params, "shared_block."))
        for seg in self._segments(params):
            # one segment's params as one flat dict: the shared block's
            # and its Mamba layers' (``<i>.<name>``)
            seg_p = {**shared, **{f"{i}.{k}": v for i, lp in enumerate(seg)
                                  for k, v in lp.items()}}
            if self.remat:
                x, = remat(self._segment_seq, seg_p, x)
            else:
                x, = self._segment_seq(seg_p, x)
        return self._head(params, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    def _segment_seq(self, seg_p: Tree, x: torch.Tensor
                     ) -> Tuple[torch.Tensor]:
        """The shared block, then the segment's Mamba layers from zero
        states (training forward)."""
        cfg = self.cfg
        zero_ssm, zero_conv = self._zero_states(x.shape[0], x.device)
        x = self._shared_block_seq(subtree(seg_p, "shared."), x)
        for i in range(self.per_segment):
            lp = subtree(seg_p, f"{i}.")
            h = apply_norm(cfg, x, lp, "ln.")
            out, _, _ = mamba2.mamba_seq(cfg, subtree(lp, "mamba."), h,
                                         zero_ssm, zero_conv)
            x = x + out
        return (shard_hint(x, ("batch", "act_seq", "act_embed")),)

    def loss(self, params: Tree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        logits, _ = self.forward(params, batch)
        return cross_entropy_loss(logits[:, :-1, :], batch["labels"][:, 1:])

    # ------------------------------------------------------------------ #
    def cache_struct(self, batch_size: int, cache_len: int
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        cfg = self.cfg
        s, _, H, conv_dim = mamba2.mamba_dims(cfg)
        NSEG, PER, B = self.n_segments, self.per_segment, batch_size
        kv = (NSEG, B, cache_len, cfg.n_kv_heads, cfg.head_dim)
        return {
            "attn_k": (kv, CACHE_DTYPE),
            "attn_v": (kv, CACHE_DTYPE),
            "ssm": ((NSEG, PER, B, H, s.head_dim, s.state_dim),
                    torch.float32),
            "conv": ((NSEG, PER, B, s.conv_width - 1, conv_dim),
                     CACHE_DTYPE),
        }

    def cache_axes(self) -> Dict[str, tuple]:
        kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
        return {
            "attn_k": kv,
            "attn_v": kv,
            "ssm": ("layers", None, "batch", "heads", "head_dim", None),
            "conv": ("layers", None, "batch", None, "ssm_fused"),
        }

    def init_cache(self, batch_size: int, cache_len: int,
                   device: Optional[torch.device] = None) -> Tree:
        return {k: torch.zeros(sh, dtype=dt, device=device)
                for k, (sh, dt) in self.cache_struct(batch_size,
                                                     cache_len).items()}

    def abstract_cache(self, batch_size: int, cache_len: int) -> Tree:
        return self.init_cache(batch_size, cache_len, torch.device("meta"))

    def decode_step(self, params: Tree, token: torch.Tensor,
                    pos: torch.Tensor, cache: Tree
                    ) -> Tuple[torch.Tensor, Tree]:
        """token (B,) int; pos (B,) absolute position. Writes this
        token's k/v and the new recurrent states into ``cache`` and
        returns (logits (B, V), cache), the same dict."""
        cfg = self.cfg
        src = dict(cache)                  # the leaves the step reads
        x = params["embed.tok"][token]
        shared = subtree(params, "shared_block.")
        for s, seg in enumerate(self._segments(params)):
            h = apply_norm(cfg, x, shared, "ln1.")
            a, _, _ = attention_decode(cfg, subtree(shared, "attn."), h,
                                       cache["attn_k"][s],
                                       cache["attn_v"][s], pos)
            x = x + a
            h2 = apply_norm(cfg, x, shared, "ln2.")
            x = x + mlp_apply(cfg, subtree(shared, "mlp."), h2)
            for i, lp in enumerate(seg):
                h_in = apply_norm(cfg, x, lp, "ln.")
                out, new_ssm, new_conv = mamba2.mamba_step(
                    cfg, subtree(lp, "mamba."), h_in, src["ssm"][s, i],
                    src["conv"][s, i])
                x = x + out
                store_layer(cache, "ssm", (s, i), new_ssm)
                store_layer(cache, "conv", (s, i), new_conv)
        return self._head(params, x), cache

    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Tree]:
        """Prompt forward: (logits (B, S, V), the attention k/v per segment
        in bfloat16 and every layer's recurrent state after the prompt)."""
        cfg = self.cfg
        x = embed_tokens(cfg, subtree(params, "embed."), batch["tokens"])
        zero_ssm, zero_conv = self._zero_states(x.shape[0], x.device)
        shared = subtree(params, "shared_block.")
        n, cache = self.n_segments, {}
        for s, seg in enumerate(self._segments(params)):
            k, v = attention_prefill_kv(cfg, subtree(shared, "attn."),
                                        apply_norm(cfg, x, shared, "ln1."))
            store_layer(cache, "attn_k", s, k.to(CACHE_DTYPE), n)
            store_layer(cache, "attn_v", s, v.to(CACHE_DTYPE), n)
            x = self._shared_block_seq(shared, x)
            for i, lp in enumerate(seg):
                h_in = apply_norm(cfg, x, lp, "ln.")
                out, ssm_st, conv_st = mamba2.mamba_seq(
                    cfg, subtree(lp, "mamba."), h_in, zero_ssm, zero_conv)
                x = x + out
                lead = (n, self.per_segment)
                store_layer(cache, "ssm", (s, i), ssm_st, lead)
                store_layer(cache, "conv", (s, i), conv_st, lead)
        return self._head(params, x), cache
