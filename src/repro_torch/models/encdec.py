"""Whisper-style encoder-decoder transformer backbone (arXiv:2212.04356).

Held against ``repro.models.encdec.EncDecLM``: ``param_specs``,
``init``, ``encode``, ``_embed_dec``, ``forward``, ``loss``,
``cache_struct``, ``init_cache``, ``_cross_attend_step``,
``decode_step`` and ``prefill``. The mel-spectrogram and convolution
front end is a stub, as in the reference: the model takes precomputed
frame embeddings ``batch["frames"]`` (B, encoder_seq, D). The encoder is
non-causal without rope and adds the learned positions (``embed.pos``)
to the frames, which it takes in bfloat16; the decoder is causal with
cross-attention to the encoder's output, its positions the same table,
wrapping ``% n_pos``. Layernorm and the tanh GELU, from the config.

Parameters are a flat dict in the reference's leaf order
(``dec_final_norm.*``, ``decoder.cross_attn.wk``, ..., ``embed.pos``,
``enc_final_norm.*``, ``encoder.attn.wk``, ...); ``encoder.*`` and
``decoder.*`` carry the stacked layer axis and Python loops replace the
reference's ``lax.scan`` (with ``remat``, the default, each layer under
``models.common.remat``, as the reference's). Where a matmul meets
two dtypes (the bfloat16 frames and float32 encoder weights; a bfloat16
encoder's output and float32 cross-attention weights) the activations go
up to the wider one, as jax's type promotion does.

The cache holds the decoder's self-attention keys and values
(``self_k``, ``self_v`` (L, B, S, KV, hd)) and a static cross cache over
the encoder's output (``cross_k``, ``cross_v`` (L, B, encoder_seq, KV,
hd)), all bfloat16. ``decode_step`` writes the new token's k/v into the
cache it is given and returns that same dict.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
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
    embedding_specs,
    lm_head,
    mlp_apply,
    mlp_specs,
)

Tree = Dict[str, torch.Tensor]
CACHE_DTYPE = torch.bfloat16



def _promoted(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x in the dtype jax's ``x @ w`` computes in."""
    return x.to(torch.promote_types(x.dtype, w.dtype))


class EncDecLM:
    def __init__(self, cfg: ArchConfig, remat: bool = True):
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDecLM builds the encdec "
                             f"family, not {cfg.family!r}")
        self.cfg = cfg
        self.remat = remat

    # ------------------------------------------------------------------ #
    def param_specs(self) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        d = cfg.d_model
        enc_layer = {
            **prefixed("ln1.", norm_specs(cfg, d)),
            **prefixed("attn.", attention_specs(cfg)),
            **prefixed("ln2.", norm_specs(cfg, d)),
            **prefixed("mlp.", mlp_specs(cfg)),
        }
        dec_layer = {
            **prefixed("ln1.", norm_specs(cfg, d)),
            **prefixed("self_attn.", attention_specs(cfg)),
            **prefixed("ln_x.", norm_specs(cfg, d)),
            **prefixed("cross_attn.", attention_specs(cfg)),
            **prefixed("ln2.", norm_specs(cfg, d)),
            **prefixed("mlp.", mlp_specs(cfg)),
        }
        specs = {
            **prefixed("embed.", embedding_specs(cfg)),   # learned pos too
            **prefixed("enc_final_norm.", norm_specs(cfg, d)),
            **prefixed("dec_final_norm.", norm_specs(cfg, d)),
            **prefixed("encoder.", stack_specs(cfg.encoder_layers,
                                                enc_layer)),
            **prefixed("decoder.", stack_specs(cfg.n_layers, dec_layer)),
        }
        return in_leaf_order(specs)

    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None) -> Tree:
        return init_params(self.param_specs(), generator, device)

    def abstract_params(self) -> Tree:
        return abstract_params(self.param_specs())

    # ------------------------------------------------------------------ #
    def encode(self, params: Tree, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, S_enc, D): the stub front end's output."""
        cfg = self.cfg
        x = frames.to(torch.bfloat16)
        x = x + params["embed.pos"][:x.shape[1]].to(x.dtype)[None]
        x = shard_hint(x, ("batch", "act_seq", "act_embed"))
        for lp in unstack(params, "encoder.", cfg.encoder_layers):
            if self.remat:
                x, = remat(self._encoder_layer, lp, x)
            else:
                x, = self._encoder_layer(lp, x)
        return apply_norm(cfg, x, params, "enc_final_norm.")

    def _encoder_layer(self, lp: Tree, x: torch.Tensor
                       ) -> Tuple[torch.Tensor]:
        cfg = self.cfg
        attn = subtree(lp, "attn.")
        h = _promoted(apply_norm(cfg, x, lp, "ln1."), attn["wq"])
        x = x + attention_train(cfg, attn, h, causal=False, rope=False)
        h2 = apply_norm(cfg, x, lp, "ln2.")
        return (x + mlp_apply(cfg, subtree(lp, "mlp."), h2),)

    def _embed_dec(self, params: Tree, tokens: torch.Tensor
                   ) -> torch.Tensor:
        x = params["embed.tok"][tokens]
        table = params["embed.pos"]
        # decoder positions wrap for sequences longer than the table
        idx = torch.arange(tokens.shape[1], device=tokens.device) \
            % table.shape[0]
        return x + table[idx][None].to(x.dtype)

    def _decoder_layer(self, lp: Tree, x: torch.Tensor,
                       enc_out: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(cfg, x, lp, "ln1.")
        x = x + attention_train(cfg, subtree(lp, "self_attn."), h,
                                causal=True, rope=False)
        hx = apply_norm(cfg, x, lp, "ln_x.")
        cross = subtree(lp, "cross_attn.")
        x = x + attention_train(cfg, cross, hx, causal=False,
                                kv_x=_promoted(enc_out, cross["wk"]),
                                rope=False)
        h2 = apply_norm(cfg, x, lp, "ln2.")
        return x + mlp_apply(cfg, subtree(lp, "mlp."), h2)

    def _remat_decoder_layer(self, lp: Tree, x: torch.Tensor,
                             enc_out: torch.Tensor) -> Tuple[torch.Tensor]:
        return (self._decoder_layer(lp, x, enc_out),)

    def _head(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(self.cfg, x, params, "dec_final_norm.")
        return lm_head(self.cfg, subtree(params, "embed."), x)

    def forward(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, S, V), a float32 zero: no auxiliary loss)."""
        enc_out = self.encode(params, batch["frames"])
        x = self._embed_dec(params, batch["tokens"])
        x = shard_hint(x, ("batch", "act_seq", "act_embed"))
        for lp in unstack(params, "decoder.", self.cfg.n_layers):
            if self.remat:
                x, = remat(self._remat_decoder_layer, lp, x, enc_out)
            else:
                x = self._decoder_layer(lp, x, enc_out)
        return self._head(params, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    def loss(self, params: Tree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        logits, _ = self.forward(params, batch)
        return cross_entropy_loss(logits[:, :-1, :], batch["labels"][:, 1:])

    # ------------------------------------------------------------------ #
    def cache_struct(self, batch_size: int, cache_len: int
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        cfg = self.cfg
        L, B = cfg.n_layers, batch_size
        kv, hd = cfg.n_kv_heads, cfg.head_dim
        return {
            "self_k": ((L, B, cache_len, kv, hd), CACHE_DTYPE),
            "self_v": ((L, B, cache_len, kv, hd), CACHE_DTYPE),
            "cross_k": ((L, B, cfg.encoder_seq, kv, hd), CACHE_DTYPE),
            "cross_v": ((L, B, cfg.encoder_seq, kv, hd), CACHE_DTYPE),
        }

    def cache_axes(self) -> Dict[str, tuple]:
        kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
        return {"self_k": kv, "self_v": kv, "cross_k": kv, "cross_v": kv}

    def init_cache(self, batch_size: int, cache_len: int,
                   device: Optional[torch.device] = None) -> Tree:
        return {k: torch.zeros(sh, dtype=dt, device=device)
                for k, (sh, dt) in self.cache_struct(batch_size,
                                                     cache_len).items()}

    def abstract_cache(self, batch_size: int, cache_len: int) -> Tree:
        return self.init_cache(batch_size, cache_len, torch.device("meta"))

    def _cross_attend_step(self, cfg: ArchConfig, p: Tree, x: torch.Tensor,
                           ck: torch.Tensor, cv: torch.Tensor
                           ) -> torch.Tensor:
        """Cross-attention for one decoder token; every encoder position
        is valid."""
        B = x.shape[0]
        h, hd = cfg.n_heads, cfg.head_dim
        q = (x @ p["wq"]).reshape(B, h, hd)
        kk = ck.to(q.dtype)
        vv = cv.to(q.dtype)
        scores = torch.einsum("bhd,bshd->bhs", q, kk).to(torch.float32)
        probs = torch.softmax(scores * hd ** -0.5, dim=-1).to(q.dtype)
        out = torch.einsum("bhs,bshd->bhd", probs, vv).reshape(B, h * hd)
        return out @ p["wo"]

    def decode_step(self, params: Tree, token: torch.Tensor,
                    pos: torch.Tensor, cache: Tree
                    ) -> Tuple[torch.Tensor, Tree]:
        """token (B,) int; pos (B,) absolute position. Writes the token's
        self-attention k/v into ``cache`` and returns (logits (B, V),
        cache), the same dict."""
        cfg = self.cfg
        x = params["embed.tok"][token]
        table = params["embed.pos"]
        x = x + table[pos % table.shape[0]].to(x.dtype)
        for i, lp in enumerate(unstack(params, "decoder.",
                                           cfg.n_layers)):
            h = apply_norm(cfg, x, lp, "ln1.")
            a, _, _ = attention_decode(cfg, subtree(lp, "self_attn."), h,
                                       cache["self_k"][i],
                                       cache["self_v"][i], pos)
            x = x + a
            hx = apply_norm(cfg, x, lp, "ln_x.")
            x = x + self._cross_attend_step(
                cfg, subtree(lp, "cross_attn."), hx, cache["cross_k"][i],
                cache["cross_v"][i])
            h2 = apply_norm(cfg, x, lp, "ln2.")
            x = x + mlp_apply(cfg, subtree(lp, "mlp."), h2)
        return self._head(params, x), cache

    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Tree]:
        """Encoder pass and decoder prompt pass: (logits (B, S, V), the
        self-attention and cross caches, bfloat16)."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        x = self._embed_dec(params, batch["tokens"])
        cache: Tree = {}
        L = cfg.n_layers
        for i, lp in enumerate(unstack(params, "decoder.", L)):
            sk, sv = attention_prefill_kv(cfg, subtree(lp, "self_attn."),
                                          apply_norm(cfg, x, lp, "ln1."))
            cross = subtree(lp, "cross_attn.")
            ck, cv = attention_prefill_kv(cfg, cross,
                                          _promoted(enc_out, cross["wk"]))
            for k, v in (("self_k", sk), ("self_v", sv), ("cross_k", ck),
                         ("cross_v", cv)):
                store_layer(cache, k, i, v.to(CACHE_DTYPE), L)
            x = self._decoder_layer(lp, x, enc_out)
        return self._head(params, x), cache
