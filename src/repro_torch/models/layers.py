"""Embeddings, grouped-query attention and MLPs of the transformer
families.

Held against ``repro.models.layers``: ``embedding_specs``,
``embed_tokens``, ``lm_head``, ``attention_specs``, ``_project_qkv``,
``_attend_full``, ``_causal_bias``, ``attend`` (the full path),
``attention_train``, ``mlp_specs`` and ``mlp_apply``. Functions take a
flat params dict of one component (``{"wq": ..., "wk": ...}``), as the
reference's take its sub-dict. Layouts are the reference's (weights
(in, out), activations (batch, seq, ...)), so weights carry across
unchanged.

Dtype flow follows the reference: projections run in the parameters'
dtype; attention scores are cast to float32, scaled and masked there,
and the softmax probabilities cast back; the rope tables are float32.

Not ported yet: the query-chunked attention path (sequences above
``CHUNKED_ATTN_THRESHOLD`` tokens raise), cross-attention and query
offsets, decode and prefill with a KV cache, learned position
embeddings.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (
    ParamSpec,
    activation,
    apply_rope,
    rope_tables,
)

Tree = Dict[str, torch.Tensor]
NEG_INF = -1e30
# the reference switches to query-chunked attention above this length
CHUNKED_ATTN_THRESHOLD = 8192


# --------------------------------------------------------------------------- #
# Embeddings
# --------------------------------------------------------------------------- #
def embedding_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    s = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), "embed",
                          scale=0.02)}
    if not cfg.tie_embeddings:
        s["head"] = ParamSpec((cfg.d_model, cfg.vocab_size), "normal")
    return s


def embed_tokens(cfg: ArchConfig, p: Tree, tokens: torch.Tensor
                 ) -> torch.Tensor:
    return F.embedding(tokens, p["tok"])


def lm_head(cfg: ArchConfig, p: Tree, x: torch.Tensor) -> torch.Tensor:
    w = p["tok"].t() if cfg.tie_embeddings else p["head"]
    return x @ w


# --------------------------------------------------------------------------- #
# Attention
# --------------------------------------------------------------------------- #
def attention_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, h * hd), "normal"),
        "wk": ParamSpec((d, kv * hd), "normal"),
        "wv": ParamSpec((d, kv * hd), "normal"),
        "wo": ParamSpec((h * hd, d), "normal"),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((h * hd,), "zeros")
        s["bk"] = ParamSpec((kv * hd,), "zeros")
        s["bv"] = ParamSpec((kv * hd,), "zeros")
    return s


def _project_qkv(cfg: ArchConfig, p: Tree, x: torch.Tensor):
    B, S = x.shape[0], x.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, h, hd), k.reshape(B, S, kv, hd),
            v.reshape(B, S, kv, hd))


def _attend_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask_bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped-query attention without materializing repeated KV.

    q (B,Sq,KV,G,hd); k/v (B,Skv,KV,hd); mask_bias (Sq,Skv) or None.
    Returns (B,Sq,KV,G,hd).
    """
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).to(torch.float32) \
        * scale
    if mask_bias is not None:
        scores = scores + mask_bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def _causal_bias(sq: int, skv: int, window: int,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return torch.where(m, 0.0, NEG_INF).to(torch.float32)


def attend(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """q (B,Sq,H,hd); k,v (B,Skv,KV,hd). Returns (B,Sq,H,hd_v)."""
    B, sq, H, hd = q.shape
    kv = k.shape[2]
    if sq > CHUNKED_ATTN_THRESHOLD:
        raise NotImplementedError(
            f"{sq} query tokens: the query-chunked attention path (above "
            f"{CHUNKED_ATTN_THRESHOLD}) is not ported yet")
    qg = q.reshape(B, sq, kv, H // kv, hd)
    bias = (_causal_bias(sq, k.shape[1], cfg.sliding_window, q.device)
            if causal else None)
    out = _attend_full(qg, k, v, bias)
    return out.reshape(B, sq, H, v.shape[-1])


def attention_train(cfg: ArchConfig, p: Tree, x: torch.Tensor
                    ) -> torch.Tensor:
    """Causal full-sequence self-attention for training."""
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.pos_emb == "rope":
        cos, sin = rope_tables(x.shape[1], cfg.head_dim, cfg.rope_theta,
                               device=x.device)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = attend(cfg, q, k, v, causal=True)
    out = out.reshape(x.shape[0], x.shape[1], cfg.n_heads * cfg.head_dim)
    return out @ p["wo"]


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #
def mlp_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.glu:
        return {
            "wi_gate": ParamSpec((d, f), "normal"),
            "wi_up": ParamSpec((d, f), "normal"),
            "wo": ParamSpec((f, d), "normal"),
        }
    return {
        "wi": ParamSpec((d, f), "normal"),
        "wo": ParamSpec((f, d), "normal"),
    }


def mlp_apply(cfg: ArchConfig, p: Tree, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.mlp_act)
    if cfg.glu:
        h = act(x @ p["wi_gate"]) * (x @ p["wi_up"])
    else:
        h = act(x @ p["wi"])
    return h @ p["wo"]
