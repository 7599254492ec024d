"""Embeddings, grouped-query attention (full-sequence, query-chunked and
decode against a KV cache) and MLPs of the transformer families.

Held against ``repro.models.layers``: ``embedding_specs``,
``embed_tokens``, ``lm_head``, ``attention_specs``, ``_project_qkv``,
``_attend_full``, ``_causal_bias``, ``attend`` (both paths),
``attention_train``, ``attention_prefill_kv``, ``attention_decode``,
``mlp_specs`` and ``mlp_apply``. Functions take a flat params dict of
one component (``{"wq": ..., "wk": ...}``), as the reference's take its
sub-dict. Layouts are the reference's (weights (in, out), activations
(batch, seq, ...), the cache (batch, seq, kv_heads, head_dim)), so
weights and caches carry across unchanged.

Dtype flow follows the reference: projections run in the parameters'
dtype; attention scores are cast to float32, scaled and masked there,
and the softmax probabilities cast back; the rope tables are float32.

Above ``CHUNKED_ATTN_THRESHOLD`` query tokens ``attend`` takes the
query-chunked path: chunks of ``gcd(sq, Q_CHUNK)`` queries, each against
every key, in a Python loop (the reference's ``lax.map``) writing into
one output, so no (sq, skv) score matrix exists at once.

``attention_train`` is self- or cross-attention (``kv_x``: the keys
and values come from another sequence, the encoder's output), causal or
not, with or without rope, as the reference's. The learned position
table ``pos`` (``max(encoder_seq, 4096)`` rows) is part of the
embeddings when ``cfg.pos_emb == "learned"`` (the encoder-decoder
family).

``attention_decode`` writes the new token's k/v into the cache it is
given, in place, and returns that same cache (the reference returns an
updated copy); with a sliding window the cache is a ring buffer.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (
    ParamSpec,
    activation,
    apply_rope,
    apply_rope_at,
    rope_tables,
    shard_hint,
)

Tree = Dict[str, torch.Tensor]
NEG_INF = -1e30
# query-chunked attention kicks in above this sequence length
CHUNKED_ATTN_THRESHOLD = 8192
Q_CHUNK = 512


# --------------------------------------------------------------------------- #
# Embeddings
# --------------------------------------------------------------------------- #
def embedding_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    s = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          "embed", scale=0.02)}
    if not cfg.tie_embeddings:
        s["head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                              ("embed", "vocab"), "normal")
    if cfg.pos_emb == "learned":
        # sized generously; decode indexes by absolute position
        s["pos"] = ParamSpec((max(cfg.encoder_seq, 4096), cfg.d_model),
                             (None, "embed"), "embed", scale=0.02)
    return s


def embed_tokens(cfg: ArchConfig, p: Tree, tokens: torch.Tensor
                 ) -> torch.Tensor:
    x = F.embedding(tokens, p["tok"])
    return shard_hint(x, ("batch", "act_seq", "act_embed"))


def lm_head(cfg: ArchConfig, p: Tree, x: torch.Tensor) -> torch.Tensor:
    w = p["tok"].t() if cfg.tie_embeddings else p["head"]
    return x @ w


# --------------------------------------------------------------------------- #
# Attention
# --------------------------------------------------------------------------- #
def attention_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, h * hd), ("embed", "heads_fused"), "normal"),
        "wk": ParamSpec((d, kv * hd), ("embed", "kv_fused"), "normal"),
        "wv": ParamSpec((d, kv * hd), ("embed", "kv_fused"), "normal"),
        "wo": ParamSpec((h * hd, d), ("heads_fused", "embed"), "normal"),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((h * hd,), ("heads_fused",), "zeros")
        s["bk"] = ParamSpec((kv * hd,), ("kv_fused",), "zeros")
        s["bv"] = ParamSpec((kv * hd,), ("kv_fused",), "zeros")
    return s


def _project_qkv(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                 kv_x: torch.Tensor):
    B, S, Skv = x.shape[0], x.shape[1], kv_x.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = kv_x @ p["wk"]
    v = kv_x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, h, hd), k.reshape(B, Skv, kv, hd),
            v.reshape(B, Skv, kv, hd))


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


def _causal_bias(sq: int, skv: int, q_offset: int, window: int,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return torch.where(m, 0.0, NEG_INF).to(torch.float32)


def _attend_chunked(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int, window: int
                    ) -> torch.Tensor:
    """The query-chunked path: qg (B,Sq,KV,G,hd) in chunks of
    gcd(Sq, Q_CHUNK) queries (VLM prefixes make Sq irregular), each
    against every key. Returns (B,Sq,KV,G,hd_v)."""
    B, sq, kv, groups, _ = qg.shape
    qc_len = math.gcd(sq, Q_CHUNK)
    if qc_len < 16:
        raise ValueError(f"{sq} query tokens split into chunks of {qc_len} "
                         f"(gcd with Q_CHUNK {Q_CHUNK}); the reference "
                         "asserts at least 16")
    out = torch.empty(B, sq, kv, groups, v.shape[-1], device=qg.device,
                      dtype=torch.promote_types(qg.dtype, v.dtype))
    for start in range(0, sq, qc_len):
        bias = (_causal_bias(qc_len, k.shape[1], q_offset + start, window,
                             qg.device) if causal else None)
        out[:, start:start + qc_len] = _attend_full(
            qg[:, start:start + qc_len], k, v, bias)
    return out


def attend(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, *, causal: bool, q_offset: int = 0
           ) -> torch.Tensor:
    """Dispatch between full and query-chunked attention.

    q (B,Sq,H,hd); k,v (B,Skv,KV,hd). Returns (B,Sq,H,hd_v) (hd_v may
    differ from hd: MLA's qk 192, v 128)."""
    B, sq, H, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(B, sq, kv, H // kv, hd)
    if sq <= CHUNKED_ATTN_THRESHOLD:
        bias = (_causal_bias(sq, k.shape[1], q_offset, cfg.sliding_window,
                             q.device) if causal else None)
        out = _attend_full(qg, k, v, bias)
    else:
        out = _attend_chunked(qg, k, v, causal=causal, q_offset=q_offset,
                              window=cfg.sliding_window)
    return out.reshape(B, sq, H, v.shape[-1])


def attention_train(cfg: ArchConfig, p: Tree, x: torch.Tensor, *,
                    causal: bool = True,
                    kv_x: Optional[torch.Tensor] = None,
                    rope: bool = True,
                    q_offset: int = 0) -> torch.Tensor:
    """Full-sequence attention for training and prefill: self-attention,
    or cross-attention to ``kv_x`` (B, Skv, D)."""
    q, k, v = _project_qkv(cfg, p, x, x if kv_x is None else kv_x)
    if rope and cfg.pos_emb == "rope":
        cos, sin = rope_tables(q.shape[1], cfg.head_dim, cfg.rope_theta,
                               offset=q_offset, device=x.device)
        q = apply_rope(q, cos, sin)
        cos, sin = rope_tables(k.shape[1], cfg.head_dim, cfg.rope_theta,
                               device=x.device)
        k = apply_rope(k, cos, sin)
    q = shard_hint(q, ("batch", "seq", "heads", "head_dim"))
    k = shard_hint(k, ("batch", "seq", "kv_heads", "head_dim"))
    out = attend(cfg, q, k, v, causal=causal, q_offset=q_offset)
    out = out.reshape(x.shape[0], x.shape[1], cfg.n_heads * cfg.head_dim)
    return shard_hint(out @ p["wo"], ("batch", "act_seq", "act_embed"))


def attention_prefill_kv(cfg: ArchConfig, p: Tree, x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The roped (k, v) pair for cache construction during prefill."""
    _, k, v = _project_qkv(cfg, p, x, x)
    if cfg.pos_emb == "rope":
        cos, sin = rope_tables(k.shape[1], cfg.head_dim, cfg.rope_theta,
                               device=x.device)
        k = apply_rope(k, cos, sin)
    return k, v


def write_cache(cache: torch.Tensor, slot: torch.Tensor,
                entry: torch.Tensor) -> None:
    """cache[b, slot[b]] = entry[b], in place. A slot past the cache's end
    leaves the cache as it is (the reference's scatter drops such a
    write); no host sync."""
    B, S = cache.shape[0], cache.shape[1]
    rows = torch.arange(B, device=cache.device)
    inside = (slot < S).reshape((B,) + (1,) * (entry.dim() - 1))
    idx = slot.clamp(max=S - 1)
    cache[rows, idx] = torch.where(inside, entry.to(cache.dtype),
                                   cache[rows, idx])


def attention_decode(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a KV cache.

    x (B, D); cache_k/v (B, S_cache, KV, hd), written in place at each
    row's slot and returned; pos (B,) absolute positions. With a sliding
    window the cache is a ring buffer of length window: the slot is
    pos % S_cache and the first min(pos + 1, S_cache) slots are valid.
    Returns (y (B, D), cache_k, cache_v)."""
    B = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cache_len = cache_k.shape[1]
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, h, hd)
    k = k.reshape(B, kv, hd)
    v = v.reshape(B, kv, hd)
    if cfg.pos_emb == "rope":
        q = apply_rope_at(q, pos, hd, cfg.rope_theta)
        k = apply_rope_at(k, pos, hd, cfg.rope_theta)

    slot = pos % cache_len if cfg.sliding_window else pos
    write_cache(cache_k, slot, k)
    write_cache(cache_v, slot, v)
    cache_axes = ("batch", "seq", "kv_heads", "head_dim")
    cache_k = shard_hint(cache_k, cache_axes)
    cache_v = shard_hint(cache_v, cache_axes)

    qg = shard_hint(q.reshape(B, kv, h // kv, hd),
                    ("batch", "kv_heads", None, "head_dim"))
    kk = shard_hint(cache_k.to(q.dtype), cache_axes)        # (B, S, KV, hd)
    vv = shard_hint(cache_v.to(q.dtype), cache_axes)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, kk).to(torch.float32)
    scores = scores * (hd ** -0.5)
    kpos = torch.arange(cache_len, device=x.device)[None, :]
    if cfg.sliding_window:
        valid = kpos < torch.clamp(pos + 1, max=cache_len)[:, None]
    else:
        valid = kpos <= pos[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, vv).reshape(B, h * hd)
    return out @ p["wo"], cache_k, cache_v


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #
def mlp_specs(cfg: ArchConfig, d_ff: Optional[int] = None
              ) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.glu:
        return {
            "wi_gate": ParamSpec((d, f), ("embed", "d_ff"), "normal"),
            "wi_up": ParamSpec((d, f), ("embed", "d_ff"), "normal"),
            "wo": ParamSpec((f, d), ("d_ff", "embed"), "normal"),
        }
    return {
        "wi": ParamSpec((d, f), ("embed", "d_ff"), "normal"),
        "wo": ParamSpec((f, d), ("d_ff", "embed"), "normal"),
    }


def mlp_apply(cfg: ArchConfig, p: Tree, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.mlp_act)
    if cfg.glu:
        h = act(x @ p["wi_gate"]) * (x @ p["wi_up"])
    else:
        h = act(x @ p["wi"])
    h = shard_hint(h, ("batch", "seq", "act_ff")) if h.dim() == 3 else h
    return h @ p["wo"]
