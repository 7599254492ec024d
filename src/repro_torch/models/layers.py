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

Under a tensor-parallel context (``models.tensor_parallel``; every
language model opens it) the embedding is vocab-parallel, wq /
wk / wv (and their biases), wi, wi_gate and wi_up are column-parallel,
both ``wo`` are row-parallel and ``lm_head`` is column-parallel over the
vocabulary: each function computes on the rank's shards, which it reads
from the weights' local shapes. A projection whose fused dim cuts a head
is gathered; the decode cache is split as the rule table says, over kv
heads, over ``head_dim`` (scores are then partial dot products, summed
over 'model' before the softmax) or not at all. Cross-attention reads
its keys and values from an input every rank holds whole
(``tp.whole_input``: the encoder's output, made whole once by its
producer so that its gradient is the sum of the ranks' parts), through
wk and wv split over 'model'. A block's
input is ``block_input``: the norm of the residual stream, or under a
context the stream with its norm (``tensor_parallel.Enter``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.common import (
    ParamSpec,
    activation,
    apply_norm,
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


def embed_tokens(cfg: ArchConfig, p: Tree, tokens: torch.Tensor,
                 prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The token embeddings (B, S, D), after the rows ``prefix`` (B, P, D)
    when given; under tensor parallelism in the residual stream's layout
    (``tensor_parallel.embed``)."""
    x = tp.embed(p["tok"], tokens, cfg.vocab_size, prefix)
    return shard_hint(x, ("batch", "act_seq", "act_embed"))


def lm_head(cfg: ArchConfig, p: Tree, x) -> torch.Tensor:
    """Logits of ``x`` (the final norm's output, or under tensor
    parallelism the ``tp.Enter`` of the stream); the rank's slice of the
    vocabulary when the head is vocab-parallel."""
    w = p["tok"].t() if cfg.tie_embeddings else p["head"]
    return tp.column(_entered(x), w, None, cfg.vocab_size)[0]


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


def block_input(cfg: ArchConfig, x: torch.Tensor, p: Tree, prefix: str,
                dtype: Optional[torch.dtype] = None, whole: bool = False):
    """A block's input: ``norm(x)`` with the norm's leaves ``p[prefix +
    ...]`` (raised to the type jax's ``norm(x) @ w`` computes in for a
    weight of ``dtype``), or under tensor parallelism the residual stream
    with that norm (``tensor_parallel.Enter``; ``whole``: x is whole on
    every rank), which the layers take in its place."""
    keys = [k for k in p if k.startswith(prefix)]

    def norm(t, wrap):
        h = apply_norm(cfg, t, {k: wrap(p[k]) for k in keys}, prefix)
        return h if dtype is None else h.to(torch.promote_types(h.dtype,
                                                                dtype))
    if tp.active() is None:
        return norm(x, lambda t: t)
    return tp.Enter(x, norm, whole)


def _entered(x) -> "tp.Enter":
    """A layer's input under tensor parallelism: the ``tp.Enter`` a
    ``DecoderLM`` block hands it, or a tensor taken as it is."""
    return x if isinstance(x, tp.Enter) else tp.Enter(x)


def _project_qkv_tp(cfg: ArchConfig, p: Tree, xe: "tp.Enter",
                    kv_e: Optional["tp.Enter"] = None):
    """q, k, v from the rank's column shards (or whole weights), each as
    (fused features, whether they are the rank's slice); k and v from
    ``kv_e`` where given (cross-attention)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bias = cfg.qkv_bias
    kv_e = xe if kv_e is None else kv_e
    return (tp.column(xe, p["wq"], p["bq"] if bias else None, h * hd),
            tp.column(kv_e, p["wk"], p["bk"] if bias else None, kv * hd),
            tp.column(kv_e, p["wv"], p["bv"] if bias else None, kv * hd))


def _heads(t: torch.Tensor, hd: int) -> torch.Tensor:
    """(..., n * hd) fused features as (..., n, hd)."""
    return t.reshape(tuple(t.shape[:-1]) + (t.shape[-1] // hd, hd))


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
    or cross-attention to ``kv_x`` (B, Skv, D; under tensor parallelism
    a ``tp.Whole``, ``tp.whole_input``'s)."""
    if tp.active() is not None:
        return _attention_tp(cfg, p, _entered(x), causal=causal,
                             rope=rope, q_offset=q_offset, kv_e=kv_x)
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


def _attention_tp(cfg: ArchConfig, p: Tree, x: "tp.Enter", *,
                  causal: bool, rope: bool, q_offset: int,
                  kv_e: Optional["tp.Enter"] = None) -> torch.Tensor:
    """Self- or cross-attention on the rank's shards. When the rank's q
    columns are whole heads it attends them against their kv heads (the
    rank's own, or those cut out of the gathered kv projections);
    otherwise it gathers q, k and v, attends every head and hands ``wo``
    the rank's slice."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    (q, qs), (k, ks), (v, vs) = _project_qkv_tp(cfg, p, x, kv_e)
    heads = tp.head_range(h, kv) if qs and ks and vs else None
    if heads is not None:
        lo, hi = heads
        if kv % tp.active().size:
            k = tp.gather_sum(k, -1)[..., lo * hd:hi * hd]
            v = tp.gather_sum(v, -1)[..., lo * hd:hi * hd]
    else:
        q, k, v = (tp.gather(t, -1) if s else t
                   for t, s in ((q, qs), (k, ks), (v, vs)))
    q, k, v = _heads(q, hd), _heads(k, hd), _heads(v, hd)
    if rope and cfg.pos_emb == "rope":
        cos, sin = rope_tables(q.shape[1], hd, cfg.rope_theta,
                               offset=q_offset, device=q.device)
        q = apply_rope(q, cos, sin)
        cos, sin = rope_tables(k.shape[1], hd, cfg.rope_theta,
                               device=q.device)
        k = apply_rope(k, cos, sin)
    out = attend(cfg, q, k, v, causal=causal, q_offset=q_offset)
    out = out.reshape(q.shape[0], q.shape[1], q.shape[2] * hd)
    return shard_hint(tp.row(out, p["wo"], h * hd, heads is not None),
                      ("batch", "act_seq", "act_embed"))


def attention_prefill_kv(cfg: ArchConfig, p: Tree, x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The roped (k, v) pair for cache construction during prefill; under
    tensor parallelism the rank's part of it as the rule table splits the
    cache."""
    if tp.active() is not None:
        return _prefill_kv_tp(cfg, p, _entered(x))
    _, k, v = _project_qkv(cfg, p, x, x)
    if cfg.pos_emb == "rope":
        cos, sin = rope_tables(k.shape[1], cfg.head_dim, cfg.rope_theta,
                               device=x.device)
        k = apply_rope(k, cos, sin)
    return k, v


def _prefill_kv_tp(cfg: ArchConfig, p: Tree, x: "tp.Enter"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    _, (k, ks), (v, vs) = _project_qkv_tp(cfg, p, x)
    where = tp.cache_split(kv, hd)
    own_heads = where == "kv_heads" and ks and vs
    if not own_heads:
        k = tp.gather(k, -1) if ks else k
        v = tp.gather(v, -1) if vs else v
    k, v = _heads(k, hd), _heads(v, hd)
    if cfg.pos_emb == "rope":
        cos, sin = rope_tables(k.shape[1], hd, cfg.rope_theta,
                               device=k.device)
        k = apply_rope(k, cos, sin)
    if where == "head_dim":
        return tp.split(k, -1), tp.split(v, -1)
    if where == "kv_heads" and not own_heads:
        return tp.split(k, -2), tp.split(v, -2)
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
    if tp.active() is not None:
        return _attention_decode_tp(cfg, p, _entered(x), cache_k, cache_v,
                                    pos)
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
    out = _decode_attend(cfg, qg, kk, vv, pos).reshape(B, h * hd)
    return out @ p["wo"], cache_k, cache_v


def _decode_attend(cfg: ArchConfig, qg: torch.Tensor, kk: torch.Tensor,
                   vv: torch.Tensor, pos: torch.Tensor,
                   partial: bool = False) -> torch.Tensor:
    """One query a row against the cache: qg (B, KV, G, d), kk / vv (B,
    S, KV, d) -> (B, KV, G, d). ``partial``: d is the rank's slice of
    head_dim, and the scores are summed over 'model' before the
    softmax."""
    cache_len = kk.shape[1]
    scores = torch.einsum("bkgd,bskd->bkgs", qg, kk).to(torch.float32)
    if partial:
        scores = tp.reduce_out(scores)
    scores = scores * (cfg.head_dim ** -0.5)
    kpos = torch.arange(cache_len, device=qg.device)[None, :]
    if cfg.sliding_window:
        valid = kpos < torch.clamp(pos + 1, max=cache_len)[:, None]
    else:
        valid = kpos <= pos[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(qg.dtype)
    return torch.einsum("bkgs,bskd->bkgd", probs, vv)


def _attention_decode_tp(cfg: ArchConfig, p: Tree, x: "tp.Enter",
                         cache_k: torch.Tensor, cache_v: torch.Tensor,
                         pos: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``attention_decode`` on the rank's shards and its part of the cache:
    over kv heads, the rank's q and kv heads attend as a whole model's
    would; over head_dim, q, k and v are gathered and roped whole, the
    rank keeps its head_dim slice, the partial scores are summed over
    'model', and the rank's slices of every head's output are gathered
    for ``wo``; a whole cache attends whole."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    (q, qs), (k, ks), (v, vs) = _project_qkv_tp(cfg, p, x)
    B = q.shape[0]
    where = tp.cache_split(kv, hd)
    own_heads = where == "kv_heads" and qs and ks and vs
    if where == "kv_heads" and not own_heads:
        raise NotImplementedError(
            f"{cfg.name}: a cache split over kv heads needs wq, wk and wv "
            "split over 'model' too")
    if not own_heads:
        q, k, v = (tp.gather(t, -1) if s else t
                   for t, s in ((q, qs), (k, ks), (v, vs)))
    q, k, v = _heads(q, hd), _heads(k, hd), _heads(v, hd)
    if cfg.pos_emb == "rope":
        q = apply_rope_at(q, pos, hd, cfg.rope_theta)
        k = apply_rope_at(k, pos, hd, cfg.rope_theta)
    if where == "head_dim":
        q, k, v = tp.split(q, -1), tp.split(k, -1), tp.split(v, -1)
    slot = pos % cache_k.shape[1] if cfg.sliding_window else pos
    write_cache(cache_k, slot, k)
    write_cache(cache_v, slot, v)
    n_kv = k.shape[1]
    qg = q.reshape(B, n_kv, q.shape[1] // n_kv, q.shape[2])
    out = _decode_attend(cfg, qg, cache_k.to(q.dtype), cache_v.to(q.dtype),
                         pos, partial=where == "head_dim")
    if where == "head_dim":
        out = tp.gather(out, -1)
    out = out.reshape(B, -1)
    return tp.row(out, p["wo"], h * hd, own_heads), cache_k, cache_v


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


def mlp_apply(cfg: ArchConfig, p: Tree, x: torch.Tensor,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """The MLP; ``d_ff`` is its hidden width when it is not ``cfg.d_ff``
    (MoE shared experts, dense prefix layers), which tensor parallelism
    needs to tell a shard from a whole weight."""
    act = activation(cfg.mlp_act)
    if tp.active() is not None:
        return _mlp_tp(cfg, p, _entered(x), act, d_ff or cfg.d_ff)
    if cfg.glu:
        h = act(x @ p["wi_gate"]) * (x @ p["wi_up"])
    else:
        h = act(x @ p["wi"])
    h = shard_hint(h, ("batch", "seq", "act_ff")) if h.dim() == 3 else h
    return h @ p["wo"]


def _mlp_tp(cfg: ArchConfig, p: Tree, xe: "tp.Enter", act, f: int
            ) -> torch.Tensor:
    """The MLP of hidden width ``f`` on the rank's slice of it (wi /
    wi_gate / wi_up column-parallel, wo row-parallel), in the residual
    stream's layout; with 'act_ff' off 'model' the hidden activation is
    made whole first."""
    if cfg.glu:
        g, gs = tp.column(xe, p["wi_gate"], None, f)
        u, us = tp.column(xe, p["wi_up"], None, f)
        if gs != us:
            raise NotImplementedError("wi_gate and wi_up laid out apart")
        h = act(g) * u
    else:
        h, gs = tp.column(xe, p["wi"], None, f)
        h = act(h)
    if gs and not tp.hinted("act_ff"):
        h, gs = tp.gather(h, -1), False
    return tp.row(h, p["wo"], f, gs)
