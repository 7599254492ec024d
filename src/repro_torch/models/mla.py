"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434).

Held against ``repro.models.mla``: ``mla_specs``, ``_latent``,
``mla_train``, ``mla_prefill_cache`` and ``mla_decode``. Train and
prefill use the expanded formulation; decode uses the *absorbed* one,
attending directly in the latent space, so the KV cache per token is
``kv_lora_rank + qk_rope_head_dim`` values. ``mla_decode`` writes the
new token's latent into the cache it is given, in place, and returns
that same cache.

Under a tensor-parallel context (``models.tensor_parallel``) each rank
attends its heads: wq, w_uk and w_uv are its column shards, wo its row
shard; the latent (w_dkv, kv_norm: replicated) is computed whole and
enters the rank's columns through ``copy_in``. Where the shards cut a
head, the projections are gathered (in decode, w_uk and w_uv), every
head attended and the output split before ``wo``. The latent cache is
whole on every rank.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.common import (
    ParamSpec,
    apply_rope,
    apply_rope_at,
    rms_norm,
    rope_tables,
    shard_hint,
)
from repro_torch.models.layers import NEG_INF, _entered, attend, write_cache

Tree = Dict[str, torch.Tensor]


def mla_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": ParamSpec((d, h * qd), ("embed", "heads_fused"), "normal"),
        "w_dkv": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                           ("embed", "kv_lora"), "normal"),
        "kv_norm": ParamSpec((m.kv_lora_rank,), ("kv_lora",), "ones"),
        "w_uk": ParamSpec((m.kv_lora_rank, h * m.qk_nope_head_dim),
                          ("kv_lora", "heads_fused"), "normal"),
        "w_uv": ParamSpec((m.kv_lora_rank, h * m.v_head_dim),
                          ("kv_lora", "heads_fused"), "normal"),
        "wo": ParamSpec((h * m.v_head_dim, d), ("heads_fused", "embed"),
                        "normal"),
    }


def _latent(cfg: ArchConfig, p: Tree, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (c_kv (B,S,R) normed, k_rope (B,S,rope))."""
    R = cfg.mla.kv_lora_rank
    dkv = x @ p["w_dkv"]
    return rms_norm(dkv[..., :R], p["kv_norm"]), dkv[..., R:]


def _heads(cfg: ArchConfig, p: Tree, xe: "tp.Enter"):
    """q from wq (the rank's columns under tensor parallelism), and the
    layout of the heads: (q, q sharded, w_uk sharded, w_uv sharded,
    whether the rank's q, w_uk and w_uv columns are its own whole heads).
    Outside a context every weight is whole and nothing is sharded."""
    m = cfg.mla
    h = cfg.n_heads
    q, qs = tp.column(xe, p["wq"], None,
                      h * (m.qk_nope_head_dim + m.qk_rope_head_dim))
    uk = p["w_uk"].shape[-1] != h * m.qk_nope_head_dim
    uv = p["w_uv"].shape[-1] != h * m.v_head_dim
    own = qs and uk and uv and h % tp.active().size == 0
    return q, qs, uk, uv, own


def mla_train(cfg: ArchConfig, p: Tree, x: torch.Tensor) -> torch.Tensor:
    """Causal full-sequence MLA for training and prefill."""
    m = cfg.mla
    xe = _entered(x)
    q, qs, uk, uv, own = _heads(cfg, p, xe)
    # the latent is whole on every rank; the rank's columns (its heads'
    # keys, values and rope keys) give parts of its gradient
    c_kv, k_rope = _latent(cfg, p, xe.whole())
    if own:
        c_kv, k_rope = tp.copy_in(c_kv), tp.copy_in(k_rope)
    k_nope = (tp.copy_in(c_kv) if uk and not own else c_kv) @ p["w_uk"]
    v = (tp.copy_in(c_kv) if uv and not own else c_kv) @ p["w_uv"]
    if not own:             # the shards cut a head: every head, whole
        q = tp.gather(q, -1) if qs else q
        k_nope = tp.gather(k_nope, -1) if uk else k_nope
        v = tp.gather(v, -1) if uv else v
    out = _expanded(cfg, q, k_nope, k_rope, v)
    y = tp.row(out, p["wo"], cfg.n_heads * m.v_head_dim, own)
    return shard_hint(y, ("batch", "act_seq", "act_embed"))


def _expanded(cfg: ArchConfig, q: torch.Tensor, k_nope: torch.Tensor,
              k_rope: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The expanded attention of the heads that q (B, S, n * qd), k_nope
    (B, S, n * nope) and v (B, S, n * v) hold, with the shared rope keys
    (B, S, rope): (B, S, n * v)."""
    m = cfg.mla
    B, S, _ = q.shape
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    h = q.shape[-1] // qd
    q = q.reshape(B, S, h, qd)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    cos, sin = rope_tables(S, m.qk_rope_head_dim, cfg.rope_theta,
                           device=q.device)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)      # (B,S,1,rope)

    k_nope = k_nope.reshape(B, S, h, m.qk_nope_head_dim)
    v = v.reshape(B, S, h, m.v_head_dim)
    k = torch.cat([k_nope, k_rope.expand(B, S, h, m.qk_rope_head_dim)],
                  dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    qq = shard_hint(qq, ("batch", "seq", "heads", "head_dim"))
    # v may be narrower than the qk head_dim; attend only needs q and k
    # to match
    out = attend(cfg.replace(n_kv_heads=cfg.n_heads), qq, k, v, causal=True)
    return out.reshape(B, S, h * m.v_head_dim)


def mla_prefill_cache(cfg: ArchConfig, p: Tree, x: torch.Tensor
                      ) -> torch.Tensor:
    """Latent cache for prefill: (B, S, kv_lora + rope), rope applied;
    whole on every rank under tensor parallelism."""
    m = cfg.mla
    x = _entered(x).whole()
    c_kv, k_rope = _latent(cfg, p, x)
    cos, sin = rope_tables(x.shape[1], m.qk_rope_head_dim, cfg.rope_theta,
                           device=x.device)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return torch.cat([c_kv, k_rope], dim=-1)


def mla_decode(cfg: ArchConfig, p: Tree, x: torch.Tensor,
               cache: torch.Tensor, pos: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absorbed decode step. x (B,D); cache (B,S,R+rope), written in place
    at each row's position and returned; pos (B,). Under tensor
    parallelism the rank's heads attend the whole latent cache (every
    head where the shards cut one)."""
    m = cfg.mla
    h = cfg.n_heads
    R = m.kv_lora_rank
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    w_uk, w_uv = p["w_uk"], p["w_uv"]
    xe = _entered(x)
    q, qs, uk, uv, own = _heads(cfg, p, xe)
    x = xe.whole()
    if not own:
        q = tp.gather(q, -1) if qs else q
        w_uk = tp.gather(w_uk, -1) if uk else w_uk
        w_uv = tp.gather(w_uv, -1) if uv else w_uv
    B = x.shape[0]
    S = cache.shape[1]
    n = q.shape[-1] // qd

    q = q.reshape(B, n, qd)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = apply_rope_at(q_rope, pos, m.qk_rope_head_dim, cfg.rope_theta)

    c_kv, k_rope = _latent(cfg, p, x[:, None, :])
    k_rope = apply_rope_at(k_rope, pos, m.qk_rope_head_dim,
                           cfg.rope_theta)[:, 0, :]
    write_cache(cache, pos, torch.cat([c_kv[:, 0, :], k_rope], dim=-1))

    lat, rope_k = cache[..., :R], cache[..., R:]               # (B,S,*)
    w_uk = w_uk.reshape(R, n, m.qk_nope_head_dim)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope, w_uk)         # (B,h,R)
    scores = (torch.einsum("bhr,bsr->bhs", q_abs, lat.to(q_abs.dtype))
              + torch.einsum("bhn,bsn->bhs", q_rope,
                             rope_k.to(q_rope.dtype))).to(torch.float32)
    scores = scores * (qd ** -0.5)
    valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhs,bsr->bhr", probs, lat.to(x.dtype))  # (B,h,R)
    w_uv = w_uv.reshape(R, n, m.v_head_dim)
    out = torch.einsum("bhr,rhv->bhv", ctx, w_uv).reshape(B, n * m.v_head_dim)
    return tp.row(out, p["wo"], h * m.v_head_dim, own), cache
