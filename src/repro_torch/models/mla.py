"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434).

Held against ``repro.models.mla``: ``mla_specs``, ``_latent``,
``mla_train``, ``mla_prefill_cache`` and ``mla_decode``. Train and
prefill use the expanded formulation; decode uses the *absorbed* one,
attending directly in the latent space, so the KV cache per token is
``kv_lora_rank + qk_rope_head_dim`` values. ``mla_decode`` writes the
new token's latent into the cache it is given, in place, and returns
that same cache.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (
    ParamSpec,
    apply_rope,
    apply_rope_at,
    rms_norm,
    rope_tables,
    shard_hint,
)
from repro_torch.models.layers import NEG_INF, attend, write_cache

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


def mla_train(cfg: ArchConfig, p: Tree, x: torch.Tensor) -> torch.Tensor:
    """Causal full-sequence MLA for training and prefill."""
    m = cfg.mla
    B, S, _ = x.shape
    h = cfg.n_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim

    q = (x @ p["wq"]).reshape(B, S, h, qd)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    c_kv, k_rope = _latent(cfg, p, x)

    cos, sin = rope_tables(S, m.qk_rope_head_dim, cfg.rope_theta,
                           device=x.device)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)      # (B,S,1,rope)

    k_nope = (c_kv @ p["w_uk"]).reshape(B, S, h, m.qk_nope_head_dim)
    v = (c_kv @ p["w_uv"]).reshape(B, S, h, m.v_head_dim)
    k = torch.cat([k_nope, k_rope.expand(B, S, h, m.qk_rope_head_dim)],
                  dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    qq = shard_hint(qq, ("batch", "seq", "heads", "head_dim"))
    # v may be narrower than the qk head_dim; attend only needs q and k
    # to match
    out = attend(cfg.replace(n_kv_heads=cfg.n_heads), qq, k, v, causal=True)
    y = out.reshape(B, S, h * m.v_head_dim) @ p["wo"]
    return shard_hint(y, ("batch", "act_seq", "act_embed"))


def mla_prefill_cache(cfg: ArchConfig, p: Tree, x: torch.Tensor
                      ) -> torch.Tensor:
    """Latent cache for prefill: (B, S, kv_lora + rope), rope applied."""
    m = cfg.mla
    c_kv, k_rope = _latent(cfg, p, x)
    cos, sin = rope_tables(x.shape[1], m.qk_rope_head_dim, cfg.rope_theta,
                           device=x.device)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return torch.cat([c_kv, k_rope], dim=-1)


def mla_decode(cfg: ArchConfig, p: Tree, x: torch.Tensor,
               cache: torch.Tensor, pos: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absorbed decode step. x (B,D); cache (B,S,R+rope), written in place
    at each row's position and returned; pos (B,)."""
    m = cfg.mla
    B = x.shape[0]
    h = cfg.n_heads
    R = m.kv_lora_rank
    S = cache.shape[1]
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim

    q = (x @ p["wq"]).reshape(B, h, qd)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = apply_rope_at(q_rope, pos, m.qk_rope_head_dim, cfg.rope_theta)

    c_kv, k_rope = _latent(cfg, p, x[:, None, :])
    k_rope = apply_rope_at(k_rope, pos, m.qk_rope_head_dim,
                           cfg.rope_theta)[:, 0, :]
    write_cache(cache, pos, torch.cat([c_kv[:, 0, :], k_rope], dim=-1))

    lat, rope_k = cache[..., :R], cache[..., R:]               # (B,S,*)
    w_uk = p["w_uk"].reshape(R, h, m.qk_nope_head_dim)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope, w_uk)         # (B,h,R)
    scores = (torch.einsum("bhr,bsr->bhs", q_abs, lat.to(q_abs.dtype))
              + torch.einsum("bhn,bsn->bhs", q_rope,
                             rope_k.to(q_rope.dtype))).to(torch.float32)
    scores = scores * (qd ** -0.5)
    valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhs,bsr->bhr", probs, lat.to(x.dtype))  # (B,h,R)
    w_uv = p["w_uv"].reshape(R, h, m.v_head_dim)
    out = torch.einsum("bhr,rhv->bhv", ctx, w_uv).reshape(B, h * m.v_head_dim)
    return out @ p["wo"], cache
