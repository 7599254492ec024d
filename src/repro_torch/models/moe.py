"""Mixture-of-experts FFN with capacity-based group dispatch.

Held against ``repro.models.moe``: ``moe_specs``, ``_capacity``,
``moe_apply`` and ``moe_apply_token`` (both decode dispatches), with the
reference's ``GROUP_SIZE`` and ``TOKEN_DISPATCH`` module constants.

Tokens are split into groups of ``GROUP_SIZE``; each group routes its
tokens' top-k experts through per-(expert, capacity slot) dispatch and
combine masks built one k at a time with a running ``fill`` per expert,
so a token past an expert's capacity is dropped exactly where the
reference drops it. The experts then run as dense einsums over (group,
expert, slot). The router is float32 while the experts are in the
parameters' dtype (bfloat16 by default). Shared experts (DeepSeek) are
an always-on dense FFN added to the routed output.

``torch.topk`` and ``jax.lax.top_k`` may order exact ties differently;
with a float32 router on real inputs ties do not occur (the parity tests
assert so on theirs).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (
    ParamSpec,
    activation,
    shard_hint,
    subtree,
)
from repro_torch.models.layers import mlp_apply, mlp_specs

Tree = Dict[str, torch.Tensor]

GROUP_SIZE = 512
# decode-path dispatch: "gather" takes each token's top-k expert weights;
# "dense" runs every expert on the token batch and combines by routing
# weight (the reference's module constant)
TOKEN_DISPATCH = "gather"


def moe_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    mo = cfg.moe
    e, f = mo.num_experts, mo.d_expert
    # router kept in f32: routing decisions are precision-sensitive
    s: Dict[str, ParamSpec] = {
        "router": ParamSpec((d, e), ("embed", "experts"), "normal",
                            dtype=torch.float32)}
    if cfg.glu:
        s["w_gate"] = ParamSpec((e, d, f), ("experts", "embed", "expert_ff"),
                                "normal")
        s["w_up"] = ParamSpec((e, d, f), ("experts", "embed", "expert_ff"),
                              "normal")
    else:
        s["w_in"] = ParamSpec((e, d, f), ("experts", "embed", "expert_ff"),
                              "normal")
    s["w_down"] = ParamSpec((e, f, d), ("experts", "expert_ff", "embed"),
                            "normal")
    if mo.num_shared_experts > 0:
        shared_f = mo.d_shared_expert * mo.num_shared_experts
        s.update({f"shared.{k}": v
                  for k, v in mlp_specs(cfg, d_ff=shared_f).items()})
    return s


def one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``F.one_hot(idx, n).to(dtype)`` as a comparison with an ``arange``:
    the same values, and no check of the index values, which
    ``torch.func.vmap`` refuses (the datacenter step maps the loss over
    clients)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _capacity(group_size: int, top_k: int, num_experts: int,
              capacity_factor: float) -> int:
    c = int(group_size * top_k * capacity_factor / num_experts)
    return max(c, 4)


def _route(p: Tree, x: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Float32 router over x (..., D): (probs (..., E), top-k weights
    normalized to sum 1 (..., K), top-k experts (..., K))."""
    logits = x.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_i


def _experts(cfg: ArchConfig, p: Tree, eq_in: str, x: torch.Tensor,
             eq_out: str) -> torch.Tensor:
    """The expert FFN as einsums: ``eq_in`` contracts x with (E, D, F),
    ``eq_out`` the hidden with (E, F, D)."""
    act = activation(cfg.mlp_act)
    if cfg.glu:
        h = act(torch.einsum(eq_in, x, p["w_gate"])) \
            * torch.einsum(eq_in, x, p["w_up"])
    else:
        h = act(torch.einsum(eq_in, x, p["w_in"]))
    if h.dim() == 4:                   # the grouped path, (G, E, C, F)
        h = shard_hint(h, ("batch", "experts", None, "act_expert_ff"))
    return torch.einsum(eq_out, h, p["w_down"])


def _dispatch_masks(top_w: torch.Tensor, top_i: torch.Tensor, E: int,
                    C: int, dtype: torch.dtype
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-k outer products of expert and capacity-slot one-hots: dispatch
    (G, Sg, E, C) in ``dtype`` and combine (same, float32, times the
    routing weight). A group's tokens take an expert's slots in token
    order for k = 0, then k = 1, ...; an assignment past slot C - 1 is
    dropped (its rows are zero)."""
    G, Sg, K = top_i.shape
    dispatch = torch.zeros(G, Sg, E, C, dtype=dtype, device=top_i.device)
    combine = torch.zeros(G, Sg, E, C, dtype=torch.float32,
                          device=top_i.device)
    # running count of tokens already assigned to each expert in the group
    fill = torch.zeros(G, E, dtype=torch.int64, device=top_i.device)
    for k in range(K):
        sel = top_i[:, :, k]                                   # (G, Sg)
        onehot_e = one_hot(sel, E, torch.int64)                # (G, Sg, E)
        # position of this token within its expert's buffer
        prior = torch.cumsum(onehot_e, dim=1) - onehot_e       # tokens before
        pos = (prior * onehot_e).sum(-1) + torch.gather(fill, 1, sel)
        keep = (pos < C).to(torch.float32)
        # past capacity: the one-hot row is zeroed by ``keep`` (the
        # reference's one_hot of an out-of-range index is all zeros)
        onehot_c = one_hot(pos.clamp(max=C - 1), C, torch.float32)
        mask_ec = (onehot_e.to(torch.float32) * keep[..., None])[..., None] \
            * onehot_c[:, :, None, :]                          # (G, Sg, E, C)
        dispatch = dispatch + mask_ec.to(dtype)
        combine = combine + mask_ec * top_w[:, :, k][..., None, None]
        fill = fill + onehot_e.sum(1)
    return dispatch, combine


def moe_apply(cfg: ArchConfig, p: Tree, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux_loss scalar f32)."""
    mo = cfg.moe
    B, S, D = x.shape
    T = B * S
    g_size = min(GROUP_SIZE, T)
    if T % g_size:
        raise ValueError(f"{T} tokens do not split into groups of "
                         f"{g_size}")
    G = T // g_size
    E, K = mo.num_experts, mo.top_k
    C = _capacity(g_size, K, E, mo.capacity_factor)

    xg = x.reshape(G, g_size, D)
    xg = shard_hint(xg, ("batch", None, "act_embed"))
    probs, top_w, top_i = _route(p, xg, K)                    # (G, Sg, *)

    # ---- load-balance auxiliary loss (switch-style) ---------------------- #
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = one_hot(top_i, E, torch.float32).sum(2).mean(dim=(0, 1)) / K
    aux = E * torch.sum(me * ce) * mo.aux_loss_coef

    dispatch, combine = _dispatch_masks(top_w, top_i, E, C, x.dtype)

    # ---- expert computation ---------------------------------------------- #
    ex_in = torch.einsum("gsd,gsec->gecd", xg, dispatch)       # (G, E, C, D)
    ex_in = shard_hint(ex_in, ("batch", "experts", None, "act_embed"))
    ex_out = _experts(cfg, p, "gecd,edf->gecf", ex_in, "gecf,efd->gecd")
    y = torch.einsum("gecd,gsec->gsd", ex_out, combine.to(x.dtype))
    y = y.reshape(B, S, D)
    if mo.num_shared_experts > 0:
        y = y + mlp_apply(cfg, subtree(p, "shared."), x)
    return y, aux.to(torch.float32)


def moe_apply_token(cfg: ArchConfig, p: Tree, x: torch.Tensor
                    ) -> torch.Tensor:
    """Decode-path MoE for one token per sequence: x (B, D) -> (B, D).

    With one token there is no capacity contention: gather each token's
    top-k expert weights and run them as small batched matmuls (or, with
    ``TOKEN_DISPATCH == "dense"``, run every expert and combine by
    routing weight)."""
    mo = cfg.moe
    K = mo.top_k
    _, top_w, top_i = _route(p, x, K)                          # (B, K)
    top_w = top_w.to(x.dtype)

    if TOKEN_DISPATCH == "dense":
        # combine weight per expert: sum of top-k weights routed to it
        cw = torch.zeros(x.shape[0], mo.num_experts, dtype=x.dtype,
                         device=x.device)
        for k in range(K):
            cw = cw + one_hot(top_i[:, k], mo.num_experts, x.dtype) \
                * top_w[:, k][:, None]
        y_e = _experts(cfg, p, "bd,edf->ebf", x, "ebf,efd->ebd")  # (E,B,D)
        y = torch.einsum("ebd,be->bd", y_e, cw)
    else:
        act = activation(cfg.mlp_act)
        wd = p["w_down"][top_i]                                # (B, K, F, D)
        if cfg.glu:
            h = act(torch.einsum("bd,bkdf->bkf", x, p["w_gate"][top_i])) \
                * torch.einsum("bd,bkdf->bkf", x, p["w_up"][top_i])
        else:
            h = act(torch.einsum("bd,bkdf->bkf", x, p["w_in"][top_i]))
        y = torch.einsum("bkf,bkfd->bd", h * top_w[..., None], wd)
    if mo.num_shared_experts > 0:
        y = y + mlp_apply(cfg, subtree(p, "shared."), x)
    return y
