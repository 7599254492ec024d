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

The top k are taken with a stable descending sort (``_top_k``), so that
exact ties go to the lower expert index, as ``jax.lax.top_k`` orders
them (``torch.topk`` does not promise an order): a token whose input is
all zero (at small widths, a pruned embedding row at the start of a
sequence) gives every expert the same probability. Near-ties can still
route apart under float32 noise; the parity tests assert that theirs
have none.

Under a tensor-parallel context (``models.tensor_parallel``) each rank
runs its shard of the experts and the router's columns on the whole
block input, routes every token as the whole model does from the
gathered logits, and its partial output is summed over 'model'; the
shared experts take the MLP's tensor-parallel path.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.common import (
    ParamSpec,
    activation,
    shard_hint,
    subtree,
)
from repro_torch.models.layers import _entered, mlp_apply, mlp_specs

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


def _top_k(x: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last dim and their indices, ties to
    the lower index (``jax.lax.top_k``'s order)."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _route(p: Tree, x: torch.Tensor, k: int, n_experts: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Float32 router over x (..., D): (probs (..., E), top-k weights
    normalized to sum 1 (..., K), top-k experts (..., K)). A router
    narrower than ``n_experts`` is the rank's columns: its logits are
    gathered whole."""
    logits = x.to(torch.float32) @ p["router"]
    if logits.shape[-1] != n_experts:
        logits = tp.gather(logits, -1)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, k)
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


def _dispatch_masks(top_w: torch.Tensor, top_i: torch.Tensor, C: int,
                    dtype: torch.dtype, lo: int, hi: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-k outer products of expert and capacity-slot one-hots for the
    experts [lo, hi) (all E of them, or a rank's under tensor
    parallelism: a slot depends only on the assignments to its own
    expert): dispatch (G, Sg, hi - lo, C) in ``dtype`` and combine (same,
    float32, times the routing weight). A group's tokens take an
    expert's slots in token order for k = 0, then k = 1, ...; an
    assignment past slot C - 1 is dropped (its rows are zero)."""
    n = hi - lo
    G, Sg, K = top_i.shape
    dispatch = torch.zeros(G, Sg, n, C, dtype=dtype, device=top_i.device)
    combine = torch.zeros(G, Sg, n, C, dtype=torch.float32,
                          device=top_i.device)
    # running count of tokens already assigned to each expert in the group
    fill = torch.zeros(G, n, dtype=torch.int64, device=top_i.device)
    for k in range(K):
        sel = top_i[:, :, k] - lo                              # (G, Sg)
        # all zero for an expert outside [lo, hi)
        onehot_e = one_hot(sel, n, torch.int64)                # (G, Sg, n)
        # position of this token within its expert's buffer
        prior = torch.cumsum(onehot_e, dim=1) - onehot_e       # tokens before
        pos = (prior * onehot_e).sum(-1) \
            + torch.gather(fill, 1, sel.clamp(0, n - 1))
        keep = (pos < C).to(torch.float32)
        # past capacity: the one-hot row is zeroed by ``keep`` (the
        # reference's one_hot of an out-of-range index is all zeros)
        onehot_c = one_hot(pos.clamp(max=C - 1), C, torch.float32)
        mask_ec = (onehot_e.to(torch.float32) * keep[..., None])[..., None] \
            * onehot_c[:, :, None, :]                          # (G, Sg, n, C)
        dispatch = dispatch + mask_ec.to(dtype)
        combine = combine + mask_ec * top_w[:, :, k][..., None, None]
        fill = fill + onehot_e.sum(1)
    return dispatch, combine


def _layout(cfg: ArchConfig, p: Tree, x
            ) -> Tuple[torch.Tensor, int, int, bool]:
    """The block input, the experts [lo, hi) this rank runs, and whether
    they are its shard of them. Under tensor parallelism the input is
    the whole residual stream (token groups and capacity are defined on
    the global token order); with the experts sharded each rank's gives
    a part of its gradient."""
    E = cfg.moe.num_experts
    if tp.active() is None:
        return x, 0, E, False
    xe = _entered(x)
    lo, hi = tp.expert_range(p["w_down"].shape[0], E)
    sharded = hi - lo != E
    if sharded != (p["router"].shape[-1] != E):
        raise NotImplementedError("the router and the experts laid out "
                                  "apart over 'model'")
    return (xe.part() if sharded else xe.whole()), lo, hi, sharded


def _shared(cfg: ArchConfig, p: Tree, x) -> torch.Tensor:
    mo = cfg.moe
    return mlp_apply(cfg, subtree(p, "shared."), x,
                     d_ff=mo.d_shared_expert * mo.num_shared_experts)


def moe_apply(cfg: ArchConfig, p: Tree, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux_loss scalar f32); under tensor
    parallelism x is the block's ``tensor_parallel.Enter`` and y is in
    the residual stream's layout."""
    mo = cfg.moe
    xw, lo, hi, sharded = _layout(cfg, p, x)
    B, S, D = xw.shape
    T = B * S
    g_size = min(GROUP_SIZE, T)
    if T % g_size:
        raise ValueError(f"{T} tokens do not split into groups of "
                         f"{g_size}")
    G = T // g_size
    E, K = mo.num_experts, mo.top_k
    C = _capacity(g_size, K, E, mo.capacity_factor)

    xg = xw.reshape(G, g_size, D)
    xg = shard_hint(xg, ("batch", None, "act_embed"))
    probs, top_w, top_i = _route(p, xg, K, E)                 # (G, Sg, *)

    # ---- load-balance auxiliary loss (switch-style) ---------------------- #
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = one_hot(top_i, E, torch.float32).sum(2).mean(dim=(0, 1)) / K
    aux = E * torch.sum(me * ce) * mo.aux_loss_coef

    if sharded:             # each rank's combine gives a part of the grad
        top_w = tp.copy_in(top_w)
    dispatch, combine = _dispatch_masks(top_w, top_i, C, xw.dtype, lo, hi)

    # ---- expert computation ---------------------------------------------- #
    ex_in = torch.einsum("gsd,gsec->gecd", xg, dispatch)       # (G, E, C, D)
    ex_in = shard_hint(ex_in, ("batch", "experts", None, "act_embed"))
    ex_out = _experts(cfg, p, "gecd,edf->gecf", ex_in, "gecf,efd->gecd")
    y = torch.einsum("gecd,gsec->gsd", ex_out, combine.to(xw.dtype))
    y = tp.leave(y.reshape(B, S, D), partial=sharded)
    if mo.num_shared_experts > 0:
        y = y + _shared(cfg, p, x)
    return y, aux.to(torch.float32)


def moe_apply_token(cfg: ArchConfig, p: Tree, x: torch.Tensor
                    ) -> torch.Tensor:
    """Decode-path MoE for one token per sequence: x (B, D) -> (B, D).

    With one token there is no capacity contention: gather each token's
    top-k expert weights and run them as small batched matmuls (or, with
    ``TOKEN_DISPATCH == "dense"``, run every expert and combine by
    routing weight). Under tensor parallelism a rank runs only the
    choices that fall among its experts (the others weigh zero), and the
    partial outputs are summed over 'model'."""
    mo = cfg.moe
    K = mo.top_k
    xw, lo, hi, sharded = _layout(cfg, p, x)
    _, top_w, top_i = _route(p, xw, K, mo.num_experts)         # (B, K)
    top_w = top_w.to(xw.dtype)

    if TOKEN_DISPATCH == "dense":
        # combine weight per expert: sum of top-k weights routed to it
        cw = torch.zeros(xw.shape[0], mo.num_experts, dtype=xw.dtype,
                         device=xw.device)
        for k in range(K):
            cw = cw + one_hot(top_i[:, k], mo.num_experts, xw.dtype) \
                * top_w[:, k][:, None]
        y_e = _experts(cfg, p, "bd,edf->ebf", xw, "ebf,efd->ebd")  # (E,B,D)
        y = torch.einsum("ebd,be->bd", y_e, cw[:, lo:hi])
    else:
        if sharded:         # the rank's experts among each token's top k
            top_i = top_i - lo
            mine = (top_i >= 0) & (top_i < hi - lo)
            top_i = torch.where(mine, top_i, 0)
            top_w = top_w * mine.to(top_w.dtype)
        act = activation(cfg.mlp_act)
        wd = p["w_down"][top_i]                                # (B, K, F, D)
        if cfg.glu:
            h = act(torch.einsum("bd,bkdf->bkf", xw, p["w_gate"][top_i])) \
                * torch.einsum("bd,bkdf->bkf", xw, p["w_up"][top_i])
        else:
            h = act(torch.einsum("bd,bkdf->bkf", xw, p["w_in"][top_i]))
        y = torch.einsum("bkf,bkfd->bd", h * top_w[..., None], wd)
    y = tp.leave(y, partial=sharded)
    if mo.num_shared_experts > 0:
        y = y + _shared(cfg, p, x)
    return y
