"""Unstructured magnitude pruning (paper Eq. 11-13, Lemma 2).

Held against ``repro.core.pruning`` (``_rank_mask``, ``magnitude_prune``,
``magnitude_prune_pytree``): importance I_v = |w_v| (Eq. 12), the
smallest floor(rho * n) entries of each >= 2-D leaf are zeroed, 1-D
leaves are exempt. Masks are bitwise the reference's:

* k = floor(clip(rho, 0, 1) * n) is computed in float32, from the f32
  control, as the reference does (an f64 product can give another k near
  an integer at n in the millions);
* ranks come from one STABLE argsort, inverted by a scatter of arange —
  the reference's double argsort — so ties break by position.

``rho`` may be a scalar or a (C,) per-client vector; with a vector every
>= 2-D leaf comes back as a (C, ...) stack (one pruned copy per client)
while the ranking itself is computed once per leaf.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Tree = Dict[str, torch.Tensor]


def _ranks(a: torch.Tensor) -> torch.Tensor:
    """Ascending rank of each entry of ``a`` (stable: ties by position)."""
    flat = a.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(flat.numel(), device=flat.device)
    return ranks.reshape(a.shape)


def _prune_counts(rho: torch.Tensor, n: int) -> torch.Tensor:
    """k = floor(clip(rho, 0, 1) * n) in float32, as int64."""
    rho = torch.as_tensor(rho, dtype=torch.float32)
    k = torch.floor(torch.clamp(rho, 0.0, 1.0)
                    * torch.tensor(float(n), dtype=torch.float32,
                                   device=rho.device))
    return k.to(torch.int64)


def _rank_mask(a: torch.Tensor, rho) -> torch.Tensor:
    """True for entries NOT among the floor(rho * n) smallest of ``a``.
    A (C,) ``rho`` gives a (C, *a.shape) stack of masks."""
    ranks = _ranks(a)
    k = _prune_counts(rho, a.numel()).to(a.device)
    return ranks >= k.reshape(k.shape + (1,) * a.dim())


def magnitude_prune(w: torch.Tensor, rho) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Zero the smallest-|w| rho-fraction of entries (Eq. 12-13)."""
    mask = _rank_mask(w.to(torch.float32).abs(), rho)
    return w * mask.to(w.dtype), mask


def magnitude_prune_pytree(w: Tree, rho) -> Tuple[Tree, Tree]:
    """Unstructured pruning of every >= 2-D leaf; 1-D leaves (norm scales,
    biases) come back unchanged, with an all-ones mask of their own shape."""
    pruned, masks = {}, {}
    for name, x in w.items():
        if x.dim() < 2:
            pruned[name] = x
            masks[name] = torch.ones(x.shape, dtype=torch.bool,
                                     device=x.device)
        else:
            pruned[name], masks[name] = magnitude_prune(x, rho)
    return pruned, masks
