"""Gradient aggregation under packet loss (paper Eq. 9/14/19).

Held against ``repro.core.aggregation.aggregate``:

    g^n = sum_u N_u alpha_u Q(g_u) / sum_u N_u alpha_u

If every packet drops (sum alpha = 0) the round contributes a zero update.
``denom`` fixes the normalizer (the population sample total, for
Horvitz-Thompson partial participation) instead of renormalizing over the
received clients. On a mesh a rank holds only its clients' gradients:
``rows`` names them among the C, and ``reduce_sum`` sums each leaf's
partial weighted sum over the other ranks' clients (the sharded step's
all-reduce).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

Tree = Dict[str, torch.Tensor]


def aggregate(client_grads: Tree, weights: torch.Tensor,
              alpha: torch.Tensor,
              denom: Optional[torch.Tensor] = None, *,
              rows: Optional[slice] = None,
              reduce_sum: Optional[Callable] = None) -> Tree:
    """client_grads: leaves with a leading client axis C (or the clients
    ``rows`` of C); weights (C,) = N_u (or N_u / pi_u); alpha (C,) in
    {0, 1}."""
    w = (weights * alpha).to(torch.float32)
    received = w.sum()
    norm = received if denom is None else torch.as_tensor(
        denom, dtype=torch.float32, device=w.device)
    safe = torch.clamp(norm, min=1e-12)
    w_rows = w if rows is None else w[rows]
    out = {}
    for name, g in client_grads.items():
        wg = torch.tensordot(w_rows.to(g.dtype), g, dims=([0], [0]))
        if reduce_sum is not None:
            wg = reduce_sum(wg)
        agg = wg / safe.to(g.dtype)
        out[name] = torch.where(received > 0, agg, torch.zeros_like(agg))
    return out
