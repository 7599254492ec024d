"""Public wrappers around the kernels: range preparation, level counts and
uniform draws happen here, outside the kernel.

Held against ``repro.kernels.ops.quantize_dequantize_2d_dyn`` (lines
46-57), batched over clients: the reference computes one range per
tensor inside a vmap over clients; here g carries the client axis and
each client's row gets its own [lo, hi, n_levels].
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.stochastic_quant import stochastic_quant


def level_counts(bits: torch.Tensor) -> torch.Tensor:
    """n_levels = max(round(2^bits) - 1, 1), f32 (per client)."""
    bits = bits.to(torch.float32)
    return torch.clamp(torch.round(torch.pow(2.0, bits)) - 1.0, min=1.0)


def quantize_dequantize_2d_dyn(g: torch.Tensor, bits: torch.Tensor, *,
                               rand: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None
                               ) -> torch.Tensor:
    """Kernel-backed Q(g) for a client batch g (C, L) at per-client
    bit-widths ``bits`` (C,). lo/hi are each client's min/max of |g|.
    ``rand`` (C, L) f32 supplies the uniforms; without it they are drawn
    here from ``generator`` (which must live on g's device)."""
    a = g.to(torch.float32).abs()
    lo = a.amin(dim=1)
    hi = a.amax(dim=1)
    rng = torch.stack([lo, hi, level_counts(bits.to(g.device))], dim=1)
    if rand is None:
        rand = torch.rand(g.shape, generator=generator, device=g.device,
                          dtype=torch.float32)
    return stochastic_quant(g.contiguous(), rand.contiguous(),
                            rng.contiguous())
