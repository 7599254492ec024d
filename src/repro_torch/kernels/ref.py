"""Plain PyTorch versions of the hand-written kernels (the oracles).

Held against ``repro.kernels.ref``. Each function here computes exactly
what its kernel computes, in separate PyTorch ops (no fused
multiply-add), so the CPU tests can hold it to the JAX reference and the
card check can hold the kernel to it on the same inputs.
"""
from __future__ import annotations

import torch


def stochastic_quant_ref(g: torch.Tensor, rand: torch.Tensor,
                         rng: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize a client batch (paper Eq. 16-17).

    g: (C, ...) f32 or bf16; rand: (C, ...) f32 uniforms in [0, 1);
    rng: (C, 3) f32 rows [lo, hi, n_levels]. Per client,
    scale = (hi - lo) / n_levels (1 where that is not > 0),
    t = (|g| - lo) / scale, level = clip(floor(t) + [rand < t - floor(t)],
    0, n_levels), out = +/-(lo + level * scale) with the sign test g >= 0.
    Returns (C, ...) in g.dtype.
    """
    view = (g.shape[0],) + (1,) * (g.dim() - 1)
    rng = rng.to(torch.float32)
    lo = rng[:, 0].reshape(view)
    hi = rng[:, 1].reshape(view)
    n = rng[:, 2].reshape(view)
    gf = g.to(torch.float32)
    scale = (hi - lo) / n
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    t = (gf.abs() - lo) / scale
    t_floor = torch.floor(t)
    up = (rand.to(torch.float32) < (t - t_floor)).to(torch.float32)
    level = torch.minimum(torch.clamp(t_floor + up, min=0.0), n)
    mag = lo + level * scale
    return torch.where(gf >= 0, mag, -mag).to(g.dtype)
