"""Plain PyTorch versions of the hand-written kernels (the oracles).

Held against ``repro.kernels.ref`` (``stochastic_quant_ref``,
``block_norms_ref``, ``apply_block_mask_ref``). Each function here
computes what its kernel computes, in separate PyTorch ops (no fused
multiply-add) and with the kernel's accumulation, so the CPU tests can
hold it to the JAX reference and the card check can hold the kernel to
it on the same inputs.
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


def block_norms_ref(w: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """Per-(bm x bn)-tile L2 norms of a 2-D array -> (M/bm, N/bn) f32.

    The squares are summed in float64 and the sum rounded once to
    float32 before the (IEEE) float32 square root, as the kernel does.
    The square of a float32 or bfloat16 value is exact in float64, so
    only the summation order can differ from the kernel's, by ~1e-16
    relative: the float32 results agree bit for bit unless a sum lies
    that close to a rounding boundary."""
    m, n = w.shape
    t = w.to(torch.float64).reshape(m // bm, bm, n // bn, bn)
    return torch.sqrt(torch.sum(t * t, dim=(1, 3)).to(torch.float32))


def apply_block_mask_ref(w: torch.Tensor, mask: torch.Tensor, bm: int,
                         bn: int) -> torch.Tensor:
    """Zero masked (mask == 0) tiles: each element times its tile's mask
    entry in w's dtype (so -x * 0 is -0, as in the reference).

    w (M, N), or (C, M, N) with one matrix per client; mask (M/bm, N/bn)
    bool, or (C, M/bm, N/bn) with one mask per client. A shared w with
    per-client masks gives (C, M, N)."""
    m, n = w.shape[-2:]
    t = w.reshape(w.shape[:-2] + (m // bm, bm, n // bn, bn))
    out = t * mask[..., :, None, :, None].to(w.dtype)
    return out.reshape(out.shape[:-4] + (m, n))
