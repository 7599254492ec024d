"""Stochastic gradient quantization (paper Eq. 16-18, Lemma 1).

Held against ``repro.core.quantization`` (``quantize_dequantize``,
``quantize_pytree``, ``range_sq_sum``, ``payload_bits``,
``payload_bits_host``, ``quant_error_bound``). The magnitude range [g_min, g_max] of each tensor
is divided uniformly into 2^delta - 1 steps and each |g_v| rounds
stochastically to a neighbouring level (Eq. 17), so E[Q(g)] = g (Lemma
1). Randomness is an input: every function takes the uniforms it uses,
as the kernel does.

Parameter and gradient trees are ``Dict[str, Tensor]`` in the reference's
leaf order (``repro_torch.models.convert``).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.kernels.stochastic_quant import stochastic_quant

Tree = Dict[str, torch.Tensor]


def _levels(bits: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.pow(2.0, torch.as_tensor(
        bits, dtype=torch.float32))) - 1.0


def quantize_dequantize(g: torch.Tensor, bits, rand: torch.Tensor
                        ) -> torch.Tensor:
    """Fused Q(g) of one tensor in its own dtype; ``rand`` is a uniform
    tensor of g's shape. Runs through the kernel wrapper (the plain
    version on a CPU tensor)."""
    a = g.to(torch.float32).abs()
    n = _levels(bits).to(g.device)
    rng = torch.stack([a.min(), a.max(), n.reshape(())]).reshape(1, 3)
    return stochastic_quant(g.reshape(1, -1).contiguous(),
                            rand.to(torch.float32).reshape(1, -1)
                            .contiguous(), rng).reshape(g.shape)


def quantize_pytree(g: Tree, bits, rands: Sequence[torch.Tensor]) -> Tree:
    """``quantize_dequantize`` leaf-wise, one uniform tensor per leaf in
    the tree's order."""
    return {k: quantize_dequantize(v, bits, r)
            for (k, v), r in zip(g.items(), rands)}


def quant_error_bound(range_sq_sum: torch.Tensor,
                      bits) -> torch.Tensor:
    """Lemma 1 upper bound:  sum_v (hi - lo)^2 / (4 (2^delta - 1)^2)."""
    n = _levels(bits)
    return range_sq_sum / (4.0 * n * n)


def _payload_bits_impl(num_params, bits, xi_bits, as_f32):
    """Eq. 18 in float32: total uplink bits delta~ = V * delta + xi.

    The one formula both halves evaluate (the reference's
    ``_payload_bits_impl``): ``payload_bits`` on tensors, and
    ``payload_bits_host`` on numpy, each a float32 product then a
    float32 sum, so device and host accounting cannot drift."""
    return as_f32(num_params) * as_f32(bits) + as_f32(xi_bits)


def _torch_f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return np.float32(x)


def payload_bits(num_params, bits: torch.Tensor, xi_bits) -> torch.Tensor:
    """Eq. 18 on tensors (``bits`` a tensor; the counts may be Python
    numbers), float32."""
    return _payload_bits_impl(num_params, bits, xi_bits, _torch_f32)


def payload_bits_host(num_params, bits, xi_bits) -> np.ndarray:
    """Numpy twin of ``payload_bits``, returned as float64 for the host
    accounting chain (the shared float32 formula, so decisions agree
    bitwise)."""
    return np.asarray(_payload_bits_impl(
        num_params, bits, xi_bits,
        lambda x: np.asarray(x, np.float32)), np.float64)


def range_sq_sum(g: Tree, *, client_axis: bool = False) -> torch.Tensor:
    """sum over leaves of (max|g| - min|g|)^2 * leaf size — the
    Sigma_v (g_max - g_min)^2 term of Eq. (26)/(29) with per-tensor
    ranges, summed in leaf order in f32. With ``client_axis`` every leaf
    is (C, ...) and the result is (C,), one sum per client."""
    total = None
    for x in g.values():
        a = x.abs()          # exact in x's dtype: min/max cast exactly
        if client_axis:
            flat = a.reshape(a.shape[0], -1)
            r = (flat.amax(dim=1).to(torch.float32)
                 - flat.amin(dim=1).to(torch.float32))
            size = float(flat.shape[1])
        else:
            r = a.max().to(torch.float32) - a.min().to(torch.float32)
            size = float(a.numel())
        term = r * r * size
        total = term if total is None else total + term
    return total
