"""Stochastic gradient quantization (paper Eq. 16-18, Lemma 1).

Held against ``repro.core.quantization`` (``QTensor``, ``quantize``,
``dequantize``, ``quantize_dequantize``, ``quantize_pytree``,
``range_sq_sum``, ``payload_bits``, ``payload_bits_host``,
``quant_error_bound``, and the int8 wire format ``quantize_int8``,
``dequantize_int8``, ``quantize_int8_pytree``). The magnitude range
[g_min, g_max] of each tensor is divided uniformly into 2^delta - 1
steps and each |g_v| rounds stochastically to a neighbouring level
(Eq. 17), so E[Q(g)] = g (Lemma 1). Randomness is an input: every
function takes the uniforms it uses, as the kernel does.

``quantize`` / ``dequantize`` expose the integer levels in plain tensor
code; ``quantize_dequantize`` is the fused form the train step runs,
through the kernel wrapper. On the CPU ``dequantize(quantize(g, b, u))``
is bitwise ``quantize_dequantize(g, b, u)`` (one op at a time on both).

Parameter and gradient trees are ``Dict[str, Tensor]`` in the reference's
leaf order (``repro_torch.models.convert``).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.stochastic_quant import stochastic_quant

Tree = Dict[str, torch.Tensor]


def _levels(bits: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.pow(2.0, torch.as_tensor(
        bits, dtype=torch.float32))) - 1.0


class QTensor(NamedTuple):
    """Quantized tensor: integer levels + range metadata."""

    levels: torch.Tensor   # g's shape; float32 levels in [0, 2^b - 1]
    sign: torch.Tensor     # bool: g >= 0
    lo: torch.Tensor       # scalar f32: min |g|
    hi: torch.Tensor       # scalar f32: max |g|
    bits: torch.Tensor     # scalar: quantization level delta


def _scale(lo: torch.Tensor, hi: torch.Tensor, n: torch.Tensor
           ) -> torch.Tensor:
    scale = (hi - lo) / n
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def quantize(g: torch.Tensor, bits, rand: torch.Tensor) -> QTensor:
    """Stochastic uniform quantization of one tensor (Eq. 16-17), in
    plain tensor code; ``rand`` holds g's shape of uniforms. Held
    against ``repro.core.quantization.quantize`` (lines 36-51)."""
    gf = g.to(torch.float32)
    a = gf.abs()
    lo, hi = a.min(), a.max()
    n = _levels(bits).to(g.device)
    t = (a - lo) / _scale(lo, hi, n)
    t_floor = torch.floor(t)
    up = (rand.to(torch.float32) < (t - t_floor)).to(torch.float32)
    level = torch.minimum(torch.clamp(t_floor + up, min=0.0), n)
    return QTensor(levels=level, sign=gf >= 0, lo=lo, hi=hi,
                   bits=torch.as_tensor(bits, device=g.device))


def dequantize(q: QTensor) -> torch.Tensor:
    """+/-(lo + level * scale) in float32 (reference lines 54-59)."""
    scale = _scale(q.lo, q.hi, _levels(q.bits).to(q.lo.device))
    mag = q.lo + q.levels * scale
    return torch.where(q.sign, mag, -mag)


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


def range_sq_sum(g: Tree, *, client_axis: bool = False,
                 reduce_range: Optional[Callable] = None,
                 sizes: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """sum over leaves of (max|g| - min|g|)^2 * leaf size — the
    Sigma_v (g_max - g_min)^2 term of Eq. (26)/(29) with per-tensor
    ranges, summed in leaf order in f32. With ``client_axis`` every leaf
    is (C, ...) and the result is (C,), one sum per client. When each
    leaf is one shard of the clients' leaves, ``reduce_range(name, lo,
    hi)`` returns the (C,) min and max over the whole leaf and ``sizes``
    gives each whole leaf's size (the sharded step)."""
    total = None
    for name, x in g.items():
        a = x.abs()          # exact in x's dtype: min/max cast exactly
        if client_axis:
            flat = a.reshape(a.shape[0], -1)
            lo = flat.amin(dim=1).to(torch.float32)
            hi = flat.amax(dim=1).to(torch.float32)
            if reduce_range is not None:
                lo, hi = reduce_range(name, lo, hi)
            r = hi - lo
            size = float(flat.shape[1] if sizes is None else sizes[name])
        else:
            r = a.max().to(torch.float32) - a.min().to(torch.float32)
            size = float(a.numel())
        term = r * r * size
        total = term if total is None else total + term
    return total


# --------------------------------------------------------------------------- #
# Symmetric int8 wire format (beyond-paper: quantized collectives)
# --------------------------------------------------------------------------- #
def quantize_int8(g: torch.Tensor, rand: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric stochastic int8: q = sr(g / scale), scale = max(max|g| /
    127, 1e-30), a float32 scalar; ``rand`` holds g's shape of uniforms.
    Unbiased (stochastic rounding). Held against
    ``repro.core.quantization.quantize_int8`` (lines 121-136)."""
    levels, scales = quantize_int8_clients(g.unsqueeze(0), rand.unsqueeze(0))
    return levels[0], scales[0]


def quantize_int8_clients(g: torch.Tensor, rand: torch.Tensor,
                          reduce_max: Optional[Callable] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_int8`` of each client's slice of a stacked (C, ...)
    leaf: levels (C, ...) int8 and scales (C,) float32. When g is one
    shard of each client's leaf, ``reduce_max`` takes the (C,) max|g| to
    the whole leaf's (the sharded step's all-reduce). The temporaries
    are reused in place (a granite-8b embedding leaf of 4 clients is 3.2
    GB a float32 temporary)."""
    gf = g.to(torch.float32)
    amax = gf.abs().reshape(g.shape[0], -1).amax(dim=1)
    if reduce_max is not None:
        amax = reduce_max(amax)
    scales = torch.clamp(amax / 127.0, min=1e-30)
    t = gf / scales.reshape((g.shape[0],) + (1,) * (g.dim() - 1))
    t_floor = torch.floor(t)
    up = rand.to(torch.float32) < t.sub_(t_floor)    # t - floor(t)
    del t
    levels = t_floor.add_(up).clamp_(-127.0, 127.0).to(torch.int8)
    return levels, scales


def dequantize_int8(levels: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """levels * scale in float32, cast to ``dtype`` (bfloat16 by default,
    as the reference's lines 139-141)."""
    return (levels.to(torch.float32) * scale).to(dtype)


def quantize_int8_pytree(g: Tree, rands: Sequence[torch.Tensor]
                         ) -> Tuple[Tree, Tree]:
    """``quantize_int8`` leaf-wise, one uniform tensor per leaf in the
    tree's order: (levels tree, scales tree) (reference lines 144-149)."""
    out = {k: quantize_int8(v, r) for (k, v), r in zip(g.items(), rands)}
    return ({k: o[0] for k, o in out.items()},
            {k: o[1] for k, o in out.items()})
