"""Public wrappers around the kernels: range preparation, level counts,
uniform draws and tile ranking happen here, outside the kernels.

Held against ``repro.kernels.ops``:

* ``quantize_dequantize_2d`` (lines 23-27), static bits on one 2-D
  tensor: the dynamic path with one client row, one launch;
* ``kernel_quant_compatible`` (lines 30-43), the reference's shape
  predicate;
* ``quantize_dequantize_2d_dyn`` (lines 46-57), batched over clients: the
  reference computes one range per tensor inside a vmap over clients;
  here g carries the client axis and each client's row gets its own
  [lo, hi, n_levels].
* ``block_prune_2d`` (lines 60-73): tile norms (kernel), one stable
  ranking of the tiles, per-client cuts, masking (kernel). With a (C,)
  rho the ranking is computed once and each client keeps its own
  floor(rho_c * n_tiles) cut, so one masking launch writes all C pruned
  copies.
* ``rank_mask``: the ranking rule shared with magnitude pruning
  (``repro.core.pruning._rank_mask``), bitwise the reference's:
  k = floor(clip(rho, 0, 1) * n) in float32 (an f64 product can give
  another k near an integer at n in the millions), ranks from one STABLE
  argsort inverted by a scatter of arange (the reference's double
  argsort), so ties break by position;
* ``block_sparse_matmul`` (lines 76-80) and ``pruned_matmul`` (lines
  83-88): block-prune w at rho (tile norms, ranking, masking) and
  multiply by the UNPRUNED w under the tile mask, as the reference does;
  the kernel's skip is what applies the pruning.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels.block_prune import (
    DEFAULT_BLOCK,
    apply_block_mask,
    block_norms,
)
from repro_torch.kernels.block_sparse_matmul import DEFAULT_BLOCKS
from repro_torch.kernels.block_sparse_matmul import \
    block_sparse_matmul as _block_sparse_matmul
from repro_torch.kernels.stochastic_quant import stochastic_quant


def level_counts(bits: torch.Tensor) -> torch.Tensor:
    """n_levels = max(round(2^bits) - 1, 1), f32 (per client)."""
    bits = bits.to(torch.float32)
    return torch.clamp(torch.round(torch.pow(2.0, bits)) - 1.0, min=1.0)


def quantize_dequantize_2d(g: torch.Tensor, bits: float, *,
                           rand: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """Kernel-backed Q(g) of one 2-D tensor at a static bit-width: one
    launch, with the reference's n_levels = max(round(2^bits) - 1, 1).
    ``rand`` (g's shape, f32) or ``generator`` supplies the uniforms, as
    in ``quantize_dequantize_2d_dyn``."""
    if g.dim() != 2:
        raise ValueError(f"g must be (M, N), got {tuple(g.shape)}")
    bits = torch.full((1,), float(bits), dtype=torch.float32,
                      device=g.device)
    out = quantize_dequantize_2d_dyn(
        g.reshape(1, -1), bits, generator=generator,
        rand=None if rand is None else rand.reshape(1, -1))
    return out.reshape(g.shape)


def kernel_quant_compatible(shape: Tuple[int, ...],
                            block=(256, 256)) -> bool:
    """The reference's predicate: True when a >= 2-D shape, viewed as
    (prod(leading), last), tiles evenly by ``block``. It reports which
    leaves the reference sends to its TPU kernel; the CUDA kernel takes
    any length, so no path here branches on it."""
    if len(shape) < 2:
        return False
    m = 1
    for d in shape[:-1]:
        m *= d
    n = shape[-1]
    if m == 0 or n == 0:
        return False
    return m % min(block[0], m) == 0 and n % min(block[1], n) == 0


def quantize_dequantize_2d_dyn(g: torch.Tensor, bits: torch.Tensor, *,
                               rand: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None,
                               reduce_range: Optional[Callable] = None
                               ) -> torch.Tensor:
    """Kernel-backed Q(g) for a client batch g (C, L) at per-client
    bit-widths ``bits`` (C,). lo/hi are each client's min/max of |g|;
    when g is one shard of the clients' rows, ``reduce_range(lo, hi)``
    returns them over the whole rows (the sharded step's all-reduce).
    ``rand`` (C, L) f32 supplies the uniforms; without it they are drawn
    here from ``generator`` (which must live on g's device)."""
    a = g.abs()              # exact in g's dtype: min/max cast exactly
    lo = a.amin(dim=1).to(torch.float32)
    hi = a.amax(dim=1).to(torch.float32)
    if reduce_range is not None:
        lo, hi = reduce_range(lo, hi)
    rng = torch.stack([lo, hi, level_counts(bits.to(g.device))], dim=1)
    if rand is None:
        rand = torch.rand(g.shape, generator=generator, device=g.device,
                          dtype=torch.float32)
    return stochastic_quant(g.contiguous(), rand.contiguous(),
                            rng.contiguous())


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
    # n as a float32 tensor made on rho's device (no host copy)
    k = torch.floor(torch.clamp(rho, 0.0, 1.0)
                    * torch.full((), float(n), dtype=torch.float32,
                                 device=rho.device))
    return k.to(torch.int64)


def rank_mask(a: torch.Tensor, rho) -> torch.Tensor:
    """True for entries NOT among the floor(rho * n) smallest of ``a``.
    A (C,) ``rho`` gives a (C, *a.shape) stack of masks."""
    ranks = _ranks(a)
    k = _prune_counts(rho, a.numel()).to(a.device)
    return ranks >= k.reshape(k.shape + (1,) * a.dim())


def block_prune_2d(w: torch.Tensor, rho, block=DEFAULT_BLOCK
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel-backed block pruning of w (M, N): returns (pruned, tile_mask).

    A scalar rho gives pruned (M, N) and tile_mask (M/bm, N/bn); a (C,)
    rho gives (C, M, N) and (C, M/bm, N/bn), one per client."""
    norms = block_norms(w, block)
    mask = rank_mask(norms, rho)
    return apply_block_mask(w, mask, block), mask


def block_sparse_matmul(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                        blocks=DEFAULT_BLOCKS) -> torch.Tensor:
    """x @ w skipping the pruned (bk, bn) tiles of w; blocks = (bm, bn,
    bk)."""
    return _block_sparse_matmul(x, w, mask, blocks=blocks)


def pruned_matmul(x: torch.Tensor, w: torch.Tensor, rho: float,
                  blocks=DEFAULT_BLOCKS) -> torch.Tensor:
    """Block-prune w at ratio rho with (bk, bn) tiles, then the
    block-sparse product with the unpruned w and the tile mask."""
    _, mask = block_prune_2d(w, rho, block=(blocks[2], blocks[1]))
    return block_sparse_matmul(x, w, mask, blocks=blocks)
