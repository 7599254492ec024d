"""Model pruning (paper Eq. 11-13, Lemma 2), unstructured and by blocks.

Held against ``repro.core.pruning``:

* ``importance`` (Eq. 12, line 29), ``pruning_error_bound`` (Lemma 2,
  line 163) and ``actual_pruning_error`` (line 168, a float32 sum over
  leaves in leaf order);
* ``magnitude_prune`` / ``magnitude_prune_pytree`` — the paper's
  importance I_v = |w_v| (Eq. 12): the smallest floor(rho * n) entries of
  each >= 2-D leaf are zeroed, 1-D leaves are exempt (the edge step).
* ``block_importance`` / ``block_prune`` / ``prune_pytree`` — importance
  is the L2 norm of (block x block) tiles of the last two dims, and whole
  tiles are zeroed (the datacenter step's ``prune_kind="block"``).
  Tileable leaves go through the block-prune kernels
  (``kernels.ops.block_prune_2d``: leading dims collapse into rows, which
  keeps every tile whole and the reference's global tile order); other
  >= 2-D leaves — the stacked (L, d) norm scales among them — are
  magnitude-pruned; 1-D leaves are exempt.

Masks are bitwise the reference's: the ranking rule is
``kernels.ops.rank_mask`` (float32 cut, stable ranks). ``rho`` may be a
scalar or a (C,) per-client vector; with a vector every pruned leaf
comes back as a (C, ...) stack (one pruned copy per client) while the
importance and its ranking are computed once per leaf.

The mask of a tileable leaf is its TILE mask, (C?, *lead, tr, tc) as the
reference's ``block_prune`` returns it, not the reference
``prune_pytree``'s expanded element mask: ``gate_pytree`` applies it to
the gradients with the masking kernel, which gives the same product per
element without a (C, ...) element mask. ``element_masks`` expands it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.block_prune import apply_block_mask, block_norms

Tree = Dict[str, torch.Tensor]
BLOCK = 128


def importance(w: torch.Tensor) -> torch.Tensor:
    """Eq. 12 importance: |w|."""
    return torch.abs(w)


def magnitude_prune(w: torch.Tensor, rho) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Zero the smallest-|w| rho-fraction of entries (Eq. 12-13)."""
    mask = ops.rank_mask(w.to(torch.float32).abs(), rho)
    return w * mask.to(w.dtype), mask


def _exempt(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return x, torch.ones(x.shape, dtype=torch.bool, device=x.device)


def magnitude_prune_pytree(w: Tree, rho) -> Tuple[Tree, Tree]:
    """Unstructured pruning of every >= 2-D leaf; 1-D leaves (norm scales,
    biases) come back unchanged, with an all-ones mask of their own shape."""
    pruned, masks = {}, {}
    for name, x in w.items():
        if x.dim() < 2:
            pruned[name], masks[name] = _exempt(x)
        else:
            pruned[name], masks[name] = magnitude_prune(x, rho)
    return pruned, masks


# --------------------------------------------------------------------------- #
# Block-structured pruning
# --------------------------------------------------------------------------- #
def tileable(w: torch.Tensor, block: int = BLOCK) -> bool:
    return (w.dim() >= 2 and w.shape[-2] % block == 0
            and w.shape[-1] % block == 0)


def _rows(w: torch.Tensor) -> torch.Tensor:
    """The leaf as a contiguous (prod(leading) * M, N) matrix."""
    return w.reshape(-1, w.shape[-1]).contiguous()


def _tile_grid(shape, block: int) -> Tuple[int, ...]:
    return tuple(shape[:-2]) + (shape[-2] // block, shape[-1] // block)


def block_importance(w: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """L2 norm per (block x block) tile of the last two dims, f32
    (..., tr, tc); through the ``block_norms`` kernel."""
    return block_norms(_rows(w), (block, block)).reshape(
        _tile_grid(w.shape, block))


def block_prune(w: torch.Tensor, rho, block: int = BLOCK
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero the smallest-L2 rho-fraction of tiles of a tileable leaf.
    Returns (pruned, tile_mask (C?, ..., tr, tc))."""
    pruned, mask = ops.block_prune_2d(_rows(w), rho, (block, block))
    lead = tuple(mask.shape[:-2])              # (C,) for a per-client rho
    return (pruned.reshape(lead + tuple(w.shape)),
            mask.reshape(lead + _tile_grid(w.shape, block)))


def prune_pytree(w: Tree, rho, block: int = BLOCK) -> Tuple[Tree, Tree]:
    """Block-prune tileable leaves; magnitude-prune other >= 2-D leaves;
    EXEMPT 1-D leaves (norm scales, biases). Returns (pruned, masks):
    tile masks for tileable leaves, element masks for the others."""
    pruned, masks = {}, {}
    for name, x in w.items():
        if x.dim() < 2:
            pruned[name], masks[name] = _exempt(x)
        elif tileable(x, block):
            pruned[name], masks[name] = block_prune(x, rho, block)
        else:
            pruned[name], masks[name] = magnitude_prune(x, rho)
    return pruned, masks


def gate_pytree(grads: Tree, masks: Tree, block: int = BLOCK) -> Tree:
    """Pruned coordinates are neither trained nor uploaded (Eq. 32): each
    stacked (C, ...) gradient times its per-client mask, as the
    reference's ``g * mask.astype(g.dtype)``. A tile mask (as many dims as
    g, another shape) goes through the masking kernel, one launch per leaf
    for all C clients; an element mask, or an exempt leaf's shared
    all-ones mask, is multiplied."""
    out = {}
    for name, g in grads.items():
        mask = masks[name]
        if mask.dim() == g.dim() and tuple(mask.shape) != tuple(g.shape):
            c = g.shape[0]
            gated = apply_block_mask(
                g.reshape(c, -1, g.shape[-1]).contiguous(),
                mask.reshape(c, -1, mask.shape[-1]).contiguous(),
                (block, block))
            out[name] = gated.reshape(g.shape)
        else:
            out[name] = g * mask.to(g.dtype)
    return out


def element_masks(w: Tree, masks: Tree, block: int = BLOCK) -> Tree:
    """``prune_pytree``'s masks as element masks of the pruned leaves'
    shapes (the reference ``prune_pytree``'s form)."""
    out = {}
    for name, m in masks.items():
        lead = tuple(m.shape[:m.dim() - w[name].dim()])
        if tuple(m.shape) == lead + tuple(w[name].shape):
            out[name] = m
            continue
        grid = m.reshape(lead + _tile_grid(w[name].shape, block))
        full = grid[..., :, None, :, None].expand(
            grid.shape[:-2] + (grid.shape[-2], block, grid.shape[-1], block))
        out[name] = full.reshape(lead + tuple(w[name].shape))
    return out


def pruning_error_bound(rho, d_sq: float):
    """Lemma 2:  E||w - w_hat||^2 <= rho * D^2."""
    return rho * d_sq


def actual_pruning_error(w: Tree, pruned: Tree) -> torch.Tensor:
    """||w - w_hat||^2 over the tree, each leaf's sum in float32, summed
    in leaf order (used by property tests against Lemma 2)."""
    total = None
    for k, a in w.items():
        d = (a - pruned[k]).to(torch.float32)
        s = torch.sum(d * d)
        total = s if total is None else total + s
    return total
