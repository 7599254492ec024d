"""The LTFL round step (paper Eq. 8-20) in plain PyTorch, client by client.

One call follows one step of the program from the same weights, batches,
controls and seed:

1. prune the global weights per client (Eq. 12-13): by block (the L2
   norm of each (b x b) tile of a leaf viewed as (rows, last dim), the
   smallest floor(rho_c n) tiles zeroed) where a leaf tiles evenly, by
   magnitude otherwise; 1-D leaves are exempt. Ranks are stable (ties go
   by position) and k = floor(clip(rho, 0, 1) n) in float32;
2. each client's loss and gradient at its pruned weights (autograd, one
   client at a time), gated by its mask (Eq. 32);
3. the stochastic quantizer (Eq. 16-17) per client and leaf at
   max(delta, 1) bits over the range [min |g|, max |g|] of the client's
   leaf; a client with delta <= 0 sends its gradient as it is;
4. the packet outcomes: given, or alpha = u >= drop_prob;
5. the weighted aggregate over received clients (Eq. 19), in float32,
   and plain gradient descent (Eq. 20) in the parameters' dtype.

Random draws are the program's documented streams, re-made here from
the same seeds: one ``torch.Generator`` on the device seeded with the
step's seed draws one (C, *leaf) float32 uniform tensor a leaf, in the
parameters' order; the drop draw is a generator seeded with the seed
plus 2^32, (C,) uniforms.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

Tree = Dict[str, torch.Tensor]
DROP_STREAM = 1 << 32


def path_key(name: str):
    """Leaf order of a dotted path: list indices compare as integers."""
    return tuple(int(t) if t.isdigit() else t for t in name.split("."))


def ranked_keep(scores: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """(C, *scores.shape) bool: True where an entry is not among the
    floor(rho_c n) smallest of ``scores`` (stable ranks)."""
    flat = scores.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(flat.numel(), device=flat.device)
    n = torch.full((), float(flat.numel()), dtype=torch.float32,
                   device=rho.device)
    k = torch.floor(torch.clamp(rho.to(torch.float32), 0.0, 1.0) * n)
    keep = ranks[None, :] >= k.to(torch.int64).to(flat.device)[:, None]
    return keep.reshape((rho.shape[0],) + tuple(scores.shape))


class Masks:
    """Each client's pruning mask of every leaf: a tile mask for a leaf
    that tiles by ``block``, an element mask for other >= 2-D leaves,
    none for 1-D leaves."""

    def __init__(self, params: Tree, rho: torch.Tensor, kind: str,
                 block: int):
        self.block, self.tiles, self.elems = block, {}, {}
        for name, w in params.items():
            if w.dim() < 2:
                continue
            if kind == "block" and w.shape[-2] % block == 0 \
                    and w.shape[-1] % block == 0:
                rows = w.reshape(-1, w.shape[-1]).to(torch.float64)
                r, n = rows.shape
                t = rows.reshape(r // block, block, n // block, block)
                norms = torch.sqrt(torch.sum(t * t, dim=(1, 3))
                                   .to(torch.float32))
                self.tiles[name] = ranked_keep(norms, rho)
            else:
                self.elems[name] = ranked_keep(w.to(torch.float32).abs(),
                                               rho)

    def apply(self, name: str, x: torch.Tensor, c: int) -> torch.Tensor:
        """Client ``c``'s mask times ``x`` (a leaf's shape)."""
        if name in self.tiles:
            b, m = self.block, self.tiles[name][c]
            rows = x.reshape(-1, x.shape[-1])
            t = rows.reshape(m.shape[0], b, m.shape[1], b)
            return (t * m[:, None, :, None].to(x.dtype)).reshape(x.shape)
        if name in self.elems:
            return x * self.elems[name][c].to(x.dtype)
        return x


def quantize(g: torch.Tensor, delta: torch.Tensor,
             rand: torch.Tensor) -> torch.Tensor:
    """Eq. 16-17 per client row of the stacked (C, ...) leaf ``g``."""
    c = g.shape[0]
    view = (c,) + (1,) * (g.dim() - 1)
    a = g.abs()
    lo = a.reshape(c, -1).amin(dim=1).to(torch.float32).reshape(view)
    hi = a.reshape(c, -1).amax(dim=1).to(torch.float32).reshape(view)
    bits = torch.clamp(delta.to(torch.float32), min=1.0)
    n = torch.clamp(torch.round(torch.pow(2.0, bits)) - 1.0,
                    min=1.0).reshape(view)
    scale = (hi - lo) / n
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    t = (g.to(torch.float32).abs() - lo) / scale
    fl = torch.floor(t)
    level = torch.minimum(torch.clamp(fl + (rand < t - fl).to(torch.float32),
                                      min=0.0), n)
    mag = lo + level * scale
    q = torch.where(g.to(torch.float32) >= 0, mag, -mag).to(g.dtype)
    keep = (delta > 0).reshape(view)
    return torch.where(keep, q, g)


def uniforms(seed: int, n_clients: int, shapes: List[Tuple[int, ...]],
             device: torch.device):
    """The quantizer's draws: one (C, *shape) float32 tensor a leaf."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for s in shapes:
        yield torch.rand((n_clients,) + tuple(s), generator=gen,
                         device=device, dtype=torch.float32)


def drop_draw(seed: int, n_clients: int, device: torch.device
              ) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + DROP_STREAM)
    return torch.rand((n_clients,), generator=gen, device=device,
                      dtype=torch.float32)


def step(params: Tree, batches: List[Dict[str, torch.Tensor]],
         controls: Dict[str, torch.Tensor], seed: int, lr,
         loss_fn: Callable[[Tree, Dict[str, torch.Tensor]], torch.Tensor],
         prune_kind: str, block: int = 32
         ) -> Tuple[Tree, torch.Tensor, Tree]:
    """One LTFL step. ``batches[c]`` is client c's batch; ``lr`` a float
    or a 0-d tensor. Returns (new params, the mean client loss, the
    aggregated gradient in float32 as the optimizer takes it)."""
    n_clients = len(batches)
    device = next(iter(params.values())).device
    rho = controls["rho"].to(device)
    masks = Masks(params, rho, prune_kind, block)
    stacked = {k: torch.empty((n_clients,) + tuple(p.shape), dtype=p.dtype,
                              device=device) for k, p in params.items()}
    losses = []
    for c in range(n_clients):
        pruned = {k: masks.apply(k, p, c).detach().requires_grad_(True)
                  for k, p in params.items()}
        with torch.enable_grad():
            loss = loss_fn(pruned, batches[c])
            grads = torch.autograd.grad(loss, list(pruned.values()))
        losses.append(loss.detach().to(torch.float32))
        for (k, _), g in zip(pruned.items(), grads):
            stacked[k][c] = masks.apply(k, g, c)
        del pruned, grads, loss
    del masks
    delta = controls["delta"].to(device)
    if "alpha" in controls:
        alpha = controls["alpha"].to(device, torch.float32)
    else:
        alpha = (drop_draw(seed, n_clients, device)
                 >= controls["drop_prob"].to(device)).to(torch.float32)
    w = controls["weights"].to(device, torch.float32) * alpha
    received = w.sum()
    new, agg = {}, {}
    draws = uniforms(seed, n_clients, [tuple(p.shape) for p in
                                       params.values()], device)
    for (k, p), r in zip(params.items(), draws):
        q = quantize(stacked.pop(k), delta, r)
        del r
        s = torch.tensordot(w, q.to(torch.float32), dims=([0], [0]))
        g = torch.where(received > 0, s / torch.clamp(received, min=1e-12),
                        torch.zeros_like(s))
        agg[k] = g
        new[k] = p + (-lr * g).to(p.dtype)
    return new, torch.stack(losses).mean(), agg
