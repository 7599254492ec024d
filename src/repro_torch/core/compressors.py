"""Gradient compressor stages for the round step (``core.ltfl_step``).

Held against ``repro.core.compressors`` (``Compressor``,
``identity_compressor``, ``ltfl_quantizer``). A ``Compressor`` maps the
STACKED (C, ...) per-client gradient dict to what goes over the air,
optionally carrying per-client state, plus a server-side transform of
the aggregate. The reference vmaps ``compress`` over clients; here it
runs once on the stacked gradients, outside the per-client vmap, so each
kernel launch covers all C clients of one leaf and the kernel needs no
vmap rule.

Contract:

    init_state(params, n_clients) -> state
    compress(grads (C, ...), delta (C,), seed, state) -> (grads, state)
    server_transform(aggregated) -> aggregated

``seed`` is the round's integer seed (the reference's round key is
``PRNGKey(seed)``). Randomness: by default ``ltfl_quantizer`` seeds a
``torch.Generator`` on the gradients' device with it and draws one
(C, *leaf.shape) uniform tensor per leaf, in the tree's (the reference's)
leaf order, each just before that leaf's quantizer launch: only one
leaf's uniforms are held at a time (all of them at once would be 13.4 GB
on granite-8b's widths at 2 layers and 4 clients). ``uniforms`` replaces
that draw: a callable ``(seed, n_clients, shapes) -> iterable of tensors
(C, *shape), one per leaf`` — the parity tests feed the reference's own
draws through it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, Iterator, Optional,
                    Sequence, Tuple)

import torch

from repro_torch.kernels import ops

Tree = Dict[str, torch.Tensor]
UniformSource = Callable[[int, int, Sequence[Tuple[int, ...]]],
                         Iterable[torch.Tensor]]


@dataclass(frozen=True)
class Compressor:
    """One scheme's compression stage (see module docstring)."""

    name: str
    compress: Callable[[Tree, torch.Tensor, int, Any], Tuple[Tree, Any]]
    init_state: Callable[[Tree, int], Any] = \
        field(default=lambda params, n_clients: ())
    server_transform: Callable[[Tree], Tree] = field(default=lambda g: g)


def identity_compressor() -> Compressor:
    """Full-precision uplink."""
    return Compressor(name="none", compress=lambda g, d, s, st: (g, st))


def torch_uniforms(seed: int, n_clients: int,
                   shapes: Sequence[Tuple[int, ...]],
                   device: torch.device) -> Iterator[torch.Tensor]:
    """The port's own draws: a generator on ``device`` seeded with the
    round seed, one (C, *shape) uniform tensor per leaf, in order, each
    drawn when the caller asks for it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for s in shapes:
        yield torch.rand((n_clients,) + tuple(s), generator=gen,
                         device=device, dtype=torch.float32)


def ltfl_quantizer(*, uniforms: Optional[UniformSource] = None
                   ) -> Compressor:
    """Stochastic uniform quantization at per-client delta (Eq. 16-17).

    Every leaf goes through the kernel wrapper as one (C, L) launch at
    bits = max(delta, 1); a client with delta <= 0 passes its gradient
    through unchanged (the paper's no-quant ablation)."""

    def compress(g: Tree, delta: torch.Tensor, seed: int, state):
        leaves = list(g.values())
        n_clients = leaves[0].shape[0]
        shapes = [tuple(x.shape[1:]) for x in leaves]
        device = leaves[0].device
        if uniforms is None:
            rands = torch_uniforms(seed, n_clients, shapes, device)
        else:
            rands = uniforms(seed, n_clients, shapes)
        delta = delta.to(device=device, dtype=torch.float32)
        bits = torch.clamp(delta, min=1.0)
        out = {}
        for (name, x), r in zip(g.items(), rands):
            q = ops.quantize_dequantize_2d_dyn(
                x.reshape(n_clients, -1),
                bits, rand=r.to(device).reshape(n_clients, -1))
            del r            # free this leaf's uniforms before the next draw
            keep = (delta > 0).reshape((n_clients,) + (1,) * (x.dim() - 1))
            out[name] = torch.where(keep, q.reshape(x.shape), x)
        return out, state

    return Compressor(name="ltfl", compress=compress)
