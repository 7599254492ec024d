"""Gradient compressor stages for the round step (``core.ltfl_step``).

Held against ``repro.core.compressors`` (``Compressor``,
``identity_compressor``, ``ltfl_quantizer``, ``sign_compressor``,
``stc_compressor``, ``get_compressor``). A ``Compressor`` maps the
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

The paper's Section-6.1 baselines: FedSGD and FedMP upload full
precision (``identity_compressor``), SignSGD the sign with a server
majority vote (``sign_compressor``), STC sparse ternary codes with an
error-feedback residual (``stc_compressor``). None of them draws random
numbers.
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


def sign_compressor(lr_scale: float = 0.02) -> Compressor:
    """SignSGD: sign(g) on the uplink (1 bit a coordinate); the server
    signs the aggregate and scales it by ``lr_scale`` (majority vote)."""

    def compress(g: Tree, delta: torch.Tensor, seed: int, state):
        return {k: torch.sign(x) for k, x in g.items()}, state

    def server_transform(agg: Tree) -> Tree:
        return {k: (torch.sign(x) * lr_scale).to(x.dtype)
                for k, x in agg.items()}

    return Compressor(name="sign", compress=compress,
                      server_transform=server_transform)


def stc_compressor(sparsity: float = 0.01) -> Compressor:
    """Sparse ternary compression with a carried error-feedback residual.

    The state is one (C, ...) float32 residual per leaf. Per client and
    leaf: acc = g + residual; keep the k = max(int(sparsity * leaf size),
    1) largest |acc| (every entry >= the k-th largest, so ties keep all
    equal entries); send sign(acc) * mu on the kept entries, mu the mean
    kept magnitude; the residual becomes acc minus what was sent."""

    def init_state(params: Tree, n_clients: int) -> Tree:
        return {k: torch.zeros((n_clients,) + tuple(p.shape),
                               dtype=torch.float32, device=p.device)
                for k, p in params.items()}

    def ternarize(acc: torch.Tensor) -> torch.Tensor:
        """Row by row of the stacked (C, ...) leaf."""
        a = acc.abs().reshape(acc.shape[0], -1)
        k = max(int(sparsity * a.shape[1]), 1)
        thresh = torch.topk(a, k, dim=1, sorted=False).values.amin(dim=1)
        keep = (a >= thresh[:, None]).to(torch.float32)
        mu = torch.sum(a * keep, dim=1) \
            / torch.clamp(torch.sum(keep, dim=1), min=1.0)
        tern = torch.sign(acc.reshape(a.shape)) * mu[:, None] * keep
        return tern.reshape(acc.shape)

    def compress(g: Tree, delta: torch.Tensor, seed: int, residual: Tree):
        wire, new_residual = {}, {}
        for k, x in g.items():
            acc = x.to(torch.float32) + residual[k]
            tern = ternarize(acc)
            new_residual[k] = acc - tern
            wire[k] = tern.to(x.dtype)
        return wire, new_residual

    return Compressor(name="stc", compress=compress, init_state=init_state)


_REGISTRY = {
    "none": identity_compressor,
    "ltfl": ltfl_quantizer,
    "sign": sign_compressor,
    "stc": stc_compressor,
}


def get_compressor(spec, **kwargs) -> Compressor:
    """A ``Compressor`` as given, or one made by name from the registry."""
    if isinstance(spec, Compressor):
        return spec
    if spec in _REGISTRY:
        return _REGISTRY[spec](**kwargs)
    raise KeyError(f"unknown compressor {spec!r}; have {sorted(_REGISTRY)}")
