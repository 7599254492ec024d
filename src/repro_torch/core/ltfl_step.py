"""The LTFL federated round step (paper Eq. 8-20).

Held against ``repro.core.ltfl_step.make_fl_train_step``: both prune
kinds (``"magnitude"``, the edge step; ``"block"``, the datacenter
step, with ``prune_block``), host-sampled ``alpha`` or the in-step
packet-drop draw from ``drop_prob``, the optional ``agg_denom`` and
``lr`` controls, a compressor given by registry name, and the int8 wire
format (``int8_collective``); and against ``make_plain_train_step``.
One call does all tensor work of a round:

1. prune the global weights per client (Eq. 12-13): each leaf's
   importance is computed and ranked once (for block pruning the tile
   norms are the ``block_norms`` kernel) and every client keeps its own
   floor(rho_c n) cut, so the pruned weights come out stacked (C, ...)
   (for block pruning one ``apply_block_mask`` launch per leaf);
2. per-client loss and gradient at the pruned weights with
   ``torch.func.vmap(torch.func.grad_and_value(...))`` (vmap, not a loop
   over clients), then the masks (pruned coordinates are neither trained
   nor uploaded, Eq. 32; tile masks through ``apply_block_mask`` again);
3. the compressor on the STACKED (C, ...) gradients, outside the vmap —
   for LTFL one quantizer kernel launch per leaf covers all clients;
4. the packet outcomes: the host's ``alpha``, or alpha = uniform(C) >=
   drop_prob (Eq. 4) drawn in the step;
5. the sample-weighted aggregate over received clients (Eq. 19) and the
   optimizer's update (Eq. 20).

``int8_collective`` (reference lines 68, 97-100, 143-160) replaces step
3 with the reference's wire format for its cross-client all-gather: per
client and leaf, symmetric stochastic int8 levels at scale max(max|g| /
127, 1e-30) (``quantization.quantize_int8``), dequantized to bfloat16
and aggregated, so the aggregate is bfloat16 whatever the parameters'
dtype, as in the reference. On one card there is no gather; the levels
are what would cross it. ``delta`` is ignored, the compressor's state
passes through and the B1 quantizer is not launched; with ``quantize``
False the flag has no effect, and with an explicit ``compressor`` it
raises. Its uniforms are drawn as the LTFL quantizer's are (one (C,
*leaf) tensor at a time); ``int8_uniforms`` replaces that draw, shaped
like ``ltfl_quantizer(uniforms=...)``.

``controls`` (tensors on the step's device):
    rho        (C,) pruning ratios
    delta      (C,) quantization bit-widths (0 => passthrough)
    weights    (C,) sample counts N_u
    alpha      (C,) host-sampled transmission outcomes (Eq. 4), OR
    drop_prob  (C,) packet error rates, drawn against in the step
    agg_denom  () optional fixed normalizer (unbiased participation)
    lr         () optional learning rate, routed to ``update_with_lr``

Randomness: the reference splits ``PRNGKey(seed)`` into C + 1 keys, the
first C for the quantizer and the last for the drop draw. The port's
quantizer seeds its own generator with ``seed`` (``core.compressors``);
the drop draw uses a generator on the step's device seeded with
``seed + DROP_STREAM``, a stream of its own. ``drop_uniforms`` replaces
that draw: a callable ``(seed, n_clients) -> (C,) tensor`` — the parity
tests feed the reference's own draw through it.

Lanes: ``step.lanes`` runs L independent experiments (sweep lanes, each
with its own parameters, controls and seed) as ONE step over L * C
clients: each lane prunes its own weights (ranked within the lane), the
lanes' per-client stacks are concatenated on the client axis (a lane's
shared 1-D leaves expanded per client), one vmap computes every client's
gradient, and the gate and the compressor run on the (L * C, ...) stack —
one quantizer launch per leaf for the whole bucket. Aggregation and the
update then run per lane. ``batch`` is (L * C, B, ...) and
``comp_state`` covers L * C clients. With one lane it is exactly
``step``. The reference vmaps its step over lanes instead; here the
quantizer is a ctypes call on a data pointer, which ``vmap`` cannot
batch.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.aggregation import aggregate
from repro_torch.core.compressors import (
    Compressor,
    UniformSource,
    get_compressor,
    identity_compressor,
    lane_uniforms,
    ltfl_quantizer,
)
from repro_torch.core.pruning import (
    gate_pytree,
    magnitude_prune_pytree,
    prune_pytree,
)
from repro_torch.core.quantization import (
    dequantize_int8,
    quantize_int8_clients,
    range_sq_sum,
)
from repro_torch.optim import Optimizer, apply_updates, global_norm

Tree = Dict[str, torch.Tensor]
DropSource = Callable[[int, int], torch.Tensor]
DROP_STREAM = 1 << 32


def torch_drop_uniforms(seed: int, n_clients: int,
                        device: torch.device) -> torch.Tensor:
    """The port's own drop draw: (C,) uniforms from a generator on
    ``device`` seeded with ``seed + DROP_STREAM`` (empty on the meta
    device)."""
    if device.type == "meta":
        return torch.empty((n_clients,), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + DROP_STREAM)
    return torch.rand((n_clients,), generator=gen, device=device,
                      dtype=torch.float32)


def make_fl_train_step(model, optimizer: Optimizer, n_clients: int, *,
                       prune_block: int = 128,
                       quantize: bool = True,
                       prune: bool = True,
                       prune_kind: str = "block",
                       simulate_drops: bool = True,
                       compressor: Union[Compressor, str, None] = None,
                       drop_uniforms: Optional[DropSource] = None,
                       int8_collective: bool = False,
                       int8_uniforms: Optional[UniformSource] = None,
                       param_shardings=None,
                       gather_shardings=None
                       ) -> Callable:
    """Build step(params, opt_state, comp_state, batch, controls, seed)
    -> (params, opt_state, comp_state, metrics).

    ``batch`` leaves carry a leading client axis C == n_clients;
    ``seed`` is the round's integer seed (the reference's key is
    ``PRNGKey(seed)``). ``compressor`` is a ``Compressor``, a registry
    name (``get_compressor``) or None, which picks the LTFL quantizer (or
    identity when ``quantize`` is False). Without ``controls["alpha"]``
    every client is received (``simulate_drops`` False) or drops with
    probability ``controls["drop_prob"]``. ``int8_collective``: see the
    module docstring.

    ``param_shardings`` (``launch.sharding.NamedSharding`` per leaf,
    shaped like the STACKED (C, ...) gradients, as the reference's) makes
    this the step over their mesh, ``core.sharded_step``: params and
    batch are DTensors and ``gather_shardings`` lays out the int8
    levels' all-gather. With both None the step is the one-device step
    above."""
    if compressor is None:
        comp = ltfl_quantizer() if quantize else identity_compressor()
    else:
        if int8_collective:
            raise ValueError(
                "int8_collective is a wire-format override; "
                "pass compressor=None")
        comp = get_compressor(compressor)
    if prune_kind not in ("block", "magnitude"):
        raise ValueError(f"prune_kind={prune_kind!r}")
    int8_wire = quantize and int8_collective
    per_client = grad_and_value(model.loss)

    def _prune(params: Tree, rho: torch.Tensor) -> Tuple[Tree, Tree]:
        if prune_kind == "magnitude":
            return magnitude_prune_pytree(params, rho)
        return prune_pytree(params, rho, block=prune_block)

    def _alpha(controls: Dict[str, torch.Tensor], seed: int,
               device: torch.device) -> torch.Tensor:
        if "alpha" in controls:                     # host-sampled channel
            return controls["alpha"].to(torch.float32)
        if not simulate_drops:
            return torch.ones((n_clients,), dtype=torch.float32,
                              device=device)
        u = (torch_drop_uniforms(seed, n_clients, device)
             if drop_uniforms is None else drop_uniforms(seed, n_clients))
        return (u.to(device) >= controls["drop_prob"]).to(torch.float32)

    def lanes(params_l: Sequence[Tree], opt_states: Sequence[Any],
              comp_state: Any, batch: Dict[str, torch.Tensor],
              controls_l: Sequence[Dict[str, torch.Tensor]],
              seeds: Sequence[Any]
              ) -> Tuple[List[Tree], List[Any], Any,
                         List[Dict[str, torch.Tensor]]]:
        n_lanes = len(params_l)
        pruned_l, masks_l = [], []
        for params, ctl in zip(params_l, controls_l):
            p, m = _prune(params, ctl["rho"]) if prune else (params, None)
            pruned_l.append(p)
            masks_l.append(m)
        ref = params_l[0]
        if n_lanes == 1:
            pruned, masks = pruned_l[0], masks_l[0]
            # stacked leaves (pruned per client) map over dim 0; shared
            # leaves (1-D, exempt from pruning) are broadcast
            in_dims = {k: 0 if v.dim() > ref[k].dim() else None
                       for k, v in pruned.items()}
        else:
            # the lanes' clients folded into one client axis: a shared
            # leaf is expanded per client of its own lane
            pruned = {k: torch.cat([_per_client(p[k], ref[k], n_clients)
                                    for p in pruned_l]) for k in ref}
            masks = None if not prune else {
                k: (torch.cat([m[k] for m in masks_l])
                    if masks_l[0][k].dim() > ref[k].dim() else masks_l[0][k])
                for k in ref}
            in_dims = {k: 0 for k in ref}
        del pruned_l, masks_l
        grads, losses = vmap(per_client, in_dims=(in_dims, 0))(
            pruned, batch)
        del pruned               # C weight copies: free before compressing
        if prune:
            grads = gate_pytree(grads, masks, prune_block)
        rsqs = range_sq_sum(grads, client_axis=True)
        seed = seeds[0] if n_lanes == 1 else tuple(seeds)
        if int8_wire:
            grads = _int8_wire(grads, seed, int8_uniforms)
        else:
            delta = (controls_l[0]["delta"] if n_lanes == 1 else
                     torch.cat([c["delta"] for c in controls_l]))
            grads, comp_state = comp.compress(grads, delta, seed, comp_state)

        rows = [slice(i * n_clients, (i + 1) * n_clients)
                for i in range(n_lanes)]
        lane_grads = [grads] if n_lanes == 1 else [
            {k: v[r] for k, v in grads.items()} for r in rows]
        del grads          # each lane's share is freed once aggregated
        out_params, out_opt, out_metrics = [], [], []
        for i, (params, opt_state, controls, seed) in enumerate(
                zip(params_l, opt_states, controls_l, seeds)):
            alpha = _alpha(controls, seed, losses.device)
            g = aggregate(lane_grads[i], controls["weights"], alpha,
                          denom=controls.get("agg_denom"))
            lane_grads[i] = None
            g = comp.server_transform(g)
            lr = controls.get("lr")
            if lr is None:
                updates, opt_state = optimizer.update(g, opt_state, params)
            elif optimizer.update_with_lr is None:
                raise ValueError("controls['lr'] needs an optimizer with "
                                 "update_with_lr")
            else:
                updates, opt_state = optimizer.update_with_lr(
                    g, opt_state, params, lr)
            out_params.append(apply_updates(params, updates))   # Eq. 20
            out_opt.append(opt_state)
            lane_rsqs = rsqs[rows[i]]
            out_metrics.append({
                "loss": torch.mean(losses[rows[i]]),
                "grad_norm": global_norm(g),
                "clients_received": torch.sum(alpha),
                "range_sq": lane_rsqs,
                "range_sq_mean": torch.mean(lane_rsqs),
            })
        return out_params, out_opt, comp_state, out_metrics

    def step(params: Tree, opt_state: Any, comp_state: Any,
             batch: Dict[str, torch.Tensor],
             controls: Dict[str, torch.Tensor], seed
             ) -> Tuple[Tree, Any, Any, Dict[str, torch.Tensor]]:
        p, o, c, m = lanes([params], [opt_state], comp_state, batch,
                           [controls], [seed])
        return p[0], o[0], c, m[0]

    if param_shardings is not None:
        from repro_torch.core.sharded_step import make_sharded_step
        sharded = make_sharded_step(
            model_loss_grad=per_client, optimizer=optimizer,
            n_clients=n_clients, comp=comp,
            prune=_prune, prune_kind=prune_kind, prune_block=prune_block,
            do_prune=prune,
            int8_wire=int8_wire, int8_uniforms=int8_uniforms,
            alpha_fn=_alpha, param_shardings=param_shardings,
            gather_shardings=gather_shardings)
        sharded.compressor = comp
        sharded.init_comp_state = \
            lambda params: comp.init_state(params, n_clients)
        return sharded

    step.compressor = comp
    step.lanes = lanes
    step.init_comp_state = lambda params: comp.init_state(params, n_clients)
    return step


def make_plain_train_step(model, optimizer: Optimizer) -> Callable:
    """Non-federated step on one global batch: step(params, opt_state,
    batch, seed) -> (params, opt_state, {"loss", "grad_norm"}). No client
    axis, no pruning, no quantizer; ``seed`` is unused, as the
    reference's key is. Held against
    ``repro.core.ltfl_step.make_plain_train_step`` (lines 204-214)."""
    loss_and_grad = grad_and_value(model.loss)

    def step(params: Tree, opt_state: Any, batch: Dict[str, torch.Tensor],
             seed) -> Tuple[Tree, Any, Dict[str, torch.Tensor]]:
        g, loss = loss_and_grad(params, batch)
        updates, opt_state = optimizer.update(g, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "grad_norm": global_norm(g)}

    return step


def _int8_wire(grads: Tree, seed, uniforms: Optional[UniformSource]
               ) -> Tree:
    """The int8 wire format of the stacked (C, ...) gradients: per client
    and leaf, int8 levels and a float32 scale, dequantized to bfloat16.
    One leaf's uniforms are held at a time."""
    leaves = list(grads.values())
    n_clients = leaves[0].shape[0]
    device = leaves[0].device
    shapes = [tuple(x.shape[1:]) for x in leaves]
    rands = lane_uniforms(seed, n_clients, shapes, device, uniforms)
    out = {}
    for (name, x), r in zip(grads.items(), rands):
        levels, scales = quantize_int8_clients(x, r.to(device))
        del r
        view = (n_clients,) + (1,) * (x.dim() - 1)
        out[name] = dequantize_int8(levels, scales.reshape(view))
    return out


def _per_client(x: torch.Tensor, leaf: torch.Tensor,
                n_clients: int) -> torch.Tensor:
    """A pruned leaf as (C, ...): a per-client stack as it is, a shared
    leaf (1-D, exempt from pruning) expanded over the clients."""
    if x.dim() > leaf.dim():
        return x
    return x.expand((n_clients,) + tuple(x.shape))
