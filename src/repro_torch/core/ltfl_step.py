"""The LTFL federated round step (paper Eq. 8-20), edge form.

Held against ``repro.core.ltfl_step.make_fl_train_step`` with
``prune_kind="magnitude"``, host-sampled ``alpha`` and the optional
``agg_denom`` and ``lr`` controls. One call does all tensor work of a
round:

1. magnitude-prune the global weights per client (Eq. 12-13): each leaf
   is ranked once and every client keeps its own floor(rho_u n) cut, so
   the pruned weights come out stacked (C, ...);
2. per-client loss and gradient at the pruned weights with
   ``torch.func.vmap(torch.func.grad_and_value(...))`` over
   ``functional_call`` (vmap, not a loop over clients), then the mask
   (pruned coordinates are neither trained nor uploaded, Eq. 32);
3. the compressor on the STACKED (C, ...) gradients, outside the vmap —
   for LTFL one quantizer kernel launch per leaf covers all clients;
4. the sample-weighted aggregate over received clients (Eq. 19) and the
   SGD update (Eq. 20).

``controls`` (tensors on the step's device):
    rho        (C,) pruning ratios
    delta      (C,) quantization bit-widths (0 => passthrough)
    weights    (C,) sample counts N_u
    alpha      (C,) host-sampled transmission outcomes (Eq. 4)
    agg_denom  () optional fixed normalizer (unbiased participation)
    lr         () optional learning rate, routed to ``update_with_lr``

Block pruning (the datacenter step's ``prune_kind="block"``) and the
in-step packet-drop draw are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.aggregation import aggregate
from repro_torch.core.compressors import (
    Compressor,
    identity_compressor,
    ltfl_quantizer,
)
from repro_torch.core.pruning import magnitude_prune_pytree
from repro_torch.core.quantization import range_sq_sum
from repro_torch.optim import Optimizer, apply_updates, global_norm

Tree = Dict[str, torch.Tensor]


def make_fl_train_step(model, optimizer: Optimizer, n_clients: int, *,
                       quantize: bool = True,
                       prune: bool = True,
                       prune_kind: str = "magnitude",
                       compressor: Optional[Compressor] = None) -> Callable:
    """Build step(params, opt_state, comp_state, batch, controls, seed)
    -> (params, opt_state, comp_state, metrics).

    ``batch`` leaves carry a leading client axis C == n_clients;
    ``seed`` is the round's integer seed, handed to the compressor.
    ``compressor`` None picks the LTFL quantizer (or identity when
    ``quantize`` is False)."""
    if prune_kind != "magnitude":
        raise ValueError(f"prune_kind={prune_kind!r}: only 'magnitude' "
                         "is ported (block pruning is queued)")
    if compressor is None:
        compressor = ltfl_quantizer() if quantize else identity_compressor()
    comp = compressor

    def client_loss(p: Tree, cbatch: Dict[str, torch.Tensor]
                    ) -> torch.Tensor:
        return model.loss(p, cbatch)

    per_client = grad_and_value(client_loss)

    def step(params: Tree, opt_state: Any, comp_state: Any,
             batch: Dict[str, torch.Tensor],
             controls: Dict[str, torch.Tensor], seed: int
             ) -> Tuple[Tree, Any, Any, Dict[str, torch.Tensor]]:
        if prune:
            pruned, masks = magnitude_prune_pytree(params, controls["rho"])
        else:
            pruned, masks = params, None
        # stacked leaves (pruned per client) map over dim 0; shared
        # leaves (1-D, exempt from pruning) are broadcast
        in_dims = {k: 0 if v.dim() > params[k].dim() else None
                   for k, v in pruned.items()}
        grads, losses = vmap(per_client, in_dims=(in_dims, 0))(
            pruned, batch)
        if prune:
            grads = {k: g * masks[k].to(g.dtype) for k, g in grads.items()}
        rsqs = range_sq_sum(grads, client_axis=True)
        grads, comp_state = comp.compress(grads, controls["delta"], seed,
                                          comp_state)

        alpha = controls["alpha"].to(torch.float32)
        g = aggregate(grads, controls["weights"], alpha,
                      denom=controls.get("agg_denom"))
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
        params = apply_updates(params, updates)                 # Eq. 20
        metrics = {
            "loss": torch.mean(losses),
            "grad_norm": global_norm(g),
            "clients_received": torch.sum(alpha),
            "range_sq": rsqs,
            "range_sq_mean": torch.mean(rsqs),
        }
        return params, opt_state, comp_state, metrics

    step.compressor = comp
    step.init_comp_state = lambda params: comp.init_state(params, n_clients)
    return step
