"""Minimal optax-style optimizers on parameter dicts.

Held against ``repro.optim.optimizers`` (``sgd``, ``momentum`` (lines
62-77), ``adamw`` (lines 80-110), ``_tree_zeros_f32`` (line 38),
``apply_updates``, ``global_norm``). The paper's devices run plain
gradient descent (Eq. 10), so ``sgd`` is the paper-faithful default;
``momentum`` and ``adamw`` are provided for the datacenter-scale configs.
API: ``init(params) -> state``; ``update(grads, state, params) ->
(updates, state)``; ``update_with_lr(grads, state, params, lr)`` takes
the rate as a tensor instead of the constructor's; updates are *added* to
params by ``apply_updates``. ``update`` is ``update_with_lr`` at the
baked rate, so a laned rate (``controls["lr"]`` in
``repro_torch.core.ltfl_step``) of the same float32 value gives the same
bits. State leaves are float32 whatever the parameters' dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], Tuple[Tree, Any]]
    update_with_lr: Optional[
        Callable[[Tree, Any, Tree, torch.Tensor], Tuple[Tree, Any]]] = None


def _tree_zeros_f32(params: Tree) -> Tree:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def sgd(lr: float) -> Optimizer:
    """Plain GD (paper Eq. 10: w <- w - eta g)."""

    def init(params):
        return ()

    def update_with_lr(grads, state, params, eta):
        updates = {k: (-eta * g.to(torch.float32)).to(params[k].dtype)
                   for k, g in grads.items()}
        return updates, state

    def update(grads, state, params):
        return update_with_lr(grads, state, params, lr)

    return Optimizer(init, update, update_with_lr)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    """Heavy-ball momentum: m <- beta m + g (float32), update -eta m."""

    def init(params):
        return {"m": _tree_zeros_f32(params)}

    def update_with_lr(grads, state, params, eta):
        m = {k: beta * mo + grads[k].to(torch.float32)
             for k, mo in state["m"].items()}
        updates = {k: (-eta * mo).to(params[k].dtype) for k, mo in m.items()}
        return updates, {"m": m}

    def update(grads, state, params):
        return update_with_lr(grads, state, params, lr)

    return Optimizer(init, update, update_with_lr)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """Adam with decoupled weight decay. The step count ``t`` is an int32
    scalar tensor on the parameters' device; the bias corrections are
    1 - b ** t in float32."""

    def init(params):
        device = next(iter(params.values())).device
        return {"m": _tree_zeros_f32(params), "v": _tree_zeros_f32(params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update_with_lr(grads, state, params, eta):
        t = state["t"] + 1
        m = {k: b1 * mo + (1 - b1) * grads[k].to(torch.float32)
             for k, mo in state["m"].items()}
        v = {k: b2 * vo + (1 - b2) * torch.square(grads[k].to(torch.float32))
             for k, vo in state["v"].items()}
        tf = t.to(torch.float32)
        bc1 = 1.0 - b1 ** tf
        bc2 = 1.0 - b2 ** tf

        def upd(k):
            step = m[k] / bc1 / (torch.sqrt(v[k] / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * params[k].to(torch.float32)
            return (-eta * step).to(params[k].dtype)

        return {k: upd(k) for k in m}, {"m": m, "v": v, "t": t}

    def update(grads, state, params):
        return update_with_lr(grads, state, params, lr)

    return Optimizer(init, update, update_with_lr)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {k: p + updates[k] for k, p in params.items()}


def global_norm(tree: Tree, reduce_sum: Optional[Callable] = None
                ) -> torch.Tensor:
    """The L2 norm of every leaf together, in float32. When each leaf is
    one shard, ``reduce_sum(name, s)`` sums its squares over the whole
    leaf (the sharded step's all-reduce)."""
    total = None
    for name, x in tree.items():
        s = torch.sum(torch.square(x.to(torch.float32)))
        if reduce_sum is not None:
            s = reduce_sum(name, s)
        total = s if total is None else total + s
    return torch.sqrt(total)
