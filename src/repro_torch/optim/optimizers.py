"""Minimal optax-style optimizers on parameter dicts.

Held against ``repro.optim.optimizers`` (``sgd``, ``apply_updates``,
``global_norm``). The paper's devices run plain gradient descent
(Eq. 10). API: ``init(params) -> state``; ``update(grads, state, params)
-> (updates, state)``; ``update_with_lr(grads, state, params, lr)`` takes
the rate as a tensor instead of the constructor's; updates are *added* to
params by ``apply_updates``.
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


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {k: p + updates[k] for k, p in params.items()}


def global_norm(tree: Tree) -> torch.Tensor:
    total = None
    for x in tree.values():
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)
