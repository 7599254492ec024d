"""A small MLP classifier for the wireless-FL simulator.

Held against ``repro.models.mlp`` (``MLPConfig``, ``MLP``): flatten ->
(dense -> relu)* -> dense logits over the same ``{"images", "labels"}``
batches as the ResNet, with the same ``init`` / ``loss`` / ``accuracy``
contract, so the round engine can run it where the engine rather than
the convolutions is under study. Images are given NHWC and flattened in
that order, as the reference does; ``downsample`` d > 1 strides H and W
by d first (32x32x3 -> 8x8x3 = 192 features at d = 4).

Parameters ``w{i}`` (d_in, d_out) and ``b{i}`` (d_out,) float32, as the
reference's; ``w{i}`` is drawn normal * 1/sqrt(d_in), ``b{i}`` is zeros.
The module's own parameters are ``meta`` placeholders; real weights are
a ``Dict[str, Tensor]`` passed through ``torch.func.functional_call``
(``apply``, ``loss``, ``accuracy``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from repro_torch.models.common import ParamSpec, cross_entropy_loss, init_leaf
from repro_torch.models.convert import in_leaf_order

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class MLPConfig:
    input_shape: Tuple[int, ...] = (32, 32, 3)   # flattened on entry
    hidden: Tuple[int, ...] = (32,)
    num_classes: int = 10
    downsample: int = 1     # spatial stride on (H, W, C) inputs


class MLP(nn.Module):
    def __init__(self, cfg: MLPConfig = MLPConfig()):
        super().__init__()
        self.cfg = cfg
        dims = (self._num_features(), *cfg.hidden, cfg.num_classes)
        self.n_layers = len(dims) - 1
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            self.register_parameter(f"w{i}", nn.Parameter(
                torch.empty((d_in, d_out), device="meta"),
                requires_grad=False))
            self.register_parameter(f"b{i}", nn.Parameter(
                torch.empty((d_out,), device="meta"), requires_grad=False))

    def _num_features(self) -> int:
        shape = self.cfg.input_shape
        d = self.cfg.downsample
        if d > 1 and len(shape) == 3:
            shape = (-(-shape[0] // d), -(-shape[1] // d), shape[2])
        return math.prod(shape)

    def param_specs(self) -> Dict[str, ParamSpec]:
        """Init recipe per parameter, in the reference's leaf order."""
        specs = {}
        for name, p in self.named_parameters():
            kind = "normal" if name.startswith("w") else "zeros"
            specs[name] = ParamSpec(tuple(p.shape), (None,) * p.dim(), kind,
                                    dtype=torch.float32)
        return in_leaf_order(specs)

    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None) -> Tree:
        """Fresh parameters from ``generator`` (drawn in leaf order)."""
        device = torch.device(device) if device is not None \
            else generator.device
        return {name: init_leaf(spec, generator, device)
                for name, spec in self.param_specs().items()}

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, C) (or (B, features)) -> logits (B, classes)."""
        x = images.to(torch.float32)
        d = self.cfg.downsample
        if d > 1 and x.dim() == 4:
            x = x[:, ::d, ::d, :]
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_layers):
            x = x @ getattr(self, f"w{i}") + getattr(self, f"b{i}")
            if i < self.n_layers - 1:
                x = F.relu(x)
        return x

    # functional API, mirroring the reference's (params, batch) methods
    def apply(self, params: Tree, images: torch.Tensor) -> torch.Tensor:
        return functional_call(self, params, (images,))

    def logits(self, params: Tree, batch: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
        return self.apply(params, batch["images"])

    def loss(self, params: Tree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        return cross_entropy_loss(self.logits(params, batch),
                                  batch["labels"])

    def accuracy(self, params: Tree, batch: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
        logits = self.logits(params, batch)
        return torch.mean((torch.argmax(logits, -1)
                           == batch["labels"].to(torch.int64))
                          .to(torch.float32))
