"""Pre-activation ResNet for the paper's CIFAR-10 experiments (Section 6).

Held against ``repro.models.resnet.ResNet``: the same blocks, the same
GroupNorm (min(8, C) groups of contiguous channels, eps 1e-5, population
variance) and the same parameter layout — convolutions stored HWIO, images
given NHWC — so weights carry across unchanged (``models.convert``). The
module runs NCHW inside: images are permuted once, kernels per call.

Padding is XLA's "SAME": for the stride-2 3x3 convolutions on an even
input it pads (0, 1), not (1, 1), so an asymmetric pad is applied
explicitly where the two sides differ.

The module's own parameters are placeholders on the ``meta`` device; real
weights are a ``Dict[str, Tensor]`` (from ``init`` or
``convert.params_from_numpy``) passed through
``torch.func.functional_call`` — ``apply``, ``loss`` and ``accuracy`` do
that, as the reference's ``forward(params, batch)`` does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from repro_torch.configs.ltfl_paper import ResNetConfig
from repro_torch.models.common import (
    ParamSpec,
    abstract_params,
    cross_entropy_loss,
    init_leaf,
)
from repro_torch.models.convert import in_leaf_order

Tree = Dict[str, torch.Tensor]
GN_GROUPS = 8


def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1
           ) -> torch.Tensor:
    """NCHW input, HWIO kernel, XLA "SAME" padding."""
    k = w_hwio.shape[0]
    w = w_hwio.permute(3, 2, 0, 1)
    top, bottom = _same_pads(x.shape[-2], k, stride)
    left, right = _same_pads(x.shape[-1], k, stride)
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, stride=stride)


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               groups: int = GN_GROUPS, eps: float = 1e-5) -> torch.Tensor:
    return F.group_norm(x, min(groups, x.shape[-3]), gamma, beta, eps)


def _placeholder(shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device="meta"),
                        requires_grad=False)


class _Norm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.gamma = _placeholder((c,))
        self.beta = _placeholder((c,))

    def forward(self, x):
        return group_norm(x, self.gamma, self.beta)


class _Block(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.gn1 = _Norm(cin)
        self.conv1 = _placeholder((3, 3, cin, cout))
        self.gn2 = _Norm(cout)
        self.conv2 = _placeholder((3, 3, cout, cout))
        self.proj = _placeholder((1, 1, cin, cout)) if cin != cout else None

    def forward(self, x):
        h = F.relu(self.gn1(x))
        shortcut = x
        if self.proj is not None:
            shortcut = conv2d(h, self.proj, self.stride)
        elif self.stride != 1:
            shortcut = x[:, :, ::self.stride, ::self.stride]
        h = conv2d(h, self.conv1, self.stride)
        h = F.relu(self.gn2(h))
        h = conv2d(h, self.conv2)
        return shortcut + h


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig = ResNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.stem = _placeholder((3, 3, cfg.in_channels, cfg.stem_channels))
        cin = cfg.stem_channels
        groups = []
        for gi, (cout, n_blocks) in enumerate(
                zip(cfg.group_channels, cfg.blocks_per_group)):
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (gi > 0 and bi == 0) else 1
                blocks.append(_Block(cin if bi == 0 else cout, cout, stride))
            groups.append(nn.ModuleList(blocks))
            cin = cout
        self.groups = nn.ModuleList(groups)
        self.head_gn = _Norm(cin)
        self.head_w = _placeholder((cin, cfg.num_classes))
        self.head_b = _placeholder((cfg.num_classes,))

    def param_specs(self) -> Dict[str, ParamSpec]:
        """Init recipe per parameter, in the reference's leaf order."""
        specs = {}
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            shape, f32 = tuple(p.shape), torch.float32
            axes = (None,) * len(shape)     # replicated, as the reference
            if leaf == "gamma":
                specs[name] = ParamSpec(shape, axes, "ones", dtype=f32)
            elif leaf in ("beta", "head_b"):
                specs[name] = ParamSpec(shape, axes, "zeros", dtype=f32)
            elif name == "head_w":
                specs[name] = ParamSpec(shape, axes, "normal", dtype=f32)
            else:
                specs[name] = ParamSpec(shape, axes, "normal", scale=1.4,
                                        dtype=f32)
        return in_leaf_order(specs)

    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None) -> Tree:
        """Fresh parameters from ``generator`` (drawn in leaf order)."""
        device = torch.device(device) if device is not None \
            else generator.device
        return {name: init_leaf(spec, generator, device)
                for name, spec in self.param_specs().items()}

    def abstract_params(self) -> Dict[str, torch.Tensor]:
        return abstract_params(self.param_specs())

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, C) -> logits (B, classes)."""
        # contiguous NCHW: a channels-last-strided input made the CPU
        # (oneDNN) convolution backward corrupt the heap on torch 2.13
        x = images.to(torch.float32).permute(0, 3, 1, 2).contiguous()
        x = conv2d(x, self.stem)
        for blocks in self.groups:
            for block in blocks:
                x = block(x)
        x = F.relu(self.head_gn(x))
        x = torch.mean(x, dim=(2, 3))                  # global average pool
        return x @ self.head_w + self.head_b

    # functional API, mirroring the reference's (params, batch) methods
    def apply(self, params: Tree, images: torch.Tensor) -> torch.Tensor:
        return functional_call(self, params, (images,))

    def loss(self, params: Tree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        return cross_entropy_loss(self.apply(params, batch["images"]),
                                  batch["labels"])

    def accuracy(self, params: Tree, batch: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
        logits = self.apply(params, batch["images"])
        return torch.mean((torch.argmax(logits, -1)
                           == batch["labels"].to(torch.int64))
                          .to(torch.float32))
