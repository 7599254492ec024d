"""The paper's pre-activation ResNet (Section 6) in plain PyTorch, float32.

A 3x3 stem, then groups of pre-activation blocks (GroupNorm of min(8,
C) groups, eps 1e-5; ReLU; 3x3 convolutions; the first block of every
group after the first strides 2; a 1x1 projection on the normed input
where the width changes), a final GroupNorm and ReLU, global average
pooling and a linear head; the loss is the mean cross-entropy.
Convolutions pad as XLA's "SAME" (for a stride-2 3x3 convolution on an
even size: 0 before, 1 after). Weights are stored HWIO and images come
NHWC, the layout both sides share.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Tree = Dict[str, torch.Tensor]


def _blocks(cfg: dict):
    cin = cfg["stem_channels"]
    for gi, (cout, n) in enumerate(zip(cfg["group_channels"],
                                       cfg["blocks_per_group"])):
        for bi in range(n):
            yield (f"groups.{gi}.{bi}.", cin if bi == 0 else cout, cout,
                   2 if (gi > 0 and bi == 0) else 1)
        cin = cout


def spec(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Every leaf's shape and init ("conv": std 1.4/sqrt(fan in),
    "normal": std 1/sqrt(fan in), "ones", "zeros")."""
    out = {"stem": ((3, 3, cfg["in_channels"], cfg["stem_channels"]),
                    "conv")}
    cin = cfg["stem_channels"]
    for p, ci, co, _ in _blocks(cfg):
        out.update({p + "gn1.gamma": ((ci,), "ones"),
                    p + "gn1.beta": ((ci,), "zeros"),
                    p + "conv1": ((3, 3, ci, co), "conv"),
                    p + "gn2.gamma": ((co,), "ones"),
                    p + "gn2.beta": ((co,), "zeros"),
                    p + "conv2": ((3, 3, co, co), "conv")})
        if ci != co:
            out[p + "proj"] = ((1, 1, ci, co), "conv")
        cin = co
    out.update({"head_gn.gamma": ((cin,), "ones"),
                "head_gn.beta": ((cin,), "zeros"),
                "head_w": ((cin, cfg["num_classes"]), "normal"),
                "head_b": ((cfg["num_classes"],), "zeros")})
    return out


def _pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1
         ) -> torch.Tensor:
    k = w_hwio.shape[0]
    top, bottom = _pads(x.shape[-2], k, stride)
    left, right = _pads(x.shape[-1], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), stride=stride)


def _gn(x: torch.Tensor, p: Tree, name: str) -> torch.Tensor:
    return F.group_norm(x, min(8, x.shape[1]), p[name + ".gamma"],
                        p[name + ".beta"], 1e-5)


def logits(params: Tree, images: torch.Tensor, cfg: dict) -> torch.Tensor:
    x = images.to(torch.float32).permute(0, 3, 1, 2).contiguous()
    x = conv(x, params["stem"])
    for p, ci, co, stride in _blocks(cfg):
        h = F.relu(_gn(x, params, p + "gn1"))
        if ci != co:
            short = conv(h, params[p + "proj"], stride)
        else:
            short = x[:, :, ::stride, ::stride]
        h = conv(h, params[p + "conv1"], stride)
        h = conv(F.relu(_gn(h, params, p + "gn2")), params[p + "conv2"])
        x = short + h
    x = torch.mean(F.relu(_gn(x, params, "head_gn")), dim=(2, 3))
    return x @ params["head_w"] + params["head_b"]


def loss(params: Tree, batch: Dict[str, torch.Tensor], cfg: dict
         ) -> torch.Tensor:
    lf = logits(params, batch["images"], cfg)
    return F.cross_entropy(lf, batch["labels"].to(torch.int64))
