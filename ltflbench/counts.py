"""The yardstick's arithmetic: the card's peaks, the operations a step
needs, and the bytes a kernel's work needs.

Every count here is of the work the algorithm needs for the shapes it is
given, not of what a kernel happens to move: each input read once, each
output written once, no recomputation, no scratch tensor. So a kernel
that fuses, draws its random numbers itself or skips a copy never makes
a count stale; it moves the share of its roofline instead.
"""
from __future__ import annotations

import subprocess
from typing import Iterable, Sequence

# One NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet; dense
# rates, without structured sparsity). A card set below 700 W reaches
# less; ``power_limit`` reads the card's setting to print beside them.
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
              "f32": 67e12, "fp8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    ("not read" when it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


def f32_peak() -> float:
    """The float32 peak of the precision the matmuls and convolutions run
    in now: TF32's where either backend may use it, else plain float32."""
    import torch
    tf32 = (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32)
    return PEAK_FLOPS["tf32" if tf32 else "f32"]


# --------------------------------------------------------------------------- #
# A dense decoder language model (granite-8b's family)
# --------------------------------------------------------------------------- #
def lm_matmul_params(d_model: int, n_heads: int, n_kv_heads: int,
                     head_dim: int, d_ff: int, n_layers: int,
                     vocab: int, glu: bool = True) -> int:
    """Parameters that enter a matrix product: each layer's q, k, v and
    output projections and its MLP, and the output head. The embedding
    is a lookup, not a product, so it is left out (a tied head would be
    counted once, as the head)."""
    attn = d_model * (n_heads + 2 * n_kv_heads) * head_dim \
        + n_heads * head_dim * d_model
    mlp = (3 if glu else 2) * d_model * d_ff
    return n_layers * (attn + mlp) + d_model * vocab


def lm_train_flops(d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, d_ff: int, n_layers: int, vocab: int,
                   n_seqs: int, seq_len: int, glu: bool = True) -> float:
    """Model FLOPs of one forward and backward pass over ``n_seqs``
    sequences of ``seq_len`` tokens: 6 x the matmul parameters x tokens,
    plus causal attention's scores and weighted sum, 2 x 2 x S^2 x
    (heads x head_dim) a sequence and layer forward, halved by the causal
    mask, times 3 for the backward. Recomputation (remat) is not
    counted: it is work the step chooses, not work it needs."""
    p = lm_matmul_params(d_model, n_heads, n_kv_heads, head_dim, d_ff,
                         n_layers, vocab, glu)
    tokens = n_seqs * seq_len
    attn = 3 * 2 * 2 * seq_len ** 2 * n_heads * head_dim / 2
    return 6.0 * p * tokens + attn * n_layers * n_seqs


# --------------------------------------------------------------------------- #
# The paper's pre-activation ResNet
# --------------------------------------------------------------------------- #
def _same_out(size: int, stride: int) -> int:
    return -(-size // stride)


def resnet_forward_flops(image_size: int, in_channels: int, stem: int,
                         groups: Sequence[int], blocks: Sequence[int],
                         classes: int) -> float:
    """FLOPs of one image's forward pass through the convolutions and
    the head (2 a multiply-add), with "SAME" padding's output sizes.
    Norms, activations, the residual adds and the pooling are left out:
    elementwise work that no peak rate describes."""
    def conv(k, cin, cout, out_hw):
        return 2.0 * k * k * cin * cout * out_hw * out_hw

    hw = image_size
    total = conv(3, in_channels, stem, hw)
    cin = stem
    for gi, (cout, n) in enumerate(zip(groups, blocks)):
        for bi in range(n):
            stride = 2 if (gi > 0 and bi == 0) else 1
            c_in = cin if bi == 0 else cout
            out = _same_out(hw, stride)
            if c_in != cout:
                total += conv(1, c_in, cout, out)
            total += conv(3, c_in, cout, out) + conv(3, cout, cout, out)
            hw = out
        cin = cout
    return total + 2.0 * cin * classes


# --------------------------------------------------------------------------- #
# Bytes the LTFL path's kernels need
# --------------------------------------------------------------------------- #
def quant_bytes(leaf_sizes: Iterable[int], n_clients: int,
                elem_bytes: int) -> float:
    """The stochastic quantizer (B1) over the stacked (C, ...) gradients
    of every leaf: each gradient read once and its quantized value
    written once, plus each client's range row (lo, hi, levels: 3 float32
    read) a leaf. The uniform random numbers are NOT counted: they are
    an input the kernel may draw itself, not work the step needs."""
    sizes = list(leaf_sizes)
    return float(2 * elem_bytes * n_clients * sum(sizes)
                 + 12 * n_clients * len(sizes))


def prune_bytes(tileable_sizes: Iterable[int], n_clients: int,
                elem_bytes: int, block: int) -> float:
    """Block pruning (B2 and B3) over the tileable leaves: the weights
    read once (for the tile norms and the masked copies alike), one
    float32 norm written a tile, the C masked copies written, and the C
    stacked gradients read and written once by the gate; each client's
    tile mask (one byte a tile) read once for the copies and once for the
    gate."""
    total = 0.0
    for n in tileable_sizes:
        tiles = n // (block * block)
        total += (elem_bytes * n + 4 * tiles
                  + elem_bytes * n_clients * n
                  + 2 * elem_bytes * n_clients * n
                  + 2 * n_clients * tiles)
    return total


def roofline_share(n_bytes: float, n_flops: float, seconds: float,
                   peak_flops: float,
                   bytes_per_s: float = HBM_BYTES_PER_S) -> float:
    """Percent of the roofline: the least time the card could take (the
    larger of bytes over bandwidth and operations over peak) over the
    measured time."""
    least = max(n_bytes / bytes_per_s, n_flops / peak_flops)
    return 100.0 * least / seconds


def mfu(n_flops: float, seconds: float, peak_flops: float) -> float:
    """Percent of the peak: the FLOPs the work needs over the time and
    the peak rate."""
    return 100.0 * n_flops / (seconds * peak_flops)

