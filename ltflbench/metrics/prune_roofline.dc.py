"""prune_roofline.dc: B2 and B3 (``kernels.block_prune``: the tile
norms, the masked copies and the gradient gate) against their roofline.

The least time is the bytes block pruning needs (``counts.prune_bytes``:
the weights read once, the tile norms, the C masked copies written, the
C gradients read and written by the gate, the tile masks) over 3.35
TB/s; the time is the device time of both kernels' events in the traced
window. Moves ``train_tokens_per_s``.
"""
from ltflbench import counts

PATTERNS = (r"block_norms_kernel", r"apply_block_mask_kernel")


def read(ctx):
    tr = ctx["trace"]
    if tr.count(PATTERNS) == 0:
        return None
    return counts.roofline_share(ctx["prune_bytes"], 0.0,
                                 tr.kernel_s(PATTERNS), ctx["peak_flops"])
