"""ltfl_kernel_share.dc: the LTFL path's hand-written kernels (B1 the
quantizer, B2 the tile norms, B3 the tile masking) as a share of the
device's busy time in the traced window. Moves ``train_tokens_per_s``.
"""
from ltflbench import trace

PATTERNS = (r"stochastic_quant_kernel", r"block_norms_kernel",
            r"apply_block_mask_kernel")


def read(ctx):
    return trace.share(ctx["trace"], PATTERNS)
