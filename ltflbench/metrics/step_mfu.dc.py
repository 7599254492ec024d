"""step_mfu.dc: the whole datacenter step's share of the card's bf16 peak.

The model FLOPs the traced steps need (``counts.lm_train_flops``: 6 x
the matmul parameters x tokens plus causal attention, no recomputation)
over the traced window's length times 989 TFLOP/s. It bounds every
kernel's gain: a kernel taken off the path leaves its own roofline
silent, but not this. Moves ``train_tokens_per_s``.
"""
from ltflbench import counts


def read(ctx):
    return counts.mfu(ctx["flops"], ctx["trace"].window_s,
                      ctx["peak_flops"])
