"""step_mfu.edge: the edge round's share of the card's float32 peak.

The ResNet's forward and backward FLOPs of every client's batch in the
traced rounds, plus the evaluations' forward FLOPs
(``counts.resnet_forward_flops``), over the traced window's length
times the peak of the precision the convolutions run in (read at run
time: 67 TFLOP/s with TF32 off, as the port runs the edge path).
Moves ``rounds_per_s``.
"""
from ltflbench import counts


def read(ctx):
    return counts.mfu(ctx["flops"], ctx["trace"].window_s,
                      ctx["peak_flops"])
