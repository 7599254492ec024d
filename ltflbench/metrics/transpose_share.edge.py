"""transpose_share.edge: cuDNN's layout transposes around the ResNet's
convolutions (NCHW <-> NHWC and the generic transpose kernels) as a
share of the device's busy time in the traced window. Moves
``rounds_per_s``.
"""
from ltflbench import trace

PATTERNS = (r"nchwToNhwc", r"nhwcToNchw", r"(?i:transpose)")


def read(ctx):
    return trace.share(ctx["trace"], PATTERNS)
