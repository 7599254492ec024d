"""gemm_share.dc: the model's matrix products (cuBLAS and CUTLASS GEMM
kernels, the projections, the head and attention's batched products) as
a share of the device's busy time in the traced window. Moves
``train_tokens_per_s``.
"""
from ltflbench import trace

PATTERNS = (r"(?i:gemm)", r"nvjet", r"xmma", r"cutlass", r"(?i:gemv)")


def read(ctx):
    return trace.share(ctx["trace"], PATTERNS)
