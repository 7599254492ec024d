"""quant_roofline.dc: B1 (``kernels.stochastic_quant``) against its
roofline on the datacenter step's bf16 gradients.

The least time is the bytes the step's quantization needs
(``counts.quant_bytes``: every stacked gradient read once, its quantized
value written once, the range rows; not the uniforms) over 3.35 TB/s;
the time is the device time of the kernel's events in the traced
window. Moves ``train_tokens_per_s``.
"""
from ltflbench import counts

PATTERNS = (r"stochastic_quant_kernel",)


def read(ctx):
    tr = ctx["trace"]
    if tr.count(PATTERNS) == 0:
        return None
    return counts.roofline_share(ctx["quant_bytes"], 0.0,
                                 tr.kernel_s(PATTERNS), ctx["peak_flops"])
