"""idle_share.dc: the share of the traced window in which no operation
ran on the device (one minus the union of the device events' intervals
over the window). Moves ``train_tokens_per_s``.
"""
from ltflbench import trace


def read(ctx):
    return trace.idle_share(ctx["trace"])
