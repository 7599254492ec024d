"""idle_share.edge: the share of the traced window in which no operation
ran on the device (one minus the union of the device events' intervals
over the window). Moves ``rounds_per_s``.
"""
from ltflbench import trace


def read(ctx):
    return trace.idle_share(ctx["trace"])
