"""One module per entry kind; a workload file's ``entry`` names it.

Each has ``run(cell, seed, seconds, trace, device, t_start)`` returning
a ``harness.Result``, and ``readings`` pieces that ``calibrate`` drives
over many seeds in one process.
"""
