"""The benchmark of the PyTorch port (``repro_torch``) on an NVIDIA H100.

Driven by data: ``BENCHMARK.json`` at the repository root names the
cells, and each cell, configuration and per-layer metric has a file of
its own here, found by name:

* ``configs/<config>.json``: the model or deployment as it is run;
* ``workloads/<cell>.json``: the entry kind, the traffic parameters and
  the limits of the output check;
* ``metrics/<metric>.py``: a reader of one per-layer metric.

``entries/<kind>.py`` drives one kind of cell (``datacenter``: the LTFL
step on a language model; ``edge``: the paper's federated round engine).
``refs/`` holds the plain references the output check compares with;
they import nothing of the port. ``counts.py`` holds the peaks and the
functions that count a step's operations and a kernel's bytes.

Run one cell from the repository root (a CUDA card is required):

    python3 -m ltflbench.run --workload granite-8b.fl_2k --seed 7 \\
        --seconds 30 --trace 0
"""
