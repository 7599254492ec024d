"""PyTorch port of the LTFL system for NVIDIA Hopper (H100, sm_90a).

Held module by module against the JAX reference package ``repro``; each
module names the reference module it mirrors. Runtime dependencies are
torch, numpy and scipy only: nothing here imports jax or ``repro``.

Entry points (``repro_torch.fed.FedRunner``, ``python -m
repro_torch.launch.train --edge`` and its datacenter mode,
``repro_torch.launch.train.run_datacenter``) run on ``cuda`` unless the
caller passes ``device="cpu"``, and raise when no card is present. Hand-written
kernels live in ``repro_torch.kernels`` (CUDA C++ under ``csrc/``, built
with nvcc at first use); on a CPU tensor each wrapper runs its plain
PyTorch version instead.
"""
