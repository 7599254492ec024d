"""Hand-written Hopper kernels and their plain PyTorch versions.

``stochastic_quant`` (CUDA C++, ``csrc/stochastic_quant.cu``) replaces the
Pallas TPU kernel ``repro.kernels.stochastic_quant.stochastic_quant_dyn``.
Kernels build with nvcc at first use (``build.py``); nothing here builds
or imports a compiler when the package is imported.
"""
