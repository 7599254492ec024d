"""Hand-written Hopper kernels and their plain PyTorch versions.

* ``stochastic_quant`` (CUDA C++, ``csrc/stochastic_quant.cu``) replaces
  the Pallas TPU kernel ``repro.kernels.stochastic_quant.stochastic_quant_dyn``;
* ``block_norms`` and ``apply_block_mask`` (CUDA C++,
  ``csrc/block_prune.cu``, wrappers in ``block_prune.py``) replace
  ``repro.kernels.block_prune.block_norms`` and ``apply_block_mask``.

``block_sparse_matmul`` is not ported yet. Kernels build with nvcc at
first use (``build.py``); nothing here builds or imports a compiler when
the package is imported. ``ref.py`` holds the plain versions, ``ops.py``
the wrappers' public entry points.
"""
