"""Hand-written Hopper kernels and their plain PyTorch versions.

* ``stochastic_quant`` (CUDA C++, ``csrc/stochastic_quant.cu``) replaces
  the Pallas TPU kernel ``repro.kernels.stochastic_quant.stochastic_quant_dyn``;
* ``block_norms`` and ``apply_block_mask`` (CUDA C++,
  ``csrc/block_prune.cu``, wrappers in ``block_prune.py``) replace
  ``repro.kernels.block_prune.block_norms`` and ``apply_block_mask``;
* ``block_sparse_matmul`` (CUDA C++, ``csrc/block_sparse_matmul.cu``)
  replaces ``repro.kernels.block_sparse_matmul.block_sparse_matmul``:
  bfloat16 products on the tensor cores (TMA + wgmma, dead tiles never
  copied), float32 and odd block shapes on the CUDA cores, by the shape
  rule ``block_sparse_matmul.kernel_path``.

Every Pallas kernel of the reference has its counterpart here. Kernels
build with nvcc at first use (``build.py``); nothing here builds or imports a compiler when
the package is imported. ``ref.py`` holds the plain versions, ``ops.py``
the wrappers' public entry points.
"""
