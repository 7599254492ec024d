"""Block-sparse matrix product over a block-pruned weight.

Replaces the Pallas TPU kernel
``repro.kernels.block_sparse_matmul.block_sparse_matmul`` (body
``_bsmm_kernel``): x (M, K) @ w (K, N), skipping every (bk, bn) tile of w
whose mask entry is 0, with a float32 sum cast once to x's dtype. This is
where the pruning ratio rho becomes skipped work. The kernel is CUDA C++
for sm_90a (``csrc/block_sparse_matmul.cu``), bound with ctypes; it is
bound by the live tiles' multiply-adds.

``block_sparse_matmul`` is the wrapper. A CPU tensor goes to the plain
version (``kernels.ref.block_sparse_matmul_ref``); a CUDA tensor goes to
the kernel or the wrapper raises. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import block_sparse_matmul_ref

NAME = "block_sparse_matmul"
DEFAULT_BLOCKS = (128, 128, 128)           # bm, bn, bk
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 2 ** 31 - 1

# the wgmma path's units (csrc/block_sparse_matmul.cu): one K step of x
# and w per shared-memory stage, the output tile's N, the mask rows a
# block's live list holds
WGMMA_K_STEP = 64
WGMMA_TILE_N = 128
WGMMA_MAX_MASK_ROWS = 4096

# kernel launches in this process (the card check resets and reads them):
# the total and one count per path
LAUNCHES = {"block_sparse_matmul": 0, "block_sparse_matmul_wgmma": 0,
            "block_sparse_matmul_simt": 0}


def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    lib.block_sparse_matmul_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int)]
    lib.block_sparse_matmul_launch.restype = ctypes.c_int
    return lib


def block_shape(m: int, n: int, k: int, blocks=DEFAULT_BLOCKS
                ) -> Tuple[int, int, int]:
    """(bm, bn, bk), each block clamped to its dimension as the reference
    does; raises unless they tile (M, N, K)."""
    if min(m, n, k) < 1:
        raise ValueError(f"empty product: M, N, K = {(m, n, k)}")
    bm, bn, bk = min(blocks[0], m), min(blocks[1], n), min(blocks[2], k)
    if min(bm, bn, bk) < 1 or m % bm or n % bn or k % bk:
        raise ValueError(f"blocks {tuple(blocks)} do not tile M, N, K = "
                         f"{(m, n, k)}")
    return bm, bn, bk


def kernel_path(m: int, n: int, k: int, bk: int, bn: int,
                dtype: torch.dtype, aligned: bool = True) -> str:
    """The kernel's path for x (m, k) @ w (k, n) at blocks (bk, bn):
    "wgmma" for a bfloat16 product whose bk is a multiple of the 64-deep
    K step, whose bn is a multiple of the 128-wide output tile (so a
    tile's columns share one mask column), whose mask has at most 4096
    rows (the block's live list) and whose x and w start on 16 bytes
    (``aligned``, TMA's base alignment); "simt" otherwise. Blocks that
    tile (k, n) then make k and n multiples of 64 and 128, so the rows of
    x and w are multiples of 16 bytes, TMA's stride unit (N = 3 or 60
    clamps bn below 128 and goes to "simt"). float32 always takes "simt":
    the reference's product is full float32, and wgmma offers only TF32.
    m does not enter: rows past m are TMA zero fill."""
    del m, n
    if dtype != torch.bfloat16:
        return "simt"
    if bk % WGMMA_K_STEP or bn % WGMMA_TILE_N:
        return "simt"
    if k // bk > WGMMA_MAX_MASK_ROWS or not aligned:
        return "simt"
    return "wgmma"


def block_sparse_matmul(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                        blocks=DEFAULT_BLOCKS) -> torch.Tensor:
    """x (M, K) @ w (K, N), skipping the (bk, bn) tiles of w whose entry
    of mask (K/bk, N/bn) is 0 (bool or integer; nonzero is live). x and w
    are both float32 or both bfloat16; the result has x's dtype."""
    if x.dim() != 2 or w.dim() != 2 or mask.dim() != 2:
        raise ValueError(f"need x (M, K), w (K, N), mask (K/bk, N/bn); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(mask.shape)}")
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "chain")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or both bfloat16, "
                        f"got {x.dtype} and {w.dtype}")
    _, bn, bk = block_shape(m, n, k, blocks)
    if tuple(mask.shape) != (k // bk, n // bn):
        raise ValueError(f"mask {tuple(mask.shape)} does not match w "
                         f"{tuple(w.shape)} at blocks (bk, bn) = {(bk, bn)}")
    if not (x.device == w.device == mask.device):
        raise ValueError(f"x on {x.device}, w on {w.device}, mask on "
                         f"{mask.device}")
    if x.device.type == "cpu":
        return block_sparse_matmul_ref(x, w, mask, bk, bn)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if max(m, n, k) > _MAX_DIM:
        raise ValueError(f"M, N, K = {(m, n, k)} out of range")
    live = (mask != 0).to(torch.uint8).contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    want = kernel_path(m, n, k, bk, bn, x.dtype,
                       aligned=x.data_ptr() % 16 == 0
                       and w.data_ptr() % 16 == 0)
    fn = _library().block_sparse_matmul_launch
    taken = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), live.data_ptr(), out.data_ptr(),
                 m, n, k, bk, bn, _DTYPES[x.dtype], stream,
                 ctypes.byref(taken))
    if err != 0:
        raise RuntimeError(f"block_sparse_matmul launch failed ({want} "
                           f"path): CUDA error {err}")
    path = {1: "wgmma", 0: "simt"}.get(taken.value)
    if path != want:
        raise RuntimeError(f"block_sparse_matmul took the {path} path, the "
                           f"shape rule says {want}")
    LAUNCHES["block_sparse_matmul"] += 1
    LAUNCHES[f"block_sparse_matmul_{path}"] += 1
    return out
