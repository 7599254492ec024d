"""Block-structured pruning kernels: tile L2 norms and tile masking.

Replace the Pallas TPU kernels ``repro.kernels.block_prune.block_norms``
(body ``_norms_kernel``) and ``apply_block_mask`` (``_mask_kernel``). The
kernels are CUDA C++ for sm_90a (``csrc/block_prune.cu``), bound with
ctypes. Both are bound by memory: ``block_norms`` reads w once and writes
one float per tile; ``apply_block_mask`` reads w once and writes one
masked copy per client, so one launch builds all C clients' pruned
weights from the shared w, or gates all C clients' stacked gradients.

``block_norms`` and ``apply_block_mask`` are the wrappers. A CPU tensor
goes to the plain version (``kernels.ref``); a CUDA tensor goes to the
kernel or the wrapper raises. A meta tensor (the dry run)
gets an empty output of the right shape and dtype and counts no launch:
a shape rule, not a fallback; any other device raises. On the card and
on meta the wrapper reports the tensors its kernel reads
(``build.note_reads``), for the dry run's byte count.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import apply_block_mask_ref, block_norms_ref

NAME = "block_prune"
DEFAULT_BLOCK = (128, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 2 ** 31 - 1

# kernel launches in this process (the card check resets and reads them)
LAUNCHES = {"block_norms": 0, "apply_block_mask": 0}


def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    lib.block_norms_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.block_norms_launch.restype = ctypes.c_int
    lib.apply_block_mask_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.apply_block_mask_launch.restype = ctypes.c_int
    return lib


def tile_shape(shape: Tuple[int, int], block=DEFAULT_BLOCK
               ) -> Tuple[int, int]:
    """(bm, bn) for a (M, N) matrix: the block, clipped to the matrix as
    the reference does; raises unless it tiles the matrix."""
    m, n = shape
    bm, bn = min(block[0], m), min(block[1], n)
    if bm < 1 or bn < 1 or m % bm or n % bn:
        raise ValueError(f"block {tuple(block)} does not tile {(m, n)}")
    return bm, bn


def _check_w(w: torch.Tensor) -> None:
    if w.dtype not in _DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    if w.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {w.device}")


def _launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def block_norms(w: torch.Tensor, block=DEFAULT_BLOCK) -> torch.Tensor:
    """L2 norm of every (bm, bn) tile of w (M, N) f32/bf16 ->
    (M/bm, N/bn) f32."""
    if w.dim() != 2:
        raise ValueError(f"w must be (M, N), got {tuple(w.shape)}")
    _check_w(w)
    bm, bn = tile_shape(tuple(w.shape), block)
    if w.device.type == "cpu":
        return block_norms_ref(w, bm, bn)
    m, n = w.shape
    build.note_reads("block_norms", w)
    if w.device.type == "meta":
        return torch.empty((m // bm, n // bn), dtype=torch.float32,
                           device=w.device)
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    if max(m, n) > _MAX_DIM:
        raise ValueError(f"w {(m, n)} is too large")
    out = torch.empty((m // bm, n // bn), dtype=torch.float32,
                      device=w.device)
    fn = _library().block_norms_launch
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = fn(w.data_ptr(), out.data_ptr(), m, n, bm, bn,
                 _DTYPES[w.dtype], stream)
    _launch(err, "block_norms")
    return out


def apply_block_mask(w: torch.Tensor, mask: torch.Tensor,
                     block=DEFAULT_BLOCK) -> torch.Tensor:
    """Each element of w times its tile's {0, 1} mask entry, in w's dtype.

    w (M, N) shared, or (C, M, N) one matrix per client; mask bool
    (M/bm, N/bn), or (C, M/bm, N/bn) one mask per client. Returns
    (C, M, N) when the mask has a client axis, else (M, N)."""
    if w.dim() not in (2, 3) or mask.dim() not in (2, 3) \
            or (w.dim() == 3 and mask.dim() != 3):
        raise ValueError(f"w {tuple(w.shape)} and mask {tuple(mask.shape)}:"
                         " need w (M, N) or (C, M, N) and mask (tr, tc) or "
                         "(C, tr, tc)")
    _check_w(w)
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if mask.device != w.device:
        raise ValueError(f"w on {w.device}, mask on {mask.device}")
    m, n = w.shape[-2:]
    bm, bn = tile_shape((m, n), block)
    c = mask.shape[0] if mask.dim() == 3 else 1
    if tuple(mask.shape[-2:]) != (m // bm, n // bn) or \
            (w.dim() == 3 and w.shape[0] != c):
        raise ValueError(f"mask {tuple(mask.shape)} does not match w "
                         f"{tuple(w.shape)} at block {(bm, bn)}")
    if w.device.type == "cpu":
        return apply_block_mask_ref(w, mask, bm, bn)
    out_shape = (c, m, n) if mask.dim() == 3 else (m, n)
    build.note_reads("apply_block_mask", w, mask)
    if w.device.type == "meta":
        return torch.empty(out_shape, dtype=w.dtype, device=w.device)
    if not (w.is_contiguous() and mask.is_contiguous()):
        raise ValueError("w and mask must be contiguous")
    if not 1 <= c <= _MAX_DIM or max(m, n) > _MAX_DIM:
        raise ValueError(f"w {tuple(w.shape)}, mask {tuple(mask.shape)}: "
                         "out of range")
    out = torch.empty(out_shape, dtype=w.dtype, device=w.device)
    stride = m * n if w.dim() == 3 else 0
    fn = _library().apply_block_mask_launch
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = fn(w.data_ptr(), mask.data_ptr(), out.data_ptr(), c, stride,
                 m, n, bm, bn, _DTYPES[w.dtype], stream)
    _launch(err, "apply_block_mask")
    return out
