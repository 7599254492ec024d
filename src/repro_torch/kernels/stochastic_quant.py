"""Fused stochastic quantize-dequantize (paper Eq. 16-17) for a client batch.

Replaces the Pallas TPU kernel ``repro.kernels.stochastic_quant``
(``stochastic_quant_dyn``, body ``_quant_kernel_dyn``). The kernel is CUDA
C++ for sm_90a (``csrc/stochastic_quant.cu``), bound with ctypes. It is
bound by memory: per element it reads g and rand and writes out (12 bytes
in f32, 8 in bf16), so it streams 16-byte vectors; one launch covers all C
clients of a leaf, with one [lo, hi, n_levels] row per client.

``stochastic_quant`` is the wrapper. A CPU tensor goes to the plain
version (``kernels.ref.stochastic_quant_ref``); a CUDA tensor goes to the
kernel or the wrapper raises. A meta tensor (the dry run)
gets an empty output of the right shape and dtype and counts no launch:
a shape rule, not a fallback; any other device raises. On the card and
on meta the wrapper reports the tensors its kernel reads
(``build.note_reads``), for the dry run's byte count.
``LAUNCHES`` counts kernel launches.
``stochastic_quant_static`` is the counterpart of the reference's
static-bits ``stochastic_quant`` (lines 22-34), a wrapper over the same
kernel body: one launch of this kernel with one client row.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import stochastic_quant_ref

NAME = "stochastic_quant"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_CLIENTS = 65535          # gridDim.y

# kernel launches in this process (the card check resets and reads it)
LAUNCHES = {"stochastic_quant": 0}


def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.stochastic_quant_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(g: torch.Tensor, rand: torch.Tensor, rng: torch.Tensor) -> None:
    if g.dim() != 2:
        raise ValueError(f"g must be (C, L), got {tuple(g.shape)}")
    c, n = g.shape
    if g.dtype not in _DTYPES:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if rand.dtype != torch.float32 or tuple(rand.shape) != (c, n):
        raise ValueError(f"rand must be float32 {(c, n)}, got "
                         f"{rand.dtype} {tuple(rand.shape)}")
    if rng.dtype != torch.float32 or tuple(rng.shape) != (c, 3):
        raise ValueError(f"rng must be float32 {(c, 3)}, got "
                         f"{rng.dtype} {tuple(rng.shape)}")
    devices = {g.device, rand.device, rng.device}
    if len(devices) != 1:
        raise ValueError(f"g, rand and rng lie on different devices: "
                         f"{sorted(map(str, devices))}")


def stochastic_quant(g: torch.Tensor, rand: torch.Tensor,
                     rng: torch.Tensor) -> torch.Tensor:
    """Q(g) for a client batch: g (C, L) f32/bf16, rand (C, L) f32,
    rng (C, 3) f32 rows [lo, hi, n_levels]. Returns (C, L) in g.dtype."""
    _check(g, rand, rng)
    if g.device.type == "cpu":
        return stochastic_quant_ref(g, rand, rng)
    if g.device.type == "meta":
        build.note_reads(NAME, g, rand, rng)
        return torch.empty_like(g)
    if g.device.type != "cuda":
        raise ValueError(f"no kernel for device {g.device}")
    c, n = g.shape
    if not (g.is_contiguous() and rand.is_contiguous()
            and rng.is_contiguous()):
        raise ValueError("g, rand and rng must be contiguous")
    if not 1 <= c <= _MAX_CLIENTS or n < 1:
        raise ValueError(f"need 1 <= C <= {_MAX_CLIENTS} and L >= 1, "
                         f"got {(c, n)}")
    fn = _library().stochastic_quant_launch
    out = torch.empty_like(g)
    build.note_reads(NAME, g, rand, rng)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(g.data_ptr(), rand.data_ptr(), rng.data_ptr(),
                 out.data_ptr(), c, n, _DTYPES[g.dtype], stream)
    if err != 0:
        raise RuntimeError(f"stochastic_quant launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[NAME] += 1
    return out


def stochastic_quant_static(g: torch.Tensor, rand: torch.Tensor, lo, hi,
                            bits: int) -> torch.Tensor:
    """Q(g) of one (M, N) tensor at a static bit-width: g f32/bf16, rand
    (M, N) f32, lo / hi scalars (the range of |g|). Held against
    ``repro.kernels.stochastic_quant.stochastic_quant`` (lines 22-34),
    whose TPU tiling arguments (``block``, ``interpret``) have no
    counterpart here: g is viewed as one client row (1, M * N) and the
    batched kernel runs once with the row [lo, hi, 2^bits - 1]."""
    if g.dim() != 2:
        raise ValueError(f"g must be (M, N), got {tuple(g.shape)}")
    row = [torch.as_tensor(x, dtype=torch.float32, device=g.device)
           .reshape(()) for x in (lo, hi, float(2 ** bits - 1))]
    out = stochastic_quant(g.reshape(1, -1).contiguous(),
                           rand.reshape(1, -1).contiguous(),
                           torch.stack(row).reshape(1, 3))
    return out.reshape(g.shape)
