"""What every entry shares: the device clock's edges, the measured
window, weights drawn from the seed, and a run's result.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch

from ltflbench import compare
from ltflbench.refs.ltfl import path_key

Tree = Dict[str, torch.Tensor]


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]          # name: (value, limit)
    memory_peak_bytes: int
    end_to_end: Dict[str, float] = field(default_factory=dict)
    trace_ctx: Optional[dict] = None                # --trace 1 only


def result(found: Dict[str, float], limits: Dict[str, float],
           attempted: int, peak: int, end_to_end: Dict[str, float],
           trace_ctx: Optional[dict]) -> Result:
    """A run's result: ``correct`` from the numbers found against the
    cell's limits, the peak added to the end-to-end metrics."""
    end_to_end["peak_mem_gib"] = peak / 2 ** 30
    return Result(correct=compare.judge(found, limits), attempted=attempted,
                  failed=0, checks={k: (found[k], limits[k]) for k in limits},
                  memory_peak_bytes=peak, end_to_end=end_to_end,
                  trace_ctx=trace_ctx)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


IN_FLIGHT = 2


def window(step: Callable[[int], None], start: int, seconds: float,
           device: torch.device) -> Tuple[int, float]:
    """Call ``step(i)`` for i = start, start + 1, ... until ``seconds``
    have passed on the host clock, keeping at most ``IN_FLIGHT`` calls
    queued on the device (so the window ends within a call or two of
    its length), then wait for the device. Returns (calls, seconds from
    the first call to the device's end)."""
    marks = deque()
    n = 0
    sync(device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        step(start + n)
        n += 1
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            marks.append(ev)
            if len(marks) > IN_FLIGHT:
                marks.popleft().synchronize()
    sync(device)
    return n, time.perf_counter() - t0


INIT_SCALE = {"normal": 1.0, "conv": 1.4}


def make_weights(spec: Dict[str, Tuple[Tuple[int, ...], str]], seed: int,
                 dtype: torch.dtype, device: torch.device) -> Tree:
    """Weights from ``seed`` on ``device`` in leaf order: one draw of
    normals for every drawn leaf at once, each leaf a view of it scaled
    in place ("normal": 1/sqrt(fan in), "conv": 1.4/sqrt(fan in), fan in
    the second-to-last dim; "embed": 0.02), ones and zeros as named. The
    same seed gives the same weights on the same kind of device."""
    names = sorted(spec, key=path_key)
    drawn = [k for k in names if spec[k][1] in ("normal", "conv", "embed")]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sizes = [math.prod(spec[k][0]) for k in drawn]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out, views = {}, dict(zip(drawn, flat.split(sizes)))
    for k in names:
        shape, init = spec[k]
        if init in ("ones", "zeros"):
            out[k] = (torch.ones if init == "ones" else torch.zeros)(
                shape, dtype=dtype, device=device)
            continue
        scale = (0.02 if init == "embed"
                 else INIT_SCALE[init] / float(shape[-2]) ** 0.5)
        out[k] = views[k].view(shape).mul_(scale)
    return out


def step_seed(seed: int, i: int) -> int:
    """Step i's seed under the run's ``--seed``: distinct per step, and
    small enough that the program's drop stream (seed + 2^32) fits 63
    bits."""
    return (int(seed) * 1_000_003 + i) % (1 << 40)


def leaf_norms(tree: Tree) -> Dict[str, torch.Tensor]:
    return {k: torch.linalg.vector_norm(v, dtype=torch.float32)
            for k, v in tree.items()}


def change_norms(new: Tree, old: Tree) -> Dict[str, torch.Tensor]:
    """Per leaf, the float32 norm of new - old (each leaf's difference
    taken in float32, one leaf at a time)."""
    return {k: torch.linalg.vector_norm(new[k].to(torch.float32)
                                        - old[k].to(torch.float32))
            for k in old}


def to_host(readings: dict) -> dict:
    """Tensors in {"loss": [...], "grad": {...}, "change": {...}} as
    floats."""
    return {"loss": [float(x) for x in readings["loss"]],
            "grad": {k: float(v) for k, v in readings["grad"].items()},
            "change": {k: float(v) for k, v in readings["change"].items()}}
