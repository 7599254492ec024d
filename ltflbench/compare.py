"""The numbers that decide ``correct`` for a training cell.

Each side (the program, the plain reference) gives three readings over
the first three steps from the same weights, batches, controls and
seeds: each step's loss, every leaf's norm of the first step's gradient
as the optimizer takes it, and every leaf's norm of the parameters'
change after the three steps. They are compared leaf by leaf, by the
gap between the two norms (not the norm of their difference) over the
reference's norm of that leaf or of the median leaf, whichever is
larger, since some leaves' gradients are all but zero; the worst leaf
counts. Leaves whose reference gradient lies under a thousandth of the
median leaf's move by round-off alone and are left out of both.

``first_loss_gap`` is the first step's loss alone: both sides start from
the same weights and batch, so it reads the forward pass's arithmetic
and nothing of the quantizer's or the updates' rounding, which makes the
later numbers swing from seed to seed.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

NEGLIGIBLE = 1e-3


def _relevant(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= NEGLIGIBLE * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: List[str]) -> float:
    return max(leaf_gaps(prog, ref, leaves).values())


def detail(prog: dict, ref: dict) -> dict:
    """Every step's loss gap and every leaf's gaps, for calibration."""
    leaves = _relevant(ref["grad"])
    return {"loss": [abs(a - b) / max(abs(b), 1e-30)
                     for a, b in zip(prog["loss"], ref["loss"])],
            "grad": leaf_gaps(prog["grad"], ref["grad"], leaves),
            "change": leaf_gaps(prog["change"], ref["change"], leaves)}


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"loss": [3 floats], "grad": {leaf: norm},
    "change": {leaf: norm}}."""
    leaves = _relevant(ref["grad"])
    loss = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["loss"], ref["loss"])]
    return {"first_loss_gap": loss[0], "loss_gap": max(loss),
            "grad_gap": leaf_gap(prog["grad"], ref["grad"], leaves),
            "change_gap": leaf_gap(prog["change"], ref["change"], leaves)}


def judge(found: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(found[k] <= limits[k] for k in limits)
