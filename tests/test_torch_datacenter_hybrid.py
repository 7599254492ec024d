"""The port's datacenter step (block pruning at block 32, the LTFL
quantizer, in-step packet drops) on the hybrid family (its shared attention block is one set of
leaves, its gradient summed over the call sites) against the reference's
jitted step: zamba2-2.7b at ``reduce_for_smoke`` widths, C = 4 clients, one
step on the same weights, batch, quantizer uniforms and drop draw.
Masks bitwise, the loss, metrics and updated weights within
tests/test_torch_datacenter.py's bounds (``torch_parity``'s
``check_datacenter_step``, which says why float32).
"""
import math

import pytest

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")

from torch_parity import check_datacenter_step


def test_zamba2_datacenter_step_matches_reference():
    m = check_datacenter_step("zamba2-2.7b")
    assert math.isfinite(float(m["loss"]))
