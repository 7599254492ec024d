"""The port's datacenter step (block pruning at block 32, the LTFL
quantizer, in-step packet drops) on the MoE family against the
reference's jitted step: olmoe-1b-7b at ``reduce_for_smoke`` widths (4
experts, top 2), C = 4 clients, one step on the same weights, batch,
quantizer uniforms and drop draw. The MoE dispatch maps over clients
under ``torch.func.vmap`` of ``grad`` (its one-hot masks are comparisons
with an ``arange``, ``moe.one_hot``). Masks bitwise, the loss, metrics
and updated weights within tests/test_torch_datacenter.py's bounds
(``torch_parity``'s ``check_datacenter_step``, which says why float32).
The launch counts ``chip_smoke.py`` asserts for the other families'
datacenter step at full width are held against the reference's leaf
tree.
"""
import math

import pytest
import torch

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")

from repro_torch.models import moe

from torch_parity import check_datacenter_step


def test_olmoe_datacenter_step_matches_reference():
    m = check_datacenter_step("olmoe-1b-7b")
    assert math.isfinite(float(m["loss"]))


def test_chip_smoke_family_launch_counts_are_the_reference_tree_s():
    """``chip_smoke.DC_FAMILIES``: per config at its depth cut, one
    quantizer launch per leaf of the reference's tree, one block_norms
    per tileable leaf (``repro.core.pruning.tileable`` at block 32), two
    apply_block_mask per tileable leaf, and the parameter count."""
    import importlib.util
    from pathlib import Path

    import jax
    import numpy as np

    from repro import configs as ref_configs
    from repro.core.pruning import tileable
    from repro.models import build_model as ref_build_model

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert len(chip_smoke.DC_FAMILIES) == 4
    for name, (cut, n_params, want) in chip_smoke.DC_FAMILIES.items():
        specs = ref_build_model(ref_configs.get_arch(name).replace(
            **cut)).param_specs()
        leaves = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: hasattr(x, "axes"))
        tiles = sum(tileable(jax.ShapeDtypeStruct(s.shape, s.dtype), 32)
                    for s in leaves)
        assert want == {"stochastic_quant": len(leaves),
                        "block_norms": tiles,
                        "apply_block_mask": 2 * tiles}, name
        assert n_params == sum(int(np.prod(s.shape)) for s in leaves)


def test_one_hot_is_f_one_hot_and_maps_over_clients():
    """``moe.one_hot`` equals ``F.one_hot(...).to(dtype)``, the
    out-of-range index (past the last capacity slot) aside, which gives
    an all-zero row as the reference's ``jax.nn.one_hot`` does; and it
    runs under ``torch.func.vmap`` of ``torch.func.grad`` (the datacenter
    step's per-client gradients), where ``F.one_hot`` raises."""
    idx = torch.tensor([[0, 3, 1], [2, 2, 0]])
    for dt in (torch.int64, torch.float32, torch.bfloat16):
        assert torch.equal(moe.one_hot(idx, 4, dt),
                           torch.nn.functional.one_hot(idx, 4).to(dt))
    assert torch.equal(moe.one_hot(torch.tensor([5, 1]), 4, torch.float32),
                       torch.tensor([[0.0, 0, 0, 0], [0, 1, 0, 0]]))

    def routed(one_hot):
        def f(x):
            _, i = torch.topk(x, 2, dim=-1)
            return (one_hot(i) * x[..., None, :]).sum()
        return f

    x = torch.randn(3, 5, 4, generator=torch.Generator().manual_seed(0))
    mapped = torch.func.vmap(torch.func.grad(routed(
        lambda i: moe.one_hot(i, 4, torch.float32))))(x)
    for c in range(3):
        assert torch.equal(mapped[c], torch.func.grad(routed(
            lambda i: torch.nn.functional.one_hot(i, 4).float()))(x[c]))
    with pytest.raises(RuntimeError, match="vmap"):
        torch.func.vmap(torch.func.grad(routed(
            lambda i: torch.nn.functional.one_hot(i, 4).float())))(x)
