"""The port's MoE FFN (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``).

olmoe-1b-7b (4 experts, top-2, no shared expert) and
deepseek-v2-lite-16b (4 experts, top-2, one shared expert) at
``reduce_for_smoke`` widths, one layer's FFN weights (made by the port,
carried as numpy; the router float32, the experts float32 or bfloat16).
The inputs share an offset along one direction, so the router favours
some experts and, at the published capacity factor 1.25, tokens past an
expert's capacity are dropped: the test asserts that they are, on the
port (fewer kept assignments than tokens x k) and on the reference (its
output moves when the capacity is raised to 16).

Tolerances, as relative norm errors ||port - ref|| / ||ref||: float32
rel 1e-5 for the outputs and the auxiliary loss (seen: ~1e-7); bfloat16
experts to the bf16 noise: the port's output no farther from the
reference's float32 output than 1.25 times the reference's own bf16
output is. The routing itself has no ties on these inputs: the k + 1
largest router probabilities of every token are apart by more than
1e-6, so float32 noise cannot reorder them.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")
import jax.numpy as jnp

from repro.models import build_model as ref_build_model
from repro.models import moe as ref_moe
from repro_torch.models import build_model, moe
from repro_torch.models.common import subtree

from torch_parity import arch_pair, as_jax_like, decoder_weights

B, S = 2, 128
ARCHS = ["olmoe-1b-7b", "deepseek-v2-lite-16b"]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def _ffn(name, dtype):
    """(ref cfg, port cfg, ref ffn params, port ffn params) of the first
    MoE layer."""
    ref_cfg, cfg = arch_pair(name)
    tree = decoder_weights(cfg)
    ref_specs = ref_build_model(ref_cfg).param_specs()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rp = as_jax_like(tree["layers"]["ffn"], ref_specs["layers"]["ffn"], jdt)
    rp = {k: (v[0] if not isinstance(v, dict) else
              {kk: vv[0] for kk, vv in v.items()}) for k, v in rp.items()}
    specs = build_model(cfg).param_specs()
    from repro_torch.models import params_from_numpy
    flat = params_from_numpy(tree)
    tp = {k: v[0].to(torch.float32 if specs["layers.ffn." + k].dtype
                     == torch.float32 else dtype)
          for k, v in subtree(flat, "layers.ffn.").items()}
    return ref_cfg, cfg, rp, tp


def _x(cfg, shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1.5 * rng.standard_normal(cfg.d_model)
    x = torch.from_numpy(x.astype(np.float32)).to(dtype)
    return x, jnp.asarray(x.to(torch.float32).numpy(),
                          jnp.float32 if dtype == torch.float32
                          else jnp.bfloat16)


@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_matches_reference_with_drops(name):
    ref_cfg, cfg, rp, tp = _ffn(name, torch.float32)
    x, rx = _x(cfg, (B, S, cfg.d_model), torch.float32)
    ry, raux = ref_moe.moe_apply(ref_cfg, rp, rx)
    y, aux = moe.moe_apply(cfg, tp, x)
    assert y.shape == (B, S, cfg.d_model) and aux.dtype == torch.float32
    assert _rel(y.numpy(), np.asarray(ry)) <= 1e-5
    assert abs(float(aux) - float(raux)) <= 1e-5 * abs(float(raux))

    # no near-ties among each token's k + 1 largest router probabilities
    K, E = cfg.moe.top_k, cfg.moe.num_experts
    # B * S = 256 tokens: one group
    probs, top_w, top_i = moe._route(tp, x.reshape(1, B * S, -1), K)
    top = torch.topk(probs, K + 1, dim=-1).values
    assert float((top[..., :-1] - top[..., 1:]).min()) > 1e-6

    # drops: fewer kept assignments than tokens x k on the port ...
    C = moe._capacity(B * S, K, E, cfg.moe.capacity_factor)
    dispatch, _ = moe._dispatch_masks(top_w, top_i, E, C, torch.float32)
    kept = int(dispatch.sum())
    assert 0 < B * S * K - kept, "no token was dropped"
    # ... and on the reference, whose output moves without them
    wide = ref_cfg.replace(moe=dataclasses.replace(ref_cfg.moe,
                                                   capacity_factor=16.0))
    ry16, _ = ref_moe.moe_apply(wide, rp, rx)
    assert _rel(ry16, ry) > 1e-2
    y16, _ = moe.moe_apply(cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0)), tp, x)
    assert _rel(y16.numpy(), np.asarray(ry16)) <= 1e-5


@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_bf16_matches_reference_to_the_bf16_noise(name):
    ref_cfg, cfg, rp32, _ = _ffn(name, torch.float32)
    _, _, rp, tp = _ffn(name, torch.bfloat16)
    assert tp["router"].dtype == torch.float32
    assert tp["w_down"].dtype == torch.bfloat16
    x, rx = _x(cfg, (B, S, cfg.d_model), torch.bfloat16)
    ref32, _ = ref_moe.moe_apply(ref_cfg, rp32, rx.astype(jnp.float32))
    ref16, _ = ref_moe.moe_apply(ref_cfg, rp, rx)
    y, _ = moe.moe_apply(cfg, tp, x)
    assert y.dtype == torch.bfloat16
    noise = _rel(np.asarray(ref16.astype(jnp.float32)), ref32)
    assert _rel(y.float().numpy(), ref32) <= 1.25 * noise


@pytest.mark.parametrize("dispatch", ["gather", "dense"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_token_matches_reference(monkeypatch, name, dispatch):
    """Both decode dispatches, float32 (rel 1e-5) and bfloat16 experts
    (the bf16 noise, as above); either dispatch gives the routed sum."""
    monkeypatch.setattr(ref_moe, "TOKEN_DISPATCH", dispatch)
    monkeypatch.setattr(moe, "TOKEN_DISPATCH", dispatch)
    ref_cfg, cfg, rp, tp = _ffn(name, torch.float32)
    x, rx = _x(cfg, (8, cfg.d_model), torch.float32, seed=1)
    ry = ref_moe.moe_apply_token(ref_cfg, rp, rx)
    y = moe.moe_apply_token(cfg, tp, x)
    assert y.shape == (8, cfg.d_model)
    assert _rel(y.numpy(), np.asarray(ry)) <= 1e-5
    # one token per row never meets a capacity: moe_apply at a capacity
    # past every expert's load routes the same
    y_full, _ = moe.moe_apply(cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0)), tp, x[:, None, :])
    assert _rel(y_full[:, 0].numpy(), y.numpy()) <= 1e-5

    _, _, rp16, tp16 = _ffn(name, torch.bfloat16)
    x16, rx16 = _x(cfg, (8, cfg.d_model), torch.bfloat16, seed=1)
    ref32 = ref_moe.moe_apply_token(ref_cfg, rp, rx16.astype(jnp.float32))
    noise = _rel(np.asarray(ref_moe.moe_apply_token(
        ref_cfg, rp16, rx16).astype(jnp.float32)), ref32)
    y16 = moe.moe_apply_token(cfg, tp16, x16)
    assert _rel(y16.float().numpy(), ref32) <= 1.25 * noise


def test_capacity_and_specs_match_reference():
    for args in [(512, 8, 64, 1.25), (512, 6, 64, 1.25), (16, 2, 64, 1.0),
                 (128, 2, 4, 16.0)]:
        assert moe._capacity(*args) == ref_moe._capacity(*args)
    for name in ARCHS:
        ref_cfg, cfg = arch_pair(name)
        specs = moe.moe_specs(cfg)
        ref_specs = ref_moe.moe_specs(ref_cfg)
        flat_ref = {}
        for k, v in ref_specs.items():
            if isinstance(v, dict):
                flat_ref.update({f"{k}.{kk}": vv for kk, vv in v.items()})
            else:
                flat_ref[k] = v
        assert sorted(specs) == sorted(flat_ref)
        for k, s in specs.items():
            assert s.shape == flat_ref[k].shape, k
            assert (s.dtype == torch.float32) == \
                (flat_ref[k].dtype == jnp.float32), k
        assert specs["router"].dtype == torch.float32
