"""The datacenter step with the int8 wire format
(``make_fl_train_step(..., int8_collective=True)``), a compressor given
by name, and ``make_plain_train_step``, against the reference.

granite-8b at ``reduce_for_smoke`` widths in float32, C = 4 clients with
their own rho, delta, drop_prob and weights, block pruning at block 32
(the launcher's step). Both sides start from the same weights and batch;
the port gets the reference's int8 uniforms (``quantize_int8_pytree``
splits each client's key per leaf and draws ``uniform(k, leaf.shape)``,
the draws ``torch_parity.jax_uniforms`` rebuilds) and its drop draw.
Checked:

* tile and element masks bitwise; clients received equal;
* loss rel 1e-5 (float32; seen equal), grad_norm of the bfloat16
  aggregate rel 1e-5 (seen 5e-7);
* the update of every leaf (new - old weights; the aggregate is
  bfloat16, as in the reference, so the update carries its rounding):
  at most 2% of a leaf's elements more than one bfloat16 ulp of the
  reference's update off (seen 0.39%, two of ln1.gamma's 512: int8 level
  flips where the float32 gradients differ in their last bits), none
  farther than the leaf's largest reference update, and the update's
  relative norm error at most 1e-2 (seen 9.0e-4).

AdamW on the int8 step gets the same masks, loss and received count; its
first update is lr * sign(g) where |g| >> eps, so a gradient at the noise
level can flip an element's sign: at most 1e-4 of a leaf's elements may
differ by more than 1e-4 lr (seen 5e-6 of ffn.wi_up), none by more than
2 lr.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.core.ltfl_step import make_fl_train_step as ref_make_step
from repro.core.ltfl_step import make_plain_train_step as ref_plain_step
from repro.core.pruning import prune_pytree as ref_prune_pytree
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.optim import sgd as ref_sgd
from repro_torch.core import get_compressor, make_plain_train_step
from repro_torch.core.compressors import ltfl_quantizer, stc_compressor
from repro_torch.core.ltfl_step import make_fl_train_step
from repro_torch.core.pruning import element_masks, prune_pytree
from repro_torch.kernels.stochastic_quant import LAUNCHES
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import adamw, sgd

from torch_parity import (
    as_jax,
    jax_drop_uniforms,
    jax_uniforms,
    lm_arch,
    lm_weights,
    tree_numpy,
)

C, LR, BLOCK, SEED = 4, 0.05, 32, 3
CONTROLS = {"rho": np.array([0.25, 0.1, 0.5, 0.25], np.float32),
            "delta": np.array([8.0, 8.0, 4.0, 2.0], np.float32),
            "drop_prob": np.array([0.05, 0.05, 0.6, 0.3], np.float32),
            "weights": np.array([500.0, 450.0, 520.0, 610.0], np.float32)}


def _batch(b=2, seq=64):
    tokens = np.random.default_rng(1).integers(
        0, lm_arch()[1].vocab_size, (C, b, seq)).astype(np.int32)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)},
            {"tokens": torch.from_numpy(tokens).long(),
             "labels": torch.from_numpy(tokens).long()})


def _controls():
    return ({k: jnp.asarray(v) for k, v in CONTROLS.items()},
            {k: torch.from_numpy(v) for k, v in CONTROLS.items()})


def _bf16_ulp(x):
    a = x.abs().to(torch.bfloat16)
    up = torch.nextafter(a, torch.full_like(a, float("inf")))
    return up.to(torch.float32) - a.to(torch.float32)


def _steps(ref_opt, opt):
    """One int8 step on each side from the same float32 weights."""
    ref_cfg, cfg = lm_arch()
    w0 = lm_weights(seed=0)
    rb, tb = _batch()
    rc, tc = _controls()
    rp = as_jax(w0, jnp.float32)
    ref_step = jax.jit(ref_make_step(ref_build_model(ref_cfg), ref_opt, C,
                                     prune_block=BLOCK,
                                     int8_collective=True))
    rp1, _, _, rm = ref_step(rp, ref_opt.init(rp), (), rb, rc,
                             jax.random.PRNGKey(SEED))
    step = make_fl_train_step(build_model(cfg), opt, C, prune_block=BLOCK,
                              prune_kind="block", int8_collective=True,
                              int8_uniforms=jax_uniforms,
                              drop_uniforms=jax_drop_uniforms)
    p0 = {k: v.to(torch.float32) for k, v in params_from_numpy(w0).items()}
    comp_state = step.init_comp_state(p0)
    before = dict(LAUNCHES)
    p1, _, comp1, m = step(p0, opt.init(p0), comp_state, tb, tc, SEED)
    assert LAUNCHES == before          # the B1 quantizer is not reached
    assert comp1 is comp_state         # the compressor's state passes
    return p0, p1, m, params_from_numpy(tree_numpy(rp1)), rm, rp, tc


def _check_masks_and_metrics(p0, m, rm, rp, tc):
    _, masks = prune_pytree(p0, tc["rho"], block=BLOCK)
    got = element_masks(p0, masks, BLOCK)
    want = params_from_numpy(tree_numpy(jax.jit(jax.vmap(
        lambda p, r: ref_prune_pytree(p, r, block=BLOCK)[1],
        in_axes=(None, 0)))(rp, jnp.asarray(CONTROLS["rho"]))))
    assert list(got) == list(want)
    for k, g in got.items():
        np.testing.assert_array_equal(
            np.broadcast_to(g.numpy(), want[k].shape), want[k].numpy(),
            err_msg=k)
    assert float(m["clients_received"]) == float(rm["clients_received"])
    assert abs(float(m["loss"]) - float(rm["loss"])) \
        <= 1e-5 * abs(float(rm["loss"]))
    np.testing.assert_allclose(m["range_sq"].numpy(),
                               np.asarray(rm["range_sq"]), rtol=1e-4)


def test_int8_step_matches_reference():
    p0, p1, m, ref1, rm, rp, tc = _steps(ref_sgd(LR), sgd(LR))
    _check_masks_and_metrics(p0, m, rm, rp, tc)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-5)
    for k, v0 in p0.items():
        assert p1[k].dtype == torch.float32, k
        upd, ref_upd = p1[k] - v0, ref1[k] - v0
        diff = (upd - ref_upd).abs()
        assert float((diff > _bf16_ulp(ref_upd)).float().mean()) <= 0.02, k
        assert bool((diff <= ref_upd.abs().max()).all()), k
        if float(ref_upd.norm()) > 0:
            assert float((upd - ref_upd).norm() / ref_upd.norm()) <= 1e-2, k


def test_int8_step_with_adamw_matches_reference():
    p0, p1, m, ref1, rm, rp, tc = _steps(ref_adamw(LR), adamw(LR))
    _check_masks_and_metrics(p0, m, rm, rp, tc)
    for k, v0 in p0.items():
        diff = ((p1[k] - v0) - (ref1[k] - v0)).abs()
        assert float((diff > 1e-4 * LR).float().mean()) <= 1e-4, k
        assert float(diff.max()) <= 2 * LR * (1 + 1e-6), k


def test_int8_collective_rejects_an_explicit_compressor_and_yields_to_quantize():
    model = build_model(lm_arch()[1])
    for spec in (ltfl_quantizer(), "stc"):
        with pytest.raises(ValueError, match="wire-format override"):
            make_fl_train_step(model, sgd(LR), C, compressor=spec,
                               int8_collective=True)
    # quantize=False: the flag has no effect (the full-precision step)
    _, tb = _batch()
    _, tc = _controls()
    p0 = {k: v.to(torch.float32)
          for k, v in params_from_numpy(lm_weights(seed=0)).items()}
    outs = []
    for flag in (False, True):
        step = make_fl_train_step(model, sgd(LR), C, prune_block=BLOCK,
                                  quantize=False, int8_collective=flag,
                                  drop_uniforms=jax_drop_uniforms)
        outs.append(step(p0, (), (), tb, tc, SEED)[0])
    for k in p0:
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_compressor_given_by_name():
    """A registry name builds the same stage as the factory: "stc" and
    "none" give bitwise the steps of ``stc_compressor()`` and
    ``quantize=False``, "ltfl" the default step."""
    model = build_model(lm_arch()[1])
    _, tb = _batch()
    _, tc = _controls()
    p0 = {k: v.to(torch.float32)
          for k, v in params_from_numpy(lm_weights(seed=0)).items()}
    pairs = (("stc", dict(compressor=stc_compressor())),
             ("none", dict(quantize=False)),
             ("ltfl", {}))
    for name, kw in pairs:
        outs = []
        for spec in (dict(compressor=name), kw):
            step = make_fl_train_step(model, sgd(LR), C, prune_block=BLOCK,
                                      drop_uniforms=jax_drop_uniforms,
                                      **spec)
            assert step.compressor.name == get_compressor(name).name
            p1, _, cs, _ = step(p0, (), step.init_comp_state(p0), tb, tc,
                                SEED)
            outs.append((p1, cs))
        for k in p0:
            assert torch.equal(outs[0][0][k], outs[1][0][k]), (name, k)
    with pytest.raises(KeyError):
        make_fl_train_step(model, sgd(LR), C, compressor="nope")


def test_plain_step_matches_reference():
    """``make_plain_train_step``: one global batch of 8 x 64, no client
    axis, two steps of SGD in float32 from the same weights: loss rel
    1e-5, grad_norm rel 1e-4, the weights within 1e-3 of the leaf's
    largest update (plus 1e-6)."""
    ref_cfg, cfg = lm_arch()
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (8, 64)).astype(np.int32)
    rb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens).long(),
          "labels": torch.from_numpy(tokens).long()}
    w0 = lm_weights(seed=0)
    rp = as_jax(w0, jnp.float32)
    ref_step = jax.jit(ref_plain_step(ref_build_model(ref_cfg),
                                      ref_sgd(LR)))
    step = make_plain_train_step(build_model(cfg), sgd(LR))
    tp = {k: v.to(torch.float32) for k, v in params_from_numpy(w0).items()}
    p0 = tp
    ro, to = (), ()
    for i in range(2):
        rp, ro, rm = ref_step(rp, ro, rb, jax.random.PRNGKey(i))
        tp, to, m = step(tp, to, tb, i)
        assert set(m) == {"loss", "grad_norm"}
        assert abs(float(m["loss"]) - float(rm["loss"])) \
            <= 1e-5 * abs(float(rm["loss"])), i
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
    ref = params_from_numpy(tree_numpy(rp))
    for k, v in tp.items():
        upd = (ref[k] - p0[k]).abs().max()
        assert float((v - ref[k]).abs().max()) <= 1e-6 + 1e-3 * float(upd), k
