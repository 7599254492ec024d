"""The port's datacenter step (block pruning at block 32, the LTFL
quantizer, in-step packet drops) against the reference's jitted step.

granite-8b at ``reduce_for_smoke`` widths, bfloat16 parameters, C = 4
clients with their own rho, delta, drop_prob and weights, 3 steps. The
reference runs its launcher's step (``make_fl_train_step(...,
prune_block=32)``: block pruning through its jnp path, the jnp
quantizer). The port gets the reference's quantizer uniforms and drop
draw for each step seed (``torch_parity``).

Each step starts both sides from the reference's weights of that step,
so every comparison is of one step:

* tile and element masks: bitwise (the port's ``prune_pytree`` on those
  weights against the reference's);
* clients received: equal (the same drop draw);
* loss rel 1e-3 and each client's range_sq rel 5e-2 (bf16 gradients,
  ~1.5% apart in norm, see tests/test_torch_transformer.py; seen: loss
  2e-5, range_sq 1.7e-2); grad_norm of the aggregate rel 5e-3 (seen
  6e-4);
* updated weights: an update is 1-2 bf16 ulps of a weight, and the
  bf16 gradients' differences move a stochastic level across its
  boundary now and then (a one-level quantizer flip). So per leaf at
  most 5% of the elements may differ by more than one bf16 ulp of the
  reference's value (seen: up to 2.8%, embed.tok), none by more than
  the leaf's largest reference update plus one ulp, and the update's
  relative norm error is at most 0.25 (seen: up to 0.17).

Three free-running steps from the same start then agree in loss to rel
1e-2 (seen 3e-3: the runs drift apart by the flips above).
"""
import numpy as np
import pytest
import torch

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.core.ltfl_step import make_fl_train_step as ref_make_step
from repro.core.pruning import prune_pytree as ref_prune_pytree
from repro.models import build_model as ref_build_model
from repro.optim import sgd as ref_sgd
from repro_torch.core import compressors
from repro_torch.core.compressors import ltfl_quantizer, torch_uniforms
from repro_torch.core.ltfl_step import make_fl_train_step
from repro_torch.core.pruning import element_masks, prune_pytree
from repro_torch.kernels import ops
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import sgd

from torch_parity import (
    as_jax,
    jax_drop_uniforms,
    jax_uniforms,
    lm_arch,
    lm_weights,
    tree_numpy,
)

C, LR, BLOCK, STEPS = 4, 0.05, 32, 3
CONTROLS = {"rho": np.array([0.25, 0.1, 0.5, 0.25], np.float32),
            "delta": np.array([8.0, 8.0, 4.0, 2.0], np.float32),
            "drop_prob": np.array([0.05, 0.05, 0.6, 0.3], np.float32),
            "weights": np.array([500.0, 450.0, 520.0, 610.0], np.float32)}


def _batch():
    tokens = np.random.default_rng(1).integers(
        0, lm_arch()[1].vocab_size, (C, 2, 64)).astype(np.int32)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)},
            {"tokens": torch.from_numpy(tokens).long(),
             "labels": torch.from_numpy(tokens).long()})


def _port_step(prune_kind="block"):
    return make_fl_train_step(
        build_model(lm_arch()[1]), sgd(LR), C, prune_block=BLOCK,
        prune_kind=prune_kind,
        compressor=ltfl_quantizer(uniforms=jax_uniforms),
        drop_uniforms=jax_drop_uniforms)


@pytest.fixture(scope="module")
def reference():
    """The reference's 3-step trajectory: weights before each step and
    after the last (numpy trees), and each step's metrics."""
    ref_cfg, _ = lm_arch()
    step = jax.jit(ref_make_step(ref_build_model(ref_cfg), ref_sgd(LR), C,
                                 prune_block=BLOCK))
    rb, _ = _batch()
    ctl = {k: jnp.asarray(v) for k, v in CONTROLS.items()}
    params = as_jax(lm_weights(seed=0), jnp.bfloat16)
    weights, metrics = [tree_numpy(params)], []
    for i in range(STEPS):
        params, _, _, m = step(params, (), (), rb, ctl,
                               jax.random.PRNGKey(i))
        weights.append(tree_numpy(params))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return weights, metrics


def _f32(t):
    return t.to(torch.float32)


def _ulp(x):
    """One bf16 ulp at |x| (float32)."""
    a = x.abs().to(torch.bfloat16)
    up = torch.nextafter(a, torch.full_like(a, float("inf")))
    return _f32(up) - _f32(a)


def test_each_step_matches_reference(reference):
    weights, metrics = reference
    step = _port_step()
    _, tb = _batch()
    tc = {k: torch.from_numpy(v) for k, v in CONTROLS.items()}
    ref_masks = jax.jit(jax.vmap(
        lambda p, r: ref_prune_pytree(p, r, block=BLOCK)[1],
        in_axes=(None, 0)))
    received = []
    for i in range(STEPS):
        p0 = params_from_numpy(weights[i])
        assert all(v.dtype == torch.bfloat16 for v in p0.values())
        p1, _, _, m = step(p0, (), (), tb, tc, i)
        rm = metrics[i]
        # masks
        _, masks = prune_pytree(p0, tc["rho"], block=BLOCK)
        got = element_masks(p0, masks, BLOCK)
        want = params_from_numpy(tree_numpy(ref_masks(
            as_jax(weights[i], jnp.bfloat16), jnp.asarray(CONTROLS["rho"]))))
        assert list(got) == list(want)
        for k, g in got.items():
            np.testing.assert_array_equal(
                np.broadcast_to(g.numpy(), want[k].shape), want[k].numpy(),
                err_msg=f"step {i} {k}")
        # metrics
        assert float(m["clients_received"]) == float(rm["clients_received"])
        received.append(float(m["clients_received"]))
        assert abs(float(m["loss"]) - float(rm["loss"])) \
            <= 1e-3 * abs(float(rm["loss"]))
        np.testing.assert_allclose(m["range_sq"].numpy(), rm["range_sq"],
                                   rtol=5e-2)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=5e-3)
        # updated weights
        ref1 = params_from_numpy(weights[i + 1])
        for k, v0 in p0.items():
            assert p1[k].dtype == torch.bfloat16
            new, want_new, old = _f32(p1[k]), _f32(ref1[k]), _f32(v0)
            diff = (new - want_new).abs()
            ulp = _ulp(want_new)
            assert float((diff > ulp).float().mean()) <= 0.05, (i, k)
            ref_upd = want_new - old
            assert bool((diff <= ref_upd.abs().max() + ulp).all()), (i, k)
            if float(ref_upd.norm()) > 0:
                err = float(((new - old) - ref_upd).norm() / ref_upd.norm())
                assert err <= 0.25, (i, k, err)
    # the drop draws took clients out of the aggregate
    assert min(received) < C


def test_free_running_steps_match_reference_loss(reference):
    weights, metrics = reference
    step = _port_step()
    _, tb = _batch()
    tc = {k: torch.from_numpy(v) for k, v in CONTROLS.items()}
    params = params_from_numpy(weights[0])
    for i in range(STEPS):
        params, _, _, m = step(params, (), (), tb, tc, i)
        assert np.isfinite(float(m["loss"]))
        np.testing.assert_allclose(float(m["loss"]),
                                   float(metrics[i]["loss"]), rtol=1e-2)


def test_magnitude_prune_kind_matches_reference():
    """prune_kind="magnitude" with host alpha on the same model: one
    step against the reference's (element masks, no drop draw)."""
    ref_cfg, _ = lm_arch()
    rb, tb = _batch()
    ctl = {k: v for k, v in CONTROLS.items() if k != "drop_prob"}
    ctl["alpha"] = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    ref_step = jax.jit(ref_make_step(ref_build_model(ref_cfg), ref_sgd(LR),
                                     C, prune_kind="magnitude"))
    tree = lm_weights(seed=0)
    rp, _, _, rm = ref_step(as_jax(tree, jnp.bfloat16), (), (), rb,
                            {k: jnp.asarray(v) for k, v in ctl.items()},
                            jax.random.PRNGKey(5))
    p0 = {k: v.to(torch.bfloat16) for k, v in
          params_from_numpy(tree).items()}
    p1, _, _, m = _port_step("magnitude")(
        p0, (), (), tb, {k: torch.from_numpy(v) for k, v in ctl.items()}, 5)
    assert float(m["clients_received"]) == 3.0 == float(
        rm["clients_received"])
    assert abs(float(m["loss"]) - float(rm["loss"])) \
        <= 1e-3 * abs(float(rm["loss"]))
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]),
                               rtol=5e-3)
    ref1 = params_from_numpy(tree_numpy(rp))
    for k, v0 in p0.items():
        diff = (_f32(p1[k]) - _f32(ref1[k])).abs()
        assert float((diff > _ulp(_f32(ref1[k]))).float().mean()) <= 0.05, k


def _eager_uniforms(seed, n_clients, shapes, device):
    """The quantizer's draw as it was before it became lazy: every leaf's
    uniforms at once."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return [torch.rand((n_clients,) + tuple(s), generator=gen,
                       device=device, dtype=torch.float32) for s in shapes]


def test_lazy_uniforms_equal_the_eager_draw(monkeypatch):
    """torch_uniforms draws each leaf when asked, from the same generator
    in the same order: bitwise the old list; and the quantizer asks for
    a leaf's uniforms only after quantizing the previous leaf."""
    shapes = [(16,), (3, 3, 2, 4), (5, 7), (64, 32)]
    lazy = torch_uniforms(11, 3, shapes, torch.device("cpu"))
    assert not isinstance(lazy, (list, tuple))
    for a, b in zip(lazy, _eager_uniforms(11, 3, shapes, "cpu"),
                    strict=True):
        assert torch.equal(a, b)

    events = []

    def recording_uniforms(seed, n_clients, shapes):
        for i, r in enumerate(torch_uniforms(seed, n_clients, shapes,
                                             torch.device("cpu"))):
            events.append(("draw", i))
            yield r

    real = ops.quantize_dequantize_2d_dyn

    def recording_quant(g, bits, **kw):
        events.append(("quantize", len([e for e in events
                                        if e[0] == "quantize"])))
        return real(g, bits, **kw)

    monkeypatch.setattr(compressors.ops, "quantize_dequantize_2d_dyn",
                        recording_quant)
    grads = {f"l{i}": torch.randn((3,) + s) for i, s in enumerate(shapes)}
    delta = torch.tensor([8.0, 4.0, 2.0])
    lazy_out, _ = ltfl_quantizer(uniforms=recording_uniforms).compress(
        grads, delta, 11, ())
    assert events == [e for i in range(len(shapes))
                      for e in (("draw", i), ("quantize", i))]
    eager_out, _ = ltfl_quantizer(
        uniforms=lambda s, c, sh: _eager_uniforms(s, c, sh, "cpu")
    ).compress(grads, delta, 11, ())
    default_out, _ = ltfl_quantizer().compress(grads, delta, 11, ())
    for k in grads:
        assert torch.equal(lazy_out[k], eager_out[k])
        assert torch.equal(default_out[k], eager_out[k])
