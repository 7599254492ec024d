"""The port's tensor core against the reference: the quantizer and the LTFL
compressor (with the reference's uniforms), range_sq_sum, the payload
formula, magnitude pruning (masks bitwise), aggregation (including the
all-dropped round) and SGD. Mirrors tests/test_quantization.py,
test_pruning.py and test_aggregation.py.

Tolerances: quantized values agree to one ulp (XLA fuses
lo + level * scale into an FMA; the port rounds the product), so
``assert_quant_close`` allows a < 1e-3 fraction of elements off by more
than 1e-6, and none by more than one quantization step, as
tests/test_kernels.py does; sums taken in another order get rtol 1e-6.
"""
import itertools

import numpy as np
import pytest
import torch

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.core.aggregation import aggregate as ref_aggregate
from repro.core.compressors import ltfl_quantizer as ref_ltfl_quantizer
from repro.core.pruning import magnitude_prune_pytree as ref_prune
from repro.core.quantization import payload_bits_host as ref_payload
from repro.core.quantization import quantize_dequantize as ref_qd
from repro.core.quantization import range_sq_sum as ref_range_sq_sum
from repro.optim import apply_updates as ref_apply
from repro.optim import global_norm as ref_global_norm
from repro.optim import sgd as ref_sgd
from repro_torch.core.aggregation import aggregate
from repro_torch.core.compressors import ltfl_quantizer
from repro_torch.core.pruning import magnitude_prune_pytree
from repro_torch.core.quantization import (
    payload_bits_host,
    quant_error_bound,
    quantize_dequantize,
    quantize_pytree,
    range_sq_sum,
)
from repro_torch.optim import apply_updates, global_norm, sgd

from torch_parity import jax_uniforms


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_quant_close(out, ref, step):
    diff = np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32))
    assert np.mean(diff > 1e-6) < 1e-3
    assert diff.max() <= step * 1.001 + 1e-7


@pytest.mark.parametrize("bits,seed",
                         list(itertools.product((1, 2, 4, 8), (0, 7))))
def test_quantize_dequantize_matches_reference(bits, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(scale=rng.uniform(0.01, 10.0), size=(33, 17)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(seed)
    rand = np.asarray(jax.random.uniform(key, g.shape))
    ref = np.asarray(ref_qd(jnp.asarray(g), bits, key))
    out = quantize_dequantize(_t(g), bits, _t(rand)).numpy()
    a = np.abs(g)
    step = (a.max() - a.min()) / (2 ** bits - 1)
    assert_quant_close(out, ref, step)
    assert np.max(np.abs(out - g)) <= step * 1.001      # within one step


def test_quantizer_properties():
    gen = torch.Generator()
    gen.manual_seed(0)
    g = torch.randn(2048, generator=gen)
    a = g.abs()
    step = float((a.max() - a.min()) / 7)
    reps = torch.stack([quantize_dequantize(g, 3, torch.rand(
        2048, generator=gen)) for _ in range(200)])
    # unbiased (Lemma 1): MC standard error is step / (2 sqrt(200))
    assert float((reps.mean(0) - g).abs().mean()) < step * 0.15
    assert bool(torch.all(torch.sign(reps[0]) == torch.sign(g)))
    rsq = float((a.max() - a.min()) ** 2) * g.numel()
    err = float(((reps[0] - g) ** 2).sum())
    assert err <= 4.0 * float(quant_error_bound(torch.tensor(rsq), 3))
    const = quantize_dequantize(torch.full((128,), 0.7), 4, torch.rand(128))
    torch.testing.assert_close(const, torch.full((128,), 0.7))
    tree = {"a": torch.randn(8, 8), "b": torch.ones(5)}
    out = quantize_pytree(tree, 8, [torch.rand(8, 8), torch.rand(5)])
    assert list(out) == ["a", "b"] and out["a"].shape == (8, 8)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ltfl_compressor_matches_reference(use_kernels):
    """The port's compressor on stacked (C, ...) grads, fed the reference's
    uniforms, against the reference's compressor vmapped over clients —
    2-D, 4-D and 1-D leaves, mixed bits and a delta = 0 passthrough."""
    c = 4
    rng = np.random.default_rng(3)
    grads = {"b": rng.normal(size=(c, 16)),
             "v": rng.normal(size=(c, 64, 32)),
             "w": rng.normal(size=(c, 2, 3, 4, 8))}
    grads = {k: v.astype(np.float32) for k, v in grads.items()}
    delta = np.array([0.0, 1.0, 4.0, 8.0], np.float32)
    seed = 1234
    keys = jax.random.split(jax.random.PRNGKey(seed), c + 1)[:c]
    comp = ref_ltfl_quantizer(use_kernels=use_kernels)
    ref, _ = jax.jit(jax.vmap(comp.compress, in_axes=(0, 0, 0, None)))(
        {k: jnp.asarray(v) for k, v in grads.items()}, jnp.asarray(delta),
        keys, ())
    out, _ = ltfl_quantizer(uniforms=jax_uniforms).compress(
        {k: _t(v) for k, v in grads.items()}, _t(delta), seed, ())
    for k, g in grads.items():
        for i in range(c):
            a = np.abs(g[i])
            bits = max(delta[i], 1.0)
            step = (a.max() - a.min()) / (2 ** bits - 1)
            assert_quant_close(out[k][i].numpy(), np.asarray(ref[k][i]),
                               step)
        np.testing.assert_array_equal(out[k][0].numpy(), g[0])  # delta 0


def test_range_sq_sum_and_payload_match_reference():
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(3, 64, 64)).astype(np.float32),
            "b": np.ones((3, 32), np.float32),
            "c": rng.normal(size=(3, 7)).astype(np.float32)}
    port = range_sq_sum({k: _t(v) for k, v in tree.items()},
                        client_axis=True).numpy()
    ref = np.asarray(jax.vmap(ref_range_sq_sum)(
        {k: jnp.asarray(v) for k, v in tree.items()}))
    np.testing.assert_allclose(port, ref, rtol=1e-6)
    one = {k: _t(v[0]) for k, v in tree.items()}
    assert float(range_sq_sum(one)) == pytest.approx(float(ref[0]),
                                                     rel=1e-6)
    assert float(range_sq_sum({"c": torch.ones(100)})) == 0.0
    for num_params in (1000, 98_762, 4_901_450, 123_456_789):
        for bits in (0.0, 1.0, 8.0, np.arange(9.0), np.array([3.5, 32.0])):
            np.testing.assert_array_equal(
                payload_bits_host(num_params, bits, 64),
                ref_payload(num_params, bits, 64))


def _prune_both(tree, rho):
    pj, mj = ref_prune({k: jnp.asarray(v) for k, v in tree.items()},
                       jnp.float32(rho))
    pt, mt = magnitude_prune_pytree({k: _t(v) for k, v in tree.items()},
                                    torch.tensor(rho, dtype=torch.float32))
    return pj, mj, pt, mt


@pytest.mark.parametrize("rho", [0.0, 0.1, 0.25, 0.5, 0.9, 1.0])
def test_magnitude_prune_masks_bitwise(rho):
    rng = np.random.default_rng(5)
    tree = {"w": rng.normal(size=(12, 9)).astype(np.float32),
            "conv": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
            # ties: a stable sort must break them by position
            "tied": np.repeat(rng.normal(size=(6, 1)), 10, axis=1)
            .astype(np.float32),
            "bias": rng.normal(size=(9,)).astype(np.float32)}
    tree["tied"][::2] *= -1.0
    pj, mj, pt, mt = _prune_both(tree, rho)
    for k in tree:
        np.testing.assert_array_equal(mt[k].numpy(), np.asarray(mj[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]),
                                      err_msg=k)
    assert bool(mt["bias"].all())                     # 1-D leaves exempt
    n = tree["w"].size
    assert int((~mt["w"]).sum()) == int(np.floor(np.float32(rho) * n))


def test_prune_count_is_computed_in_float32():
    """k = floor(rho * n) in f32: find rhos where the f64 product floors
    differently, and hold the masks there."""
    shape = (3, 3, 64, 64)          # a conv leaf of the paper's ResNet
    n = int(np.prod(shape))
    differ = []
    for k in range(1, n, 101):
        # the largest f32 rho whose exact product with n falls below k
        r = np.float32(k / n)
        while np.float64(r) * n >= k:
            r = np.nextafter(r, np.float32(0.0))
        if np.floor(r * np.float32(n)) != np.floor(np.float64(r) * n):
            differ.append(r)
    assert differ, "no f32/f64 disagreement at this n"
    rng = np.random.default_rng(6)
    tree = {"w": rng.normal(size=shape).astype(np.float32)}
    for rho in differ[:3]:
        _, mj, _, mt = _prune_both(tree, float(rho))
        np.testing.assert_array_equal(mt["w"].numpy(), np.asarray(mj["w"]))


def test_per_client_rho_stacks_masks():
    rng = np.random.default_rng(8)
    w = rng.normal(size=(10, 10)).astype(np.float32)
    rhos = np.array([0.0, 0.3, 0.55], np.float32)
    pt, mt = magnitude_prune_pytree({"w": _t(w), "b": torch.ones(4)},
                                    _t(rhos))
    assert tuple(pt["w"].shape) == (3, 10, 10)
    assert tuple(pt["b"].shape) == (4,)
    for i, rho in enumerate(rhos):
        _, mj = ref_prune({"w": jnp.asarray(w)}, jnp.float32(rho))
        np.testing.assert_array_equal(mt["w"][i].numpy(),
                                      np.asarray(mj["w"]))


def test_aggregate_matches_reference():
    rng = np.random.default_rng(9)
    g = {"w": rng.normal(size=(5, 6, 4)).astype(np.float32),
         "b": rng.normal(size=(5, 3)).astype(np.float32)}
    weights = np.array([400.0, 512.0, 600.0, 455.0, 503.0], np.float32)
    for alpha, denom in (([1, 1, 1, 1, 1], None), ([1, 0, 1, 0, 1], None),
                         ([0, 1, 1, 0, 1], 9000.0), ([0, 0, 0, 0, 0], None)):
        alpha = np.asarray(alpha, np.float32)
        ref = ref_aggregate({k: jnp.asarray(v) for k, v in g.items()},
                            jnp.asarray(weights), jnp.asarray(alpha),
                            denom=denom)
        out = aggregate({k: _t(v) for k, v in g.items()}, _t(weights),
                        _t(alpha), denom=denom)
        for k in g:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-6, atol=1e-7)
        if not alpha.any():                  # every packet dropped
            assert all(bool((v == 0).all()) for v in out.values())
    out = aggregate({"w": torch.ones(2, 4, dtype=torch.bfloat16)},
                    torch.tensor([1.0, 3.0]), torch.tensor([1.0, 1.0]))
    assert out["w"].dtype == torch.bfloat16 and out["w"].shape == (4,)


def test_sgd_matches_reference():
    rng = np.random.default_rng(10)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
    ropt, popt = ref_sgd(0.05), sgd(0.05)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rg = {k: jnp.asarray(v) for k, v in grads.items()}
    tp = {k: _t(v) for k, v in params.items()}
    tg = {k: _t(v) for k, v in grads.items()}
    ru, _ = ropt.update(rg, ropt.init(rp), rp)
    tu, _ = popt.update(tg, popt.init(tp), tp)
    ref_new, new = ref_apply(rp, ru), apply_updates(tp, tu)
    lu, _ = popt.update_with_lr(tg, (), tp, torch.tensor(0.05))
    for k in params:
        np.testing.assert_array_equal(new[k].numpy(), np.asarray(ref_new[k]))
        np.testing.assert_array_equal(lu[k].numpy(), tu[k].numpy())
    np.testing.assert_allclose(float(global_norm(tg)),
                               float(ref_global_norm(rg)), rtol=1e-6)


def test_injected_draws_are_the_reference_step_draws():
    """``jax_uniforms`` (the parity tests' injection hook) gives exactly
    the uniforms the reference step draws: split the round key into C + 1,
    each client key per leaf, ``uniform(k, leaf.shape)``."""
    shapes = [(16,), (3, 3, 2, 4), (5, 7)]
    got = jax_uniforms(77, 3, shapes)
    keys = jax.random.split(jax.random.PRNGKey(77), 4)
    for c in range(3):
        leaf_keys = jax.random.split(keys[c], len(shapes))
        for i, s in enumerate(shapes):
            np.testing.assert_array_equal(
                got[i][c].numpy(),
                np.asarray(jax.random.uniform(leaf_keys[i], s)))
