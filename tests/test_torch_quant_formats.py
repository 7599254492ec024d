"""The quantizer's integer-level form (``QTensor``, ``quantize``,
``dequantize``), the int8 wire format (``quantize_int8``,
``dequantize_int8``, ``quantize_int8_pytree``) and the static-bits entry
points (``kernels.stochastic_quant.stochastic_quant_static``,
``kernels.ops.quantize_dequantize_2d``, ``kernel_quant_compatible``)
against the reference, on the same inputs and the reference's own
uniforms (``jax.random.uniform`` of the key it would split).

What was found, and is held here:

* levels, signs, lo, hi, int8 levels and scales are bitwise equal;
* the port's ``dequantize`` is bitwise the reference's run op by op
  (eager), and bitwise the port's fused ``quantize_dequantize`` (its
  plain version on the CPU) after the cast to g's dtype;
* under ``jax.jit``, and in the reference's static kernel path (a jitted
  Pallas call in interpret mode), XLA's CPU backend fuses lo + level *
  scale into one FMA, which rounds once where the port rounds the
  product first: up to 32% of the float32 elements then differ by one
  float32 ulp (seen at 8 bits), none by more. bfloat16 outputs differ
  by at most one bfloat16 ulp (seen: none).
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.core import quantization as rq
from repro.kernels import ops as rops
from repro.kernels.stochastic_quant import stochastic_quant as ref_static
from repro_torch.core import quantization as tq
from repro_torch.kernels import ops
from repro_torch.kernels.stochastic_quant import (
    LAUNCHES,
    stochastic_quant_static,
)

SHAPES = [(128, 128), (256, 512)]
DTYPES = ["float32", "bfloat16"]
BITS = [1, 2, 4, 8]


def _inputs(shape, dtype, seed):
    g = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return (jnp.asarray(g).astype(getattr(jnp, dtype)),
            torch.from_numpy(g).to(getattr(torch, dtype)))


def _uniforms(key, shape):
    return torch.from_numpy(np.array(jax.random.uniform(key, shape)))


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.to(torch.float32).numpy()


def _within_one_ulp(got, want, dtype):
    """|got - want| <= one ulp of want in ``dtype`` (float32 or bf16)."""
    got, want = _f32(got), _f32(want)
    if dtype == "float32":
        ulp = np.spacing(np.abs(want))
    else:
        ulp = np.abs(want) * 2.0 ** -7 + 1e-38
    assert np.all(np.abs(got - want) <= ulp)
    return float(np.mean(got != want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", BITS)
def test_qtensor_quantize_dequantize_match_reference(bits, dtype):
    shape = (96, 160)
    gj, gt = _inputs(shape, dtype, seed=bits)
    key = jax.random.PRNGKey(10 + bits)
    q = rq.quantize(gj, bits, key)
    qt = tq.quantize(gt, bits, _uniforms(key, shape))
    assert isinstance(qt, tq.QTensor)
    assert qt.levels.dtype == torch.float32 and qt.sign.dtype == torch.bool
    np.testing.assert_array_equal(qt.levels.numpy(), np.asarray(q.levels))
    np.testing.assert_array_equal(qt.sign.numpy(), np.asarray(q.sign))
    assert float(qt.lo) == float(q.lo) and float(qt.hi) == float(q.hi)
    assert float(qt.bits) == float(q.bits)
    assert float(qt.levels.max()) <= 2 ** bits - 1
    # op by op on both sides: bitwise
    deq = tq.dequantize(qt)
    assert deq.dtype == torch.float32
    np.testing.assert_array_equal(deq.numpy(),
                                  np.asarray(rq.dequantize(q)))
    # the fused form the step runs (plain version on the CPU): bitwise
    fused = tq.quantize_dequantize(gt, bits, _uniforms(key, shape))
    assert torch.equal(deq.to(gt.dtype), fused)
    # jitted, XLA fuses an FMA: one float32 ulp at most
    _within_one_ulp(deq, jax.jit(rq.dequantize)(q), "float32")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", BITS)
def test_static_bits_wrappers_match_reference(shape, dtype, bits):
    """``stochastic_quant_static`` against the reference's static
    ``stochastic_quant`` (Pallas, interpret mode) and
    ``ops.quantize_dequantize_2d`` against the reference's (its own key's
    uniforms), on the CPU (plain version, no launch counted)."""
    gj, gt = _inputs(shape, dtype, seed=100 + bits)
    key = jax.random.PRNGKey(bits)
    u = _uniforms(key, shape)
    a = jnp.abs(gj.astype(jnp.float32))
    lo, hi = jnp.min(a), jnp.max(a)
    before = dict(LAUNCHES)
    got = stochastic_quant_static(gt, u, float(lo), float(hi), bits)
    assert got.dtype == gt.dtype and got.shape == gt.shape
    _within_one_ulp(got, ref_static(gj, jnp.asarray(u.numpy()), lo, hi,
                                    bits), dtype)
    got2 = ops.quantize_dequantize_2d(gt, bits, rand=u)
    assert torch.equal(got2, got)     # the same range, levels, uniforms
    _within_one_ulp(got2, rops.quantize_dequantize_2d(gj, bits, key), dtype)
    assert LAUNCHES == before


def test_static_bits_level_counts_follow_the_reference():
    """The static kernel wrapper uses 2^bits - 1 levels, ops the clamped
    max(round(2^bits) - 1, 1): they part at bits 0, where ops keeps one
    level and the wrapper's 0 levels give an infinite scale and NaN
    outputs, on both sides alike."""
    gj, gt = _inputs((128, 128), "float32", seed=3)
    key = jax.random.PRNGKey(0)
    u = _uniforms(key, (128, 128))
    got = ops.quantize_dequantize_2d(gt, 0, rand=u)
    _within_one_ulp(got, rops.quantize_dequantize_2d(gj, 0, key), "float32")
    a = gt.abs()
    assert torch.equal(got, ops.quantize_dequantize_2d(gt, 1, rand=u))
    static0 = stochastic_quant_static(gt, u, float(a.min()), float(a.max()),
                                      0)
    ref0 = ref_static(gj, jnp.asarray(u.numpy()), jnp.min(jnp.abs(gj)),
                      jnp.max(jnp.abs(gj)), 0)
    assert bool(torch.isnan(static0).all())
    np.testing.assert_array_equal(static0.numpy(), np.asarray(ref0))


def test_static_bits_draws_from_a_generator():
    g = torch.randn(64, 96)
    gen = torch.Generator()
    gen.manual_seed(5)
    out = ops.quantize_dequantize_2d(g, 4, generator=gen)
    gen.manual_seed(5)
    u = torch.rand((1, 64 * 96), generator=gen)
    assert torch.equal(out, ops.quantize_dequantize_2d(
        g, 4, rand=u.reshape(64, 96)))
    with pytest.raises(ValueError):
        ops.quantize_dequantize_2d(torch.randn(4, 4, 4), 4,
                                   rand=torch.rand(4, 4, 4))
    with pytest.raises(ValueError):
        stochastic_quant_static(torch.randn(16), torch.rand(16), 0.0, 1.0, 4)


@pytest.mark.parametrize("shape", [(), (7,), (256,), (4, 4), (256, 256),
                                   (512, 768), (300, 256), (256, 300),
                                   (2, 128, 256), (3, 100, 256), (0, 256),
                                   (256, 0), (1024, 1024), (12, 64, 64)])
def test_kernel_quant_compatible_matches_reference(shape):
    for block in ((256, 256), (128, 64)):
        assert ops.kernel_quant_compatible(shape, block) \
            == rops.kernel_quant_compatible(shape, block), (shape, block)


@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_levels_and_scales_match_reference(dtype):
    gj, gt = _inputs((64, 96), dtype, seed=7)
    key = jax.random.PRNGKey(5)
    lv, sc = rq.quantize_int8(gj, key)
    lt, st = tq.quantize_int8(gt, _uniforms(key, (64, 96)))
    assert lt.dtype == torch.int8 and st.dtype == torch.float32
    assert st.shape == ()
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lv))
    assert float(st) == float(sc)
    assert int(lt.abs().max()) <= 127
    for out_dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                           (torch.float32, jnp.float32)):
        got = tq.dequantize_int8(lt, st, out_dtype)
        assert got.dtype == out_dtype
        np.testing.assert_array_equal(_f32(got),
                                      _f32(rq.dequantize_int8(lv, sc, jdt)))
    assert tq.dequantize_int8(lt, st).dtype == torch.bfloat16
    # the per-client form: each row bitwise its client alone
    g2 = torch.stack([gt, 3.0 * gt, torch.zeros_like(gt)])
    r2 = torch.rand(g2.shape, generator=torch.Generator().manual_seed(1))
    lc, scs = tq.quantize_int8_clients(g2, r2)
    for c in range(3):
        l1, s1 = tq.quantize_int8(g2[c], r2[c])
        assert torch.equal(lc[c], l1) and torch.equal(scs[c], s1)
    assert float(scs[2]) == np.float32(1e-30)      # an all-zero client


def test_int8_pytree_matches_reference():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((8, 8)).astype(np.float32),
            "b": rng.standard_normal((4,)).astype(np.float32),
            "c": rng.standard_normal((3, 5, 7)).astype(np.float32)}
    key = jax.random.PRNGKey(3)
    levels, scales = rq.quantize_int8_pytree(
        {k: jnp.asarray(v) for k, v in tree.items()}, key)
    keys = jax.random.split(key, len(tree))
    rands = [_uniforms(k, v.shape) for k, v in zip(keys, tree.values())]
    lt, st = tq.quantize_int8_pytree(
        {k: torch.from_numpy(v) for k, v in tree.items()}, rands)
    assert list(lt) == list(st) == list(tree)
    for k in tree:
        assert lt[k].dtype == torch.int8 and st[k].shape == ()
        np.testing.assert_array_equal(lt[k].numpy(), np.asarray(levels[k]))
        assert float(st[k]) == float(scales[k])


def test_int8_roundtrip_bounded():
    """The twin of tests/test_perf_variants.py's round-trip bound."""
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(4096, generator=gen)
    lv, sc = tq.quantize_int8(g, torch.rand(4096, generator=gen))
    assert lv.dtype == torch.int8
    back = tq.dequantize_int8(lv, sc, dtype=torch.float32)
    assert float((back - g).abs().max()) <= float(sc) * 1.001


def test_int8_unbiased():
    """The twin of tests/test_perf_variants.py's unbiasedness test."""
    gen = torch.Generator().manual_seed(2)
    g = torch.randn(512, generator=gen)
    reps = []
    for _ in range(300):
        lv, sc = tq.quantize_int8(g, torch.rand(512, generator=gen))
        reps.append(tq.dequantize_int8(lv, sc, torch.float32))
    bias = (torch.stack(reps).mean(0) - g).abs()
    scale = float(g.abs().max()) / 127.0
    assert float(bias.mean()) < scale * 0.15
