"""The stochastic quantizer's plain version against the reference's Pallas
kernel (interpret mode) and jnp oracle, and the CUDA kernel against the
plain version on the card.

CPU tests use the shapes, dtypes and bits of tests/test_kernels.py with
the same ``rand``, and its tolerance: a < 1e-3 fraction of elements may
flip by one quantization step at a level boundary, nothing more. What is
seen is agreement to one ulp: XLA's CPU backend fuses lo + level * scale
into one FMA, while the plain version (and the CUDA kernel, which is held
to it exactly) rounds the product first. The ``gpu`` test decides inside
itself whether a card is present. The machine with the card has no jax,
so this file
imports the reference only where jax is installed, and the reference
tests skip elsewhere.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import stochastic_quant_ref
from repro_torch.kernels.stochastic_quant import LAUNCHES, stochastic_quant

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.stochastic_quant import stochastic_quant_dyn
except ImportError:          # the GPU host: only the gpu test runs there
    jax = None

SHAPES = [(128, 128), (256, 512), (384, 256)]
DTYPES = ["float32", "bfloat16"]
BITS = [2, 4, 8]


def _needs_jax():
    if jax is None:
        pytest.skip("the JAX reference is not installed here")


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape).astype(np.float32)
    rand = rng.random(shape, dtype=np.float32)
    return g, rand, dtype


def _port(g, rand, dtype, bits):
    gt = torch.from_numpy(g).to(getattr(torch, dtype))
    a = gt.to(torch.float32).abs()
    rng = torch.tensor([[float(a.min()), float(a.max()), 2.0 ** bits - 1]],
                       dtype=torch.float32)
    out = stochastic_quant_ref(gt.reshape(1, -1), torch.from_numpy(rand)
                               .reshape(1, -1), rng)
    return out.reshape(g.shape).to(torch.float32).numpy(), rng


def _assert_within_one_step(out, ref, step):
    diff = np.abs(out - ref)
    assert np.mean(diff > 1e-6) < 1e-3
    assert diff.max() <= step * 1.001


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", BITS)
def test_plain_matches_pallas_kernel(shape, dtype, bits):
    _needs_jax()
    g, rand, dtype = _inputs(shape, dtype)
    out, rng = _port(g, rand, dtype, bits)
    gj = jnp.asarray(g).astype(getattr(jnp, dtype))
    a = jnp.abs(gj.astype(jnp.float32))
    lo, hi = jnp.min(a), jnp.max(a)
    out_k = np.asarray(stochastic_quant_dyn(
        gj, jnp.asarray(rand), lo, hi, jnp.float32(2 ** bits - 1),
        block=(128, 128), interpret=True), np.float32)
    assert float(rng[0, 0]) == float(lo) and float(rng[0, 1]) == float(hi)
    _assert_within_one_step(out, out_k, (float(hi) - float(lo))
                            / (2 ** bits - 1))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", BITS)
def test_plain_matches_jnp_oracle(shape, dtype, bits):
    _needs_jax()
    g, rand, dtype = _inputs(shape, dtype, seed=1)
    out, _ = _port(g, rand, dtype, bits)
    gj = jnp.asarray(g).astype(getattr(jnp, dtype))
    a = jnp.abs(gj.astype(jnp.float32))
    out_r = np.asarray(jref.stochastic_quant_ref(
        gj, jnp.asarray(rand), jnp.min(a), jnp.max(a), bits), np.float32)
    _assert_within_one_step(out, out_r, (float(jnp.max(a))
                                         - float(jnp.min(a)))
                            / (2 ** bits - 1))


def test_plain_edge_cases():
    """Per-client ranges, -0.0 -> +lo (sign test g >= 0), a constant row
    (hi == lo: scale 1), and clipping at n_levels."""
    g = torch.tensor([[-0.0, 0.5, 1.0, -1.0],
                      [2.0, 2.0, -2.0, 2.0],
                      [2.5, -3.0, 0.25, 1.0]])
    rand = torch.tensor([[0.0, 0.0, 0.0, 0.5],
                         [0.0, 0.5, 0.9, 0.1],
                         [0.0, 0.0, 0.0, 0.0]])
    rng = torch.tensor([[0.0, 1.0, 3.0], [2.0, 2.0, 1.0], [0.0, 1.0, 1.0]])
    out = stochastic_quant_ref(g, rand, rng)
    assert torch.equal(out[0], torch.tensor([0.0, 2.0 / 3.0, 1.0, -1.0]))
    assert not torch.signbit(out[0, 0])
    assert torch.equal(out[1], torch.tensor([2.0, 2.0, -2.0, 2.0]))
    assert torch.equal(out[2], torch.tensor([1.0, -1.0, 1.0, 1.0]))


def test_wrapper_checks_and_cpu_route():
    g = torch.randn(3, 10)
    rand = torch.rand(3, 10)
    rng = torch.tensor([[0.0, 3.0, 3.0]] * 3)
    before = LAUNCHES["stochastic_quant"]
    assert torch.equal(stochastic_quant(g, rand, rng),
                       stochastic_quant_ref(g, rand, rng))
    assert LAUNCHES["stochastic_quant"] == before   # CPU: no kernel launch
    with pytest.raises(ValueError):
        stochastic_quant(g.reshape(30), rand.reshape(30), rng)
    with pytest.raises(TypeError):
        stochastic_quant(g.to(torch.float64), rand, rng)
    with pytest.raises(ValueError):
        stochastic_quant(g, rand[:, :5], rng)


def test_ops_level_counts_and_ranges():
    bits = torch.tensor([0.0, 1.0, 4.0, 8.0])
    assert torch.equal(ops.level_counts(bits),
                       torch.tensor([1.0, 1.0, 15.0, 255.0]))
    g = torch.randn(4, 64)
    rand = torch.rand(4, 64)
    out = ops.quantize_dequantize_2d_dyn(g, bits.clamp(min=1.0), rand=rand)
    a = g.abs()
    rng = torch.stack([a.amin(1), a.amax(1), ops.level_counts(
        bits.clamp(min=1.0))], 1)
    assert torch.equal(out, stochastic_quant_ref(g, rand, rng))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = [(30, 1), (30, 10), (30, 4097), (30, 2359296), (7, 12345)]
    for c, n in shapes:
        g = torch.randn(c, n, generator=gen, device="cuda").to(
            getattr(torch, dtype))
        rand = torch.rand(c, n, generator=gen, device="cuda")
        bits = torch.tensor([1.0, 2.0, 4.0, 8.0], device="cuda").repeat(
            c // 4 + 1)[:c]
        a = g.to(torch.float32).abs()
        rng = torch.stack([a.amin(1), a.amax(1), ops.level_counts(bits)], 1)
        before = LAUNCHES["stochastic_quant"]
        out = stochastic_quant(g, rand, rng)
        torch.cuda.synchronize()
        assert LAUNCHES["stochastic_quant"] == before + 1
        ref = stochastic_quant_ref(g, rand, rng)
        diff = (out.to(torch.float32) - ref.to(torch.float32)).abs()
        if dtype == "float32":
            assert float(diff.max()) == 0.0, (c, n)
        else:
            step = ((rng[:, 1] - rng[:, 0]) / rng[:, 2]).max()
            assert float((diff > 0).float().mean()) < 1e-3, (c, n)
            assert float(diff.max()) <= float(step) * 1.01 + 1e-2, (c, n)
    # an unaligned view still goes through the kernel, not a fallback
    g = torch.randn(3, 101, device="cuda")[:, 1:].contiguous()
    rand = torch.rand(3, 100, device="cuda")
    rng = torch.tensor([[0.0, 3.0, 7.0]] * 3, device="cuda")
    assert torch.equal(stochastic_quant(g, rand, rng),
                       stochastic_quant_ref(g, rand, rng))
    with pytest.raises(ValueError):
        stochastic_quant(g.t(), rand.t(), rng[:1].expand(100, 3))
