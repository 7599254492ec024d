"""The block-sparse product's plain version and ``ops.pruned_matmul``
against the reference's Pallas kernel (interpret mode) and jnp oracle,
and the CUDA kernel against the plain version on the card.

Tolerances (tests/test_kernels.py's): rel and abs 1e-4 in float32, 3e-2
in bfloat16 — the sums are float32 in another order, and in bfloat16 the
result is rounded once to 8 bits of mantissa. Tile masks: bitwise.

On the card: float32 within test_kernels.py's 1e-4 (relative to the
largest result); bfloat16 within one bf16 ulp of the plain version on
all but 1e-4 of the elements (both round a float32 sum once; the sums
differ only in order, which can move a result near 0 by more than its
ulp), and within one ulp plus the float32 tolerance everywhere. A fully
masked product is exact zeros.

The ``gpu`` test decides inside itself whether a card is present; the
machine with the card has no jax, so the reference tests skip there.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.block_sparse_matmul import (
    LAUNCHES,
    block_shape,
    block_sparse_matmul,
)
from repro_torch.kernels.ref import block_sparse_matmul_ref

try:
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.block_sparse_matmul import (
        block_sparse_matmul as ref_bsmm,
    )
except ImportError:          # the GPU host: only the gpu test runs there
    jnp = None

MNK = [(128, 128, 128), (256, 256, 512), (128, 384, 256)]  # test_kernels
DTYPES = ["float32", "bfloat16"]
DENSITIES = [0.0, 0.5, 1.0]


def _needs_jax():
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")


def _tol(dtype):
    return 3e-2 if dtype == "bfloat16" else 1e-4


def _inputs(m, n, k, dtype, density, seed=0):
    """x, w ~ N(0, 1)/8 in ``dtype`` and a tile mask of the given density,
    as torch tensors and as jax arrays made from the same numpy values."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) / 8).astype(np.float32)
    w = (rng.standard_normal((k, n)) / 8).astype(np.float32)
    mask = rng.random((k // 128, n // 128)) < density
    dt = getattr(torch, dtype)
    port = (torch.from_numpy(x).to(dt), torch.from_numpy(w).to(dt),
            torch.from_numpy(mask))
    ref = None
    if jnp is not None:
        jdt = getattr(jnp, dtype)
        ref = (jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
               jnp.asarray(mask))
    return port, ref


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("mnk", MNK)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("density", DENSITIES)
def test_plain_matches_reference(mnk, dtype, density):
    _needs_jax()
    m, n, k = mnk
    (x, w, mask), (xj, wj, mj) = _inputs(m, n, k, dtype, density)
    out = block_sparse_matmul(x, w, mask)      # CPU: the plain version
    via_ops = ops.block_sparse_matmul(x, w, mask, blocks=(128, 128, 128))
    assert out.dtype == x.dtype and tuple(out.shape) == (m, n)
    assert torch.equal(out, via_ops)
    tol = _tol(dtype)
    out_k = ref_bsmm(xj, wj, mj, blocks=(128, 128, 128), interpret=True)
    out_r = jref.block_sparse_matmul_ref(xj, wj, mj, 128, 128)
    for ref in (out_k, out_r):
        np.testing.assert_allclose(_f32(out), _f32(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,blocks", [
    ((128, 256, 256), (128, 128, 128)),
    ((128, 384, 512), (128, 128, 128)),
    ((64, 256, 128), (64, 64, 32)),
])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rho", [0.0, 0.25, 0.5, 1.0])
def test_pruned_matmul_matches_reference(shape, blocks, dtype, rho):
    """Masks bitwise (the port's B2 + ranking + B3 against the
    reference's ``block_prune_2d``), products within tolerance."""
    _needs_jax()
    m, n, k = shape
    (x, w, _), (xj, wj, _) = _inputs(m, n, k, dtype, 1.0, seed=1)
    out = ops.pruned_matmul(x, w, rho, blocks=blocks)
    out_r = jops.pruned_matmul(xj, wj, rho, blocks=blocks)
    _, mask = ops.block_prune_2d(w, rho, block=(blocks[2], blocks[1]))
    _, mask_r = jops.block_prune_2d(wj, rho, block=(blocks[2], blocks[1]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_r))
    tol = _tol(dtype)
    np.testing.assert_allclose(_f32(out), _f32(out_r), rtol=tol, atol=tol)


def test_fully_masked_matmul_is_zero():
    """tests/test_kernels.py's case on the port's plain version."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((128, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32))
    y = ops.block_sparse_matmul(x, w, torch.zeros((2, 1), dtype=torch.bool))
    np.testing.assert_array_equal(y.numpy(), 0.0)


def test_plain_masks_by_multiply_as_the_reference_oracle():
    """A NaN inside a dead tile of w reaches the plain version's result
    (NaN * 0), as it reaches the reference's oracle; a nonzero integer
    mask entry counts as live."""
    _needs_jax()
    (x, w, _), (xj, _, _) = _inputs(128, 256, 256, "float32", 1.0, seed=2)
    w[3, 200] = float("nan")                     # tile (0, 1)
    mask = torch.tensor([[True, False], [True, True]])
    out = block_sparse_matmul(x, w, mask)
    ref = jref.block_sparse_matmul_ref(xj, jnp.asarray(w.numpy()),
                                       jnp.asarray(mask.numpy()), 128, 128)
    np.testing.assert_array_equal(np.isnan(out.numpy()),
                                  np.isnan(np.asarray(ref)))
    nan_cols = out.isnan().any(dim=0).nonzero().flatten().tolist()
    assert nan_cols == [200] and bool(out[:, 200].isnan().all())
    as_int = block_sparse_matmul(x, w, mask.to(torch.int32) * 2)
    assert torch.equal(as_int.isnan(), out.isnan())


def test_wrapper_checks():
    x, w = torch.zeros(128, 256), torch.zeros(256, 384)
    mask = torch.ones(2, 3, dtype=torch.bool)
    assert block_shape(8, 3, 5) == (8, 3, 5)          # blocks clamp
    assert block_sparse_matmul(torch.ones(8, 5), torch.ones(5, 3),
                               torch.ones(1, 1)).shape == (8, 3)
    with pytest.raises(ValueError, match="do not chain"):
        block_sparse_matmul(x, torch.zeros(128, 384), mask)
    with pytest.raises(ValueError, match="do not tile"):
        block_sparse_matmul(torch.zeros(200, 256), w, mask)
    with pytest.raises(ValueError, match="does not match"):
        block_sparse_matmul(x, w, torch.ones(3, 2, dtype=torch.bool))
    with pytest.raises(ValueError, match="empty"):
        block_sparse_matmul(torch.zeros(0, 256), w, mask)
    with pytest.raises(ValueError, match="need x"):
        block_sparse_matmul(x[None], w, mask)
    with pytest.raises(TypeError, match="float32 or both bfloat16"):
        block_sparse_matmul(x, w.to(torch.bfloat16), mask)
    with pytest.raises(TypeError, match="float32 or both bfloat16"):
        block_sparse_matmul(x.double(), w.double(), mask)
    with pytest.raises(ValueError, match="on meta"):
        block_sparse_matmul(x, w, mask.to("meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = [((128, 128, 128), (128, 128, 128)),
             ((256, 256, 512), (128, 128, 128)),
             ((128, 384, 256), (128, 128, 128)),
             ((1024, 4096, 4096), (128, 128, 128)),
             ((8, 3, 5), (128, 128, 128)),          # blocks clamp
             ((96, 60, 48), (32, 20, 16)),          # tiles straddle blocks
             ((200, 300, 64), (40, 30, 8))]
    for (m, n, k), blocks in cases:
        x = (torch.randn(m, k, generator=gen, device="cuda") / 8).to(dt)
        w = (torch.randn(k, n, generator=gen, device="cuda") / 8).to(dt)
        _, bn, bk = block_shape(m, n, k, blocks)
        for density in DENSITIES:
            mask = torch.rand(k // bk, n // bn, generator=gen,
                              device="cuda") < density
            before = LAUNCHES["block_sparse_matmul"]
            out = block_sparse_matmul(x, w, mask, blocks)
            ref = block_sparse_matmul_ref(x, w, mask, bk, bn)
            torch.cuda.synchronize()
            assert LAUNCHES["block_sparse_matmul"] == before + 1
            assert out.dtype == dt and tuple(out.shape) == (m, n)
            if density == 0.0:
                assert bool((out == 0).all())
            diff = (out.float() - ref.float()).abs()
            f32_tol = 1e-4 * (1 + float(ref.abs().max()))
            if dt == torch.float32:
                assert float(diff.max()) <= f32_tol, ((m, n, k), density)
            else:
                a = ref.abs()
                ulp = (torch.nextafter(a, torch.full_like(a, float("inf")))
                       .float() - a.float())
                # one ulp, except where a result near 0 has an ulp below
                # the float32 sums' own difference
                assert float((diff > ulp).float().mean()) <= 1e-4
                assert bool((diff <= ulp + f32_tol).all()), \
                    ((m, n, k), density)
    with pytest.raises(ValueError, match="contiguous"):
        block_sparse_matmul(torch.zeros(128, 128, device="cuda").t(),
                            torch.zeros(128, 128, device="cuda"),
                            torch.ones(1, 1, device="cuda"))
