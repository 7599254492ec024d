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

The kernel's path (``kernel_path``: "wgmma" on the tensor cores for
bfloat16 products whose blocks fit it, "simt" for the rest) is a pure
function of the shape, tested here on the CPU; on the card each product
must take the path the rule names, and the per-path launch counts say
which it took.

The ``gpu`` tests decide inside themselves whether a card is present;
the machine with the card has no jax, so the reference tests skip there.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import build
from repro_torch.kernels.block_sparse_matmul import (
    LAUNCHES,
    block_shape,
    block_sparse_matmul,
    kernel_path,
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


GRANITE_KN = {                       # granite-8b's projections, (K, N)
    "attn.wq": (4096, 4096), "attn.wk": (4096, 1024),
    "attn.wv": (4096, 1024), "attn.wo": (4096, 4096),
    "ffn.wi_gate": (4096, 14336), "ffn.wi_up": (4096, 14336),
    "ffn.wo": (14336, 4096), "embed.head": (4096, 49152)}


@pytest.mark.parametrize("name", sorted(GRANITE_KN))
def test_kernel_path_full_width_bf16_is_wgmma(name):
    """The 8 full-width products (x of 1024 rows, 128 x 128 blocks) and
    pruned_matmul's take the tensor-core path; their float32 twins do
    not."""
    k, n = GRANITE_KN[name]
    _, bn, bk = block_shape(1024, n, k)
    assert kernel_path(1024, n, k, bk, bn, torch.bfloat16) == "wgmma"
    assert kernel_path(1024, n, k, bk, bn, torch.float32) == "simt"


@pytest.mark.parametrize("why,args", [
    ("float32: full float32, wgmma has only TF32",
     (1024, 4096, 4096, 128, 128, torch.float32)),
    ("bk not a multiple of the 64-deep K step",
     (1024, 4096, 4096, 32, 128, torch.bfloat16)),
    ("bk between K steps", (256, 256, 192, 96, 128, torch.bfloat16)),
    ("bn not a multiple of the 128-wide tile",
     (1024, 4096, 4096, 128, 64, torch.bfloat16)),
    ("N = 3: bn clamps to 3", (8, 3, 64, 64, 3, torch.bfloat16)),
    ("N = 60: bn clamps to 60", (96, 60, 128, 64, 60, torch.bfloat16)),
    ("more mask rows than the live list holds",
     (64, 128, 64 * 4097, 64, 128, torch.bfloat16)),
])
def test_kernel_path_simt_reasons(why, args):
    assert kernel_path(*args) == "simt", why


def test_kernel_path_edges():
    """m never enters (rows past m are TMA zero fill); a misaligned x or
    w goes to simt; blocks at the limits of the rule take wgmma."""
    for m in (1, 8, 64, 200, 1024):
        assert kernel_path(m, 256, 512, 128, 128, torch.bfloat16) == "wgmma"
    assert kernel_path(64, 128, 64, 64, 128, torch.bfloat16) == "wgmma"
    assert kernel_path(64, 512, 512, 256, 256, torch.bfloat16) == "wgmma"
    assert kernel_path(64, 128, 64 * 4096, 64, 128,
                       torch.bfloat16) == "wgmma"
    assert kernel_path(1024, 4096, 4096, 128, 128, torch.bfloat16,
                       aligned=False) == "simt"
    # the reference test shapes: wgmma in bf16 at 128 x 128 blocks
    for m, n, k in MNK:
        assert kernel_path(m, n, k, 128, 128, torch.bfloat16) == "wgmma"


def test_cpu_tensors_count_no_launch():
    """A CPU tensor reaches the plain version and no path's count."""
    before = dict(LAUNCHES)
    assert set(before) == {"block_sparse_matmul",
                           "block_sparse_matmul_wgmma",
                           "block_sparse_matmul_simt"}
    x = torch.ones(64, 128, dtype=torch.bfloat16)
    block_sparse_matmul(x, torch.ones(128, 128, dtype=torch.bfloat16),
                        torch.ones(1, 1, dtype=torch.bool))
    assert LAUNCHES == before


def test_build_digest_covers_headers(tmp_path):
    """The library's name changes with the source and with any csrc/
    header, so an edited header never loads a stale library."""
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    first = build.source_digest(src)
    (tmp_path / "k.cuh").write_text("// header\n")
    second = build.source_digest(src)
    (tmp_path / "k.cuh").write_text("// header, edited\n")
    third = build.source_digest(src)
    src.write_text("// kernel, edited\n")
    assert len({first, second, third, build.source_digest(src)}) == 4
    assert build.source_digest(src) == build.source_digest(src)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False


def _check_on_card(x, w, mask, blocks, where):
    """Launch on the card, check the path the rule names was taken (the
    per-path count), and hold the result to the plain version: float32
    within 1e-4 (relative to the largest result); bfloat16 within one ulp
    on all but 1e-4 of the elements and one ulp plus that everywhere; a
    fully masked product exact zeros."""
    m, k = x.shape
    n = w.shape[1]
    _, bn, bk = block_shape(m, n, k, blocks)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    path = kernel_path(m, n, k, bk, bn, x.dtype, aligned=aligned)
    before = dict(LAUNCHES)
    out = block_sparse_matmul(x, w, mask, blocks)
    ref = block_sparse_matmul_ref(x, w, mask, bk, bn)
    torch.cuda.synchronize()
    assert LAUNCHES["block_sparse_matmul"] == \
        before["block_sparse_matmul"] + 1
    assert LAUNCHES[f"block_sparse_matmul_{path}"] == \
        before[f"block_sparse_matmul_{path}"] + 1, where
    assert out.dtype == x.dtype and tuple(out.shape) == (m, n)
    if not bool(mask.any()):
        assert bool((out == 0).all()), where
    diff = (out.float() - ref.float()).abs()
    f32_tol = 1e-4 * (1 + float(ref.abs().max()))
    if x.dtype == torch.float32:
        assert float(diff.max()) <= f32_tol, where
    else:
        a = ref.abs()
        ulp = (torch.nextafter(a, torch.full_like(a, float("inf")))
               .float() - a.float())
        # one ulp, except where a result near 0 has an ulp below the
        # float32 sums' own difference
        assert float((diff > ulp).float().mean()) <= 1e-4, where
        assert bool((diff <= ulp + f32_tol).all()), where
    return out, path


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_matches_plain(dtype):
    _needs_card()
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
            _, path = _check_on_card(x, w, mask, blocks,
                                     ((m, n, k), density))
            # bf16 at 128-multiples takes the tensor cores; f32 and the
            # odd shapes the CUDA cores
            assert path == ("wgmma" if dt == torch.bfloat16
                            and n % 128 == 0 and k % 128 == 0 else "simt")
    with pytest.raises(ValueError, match="contiguous"):
        block_sparse_matmul(torch.zeros(128, 128, device="cuda").t(),
                            torch.zeros(128, 128, device="cuda"),
                            torch.ones(1, 1, device="cuda"))


def _bf16_card(m, n, k, gen, scale=8.0):
    x = (torch.randn(m, k, generator=gen, device="cuda") / scale)
    w = (torch.randn(k, n, generator=gen, device="cuda") / scale)
    return x.to(torch.bfloat16), w.to(torch.bfloat16)


@pytest.mark.gpu
def test_wgmma_single_tile():
    """One 64 x 128 x 64 product (one K step, one wgmma tile), then one
    live tile in an otherwise dead 2 x 2 mask."""
    _needs_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    x, w = _bf16_card(64, 128, 64, gen)
    one = torch.ones(1, 1, dtype=torch.bool, device="cuda")
    _, path = _check_on_card(x, w, one, (64, 128, 64), "64 x 128 x 64")
    assert path == "wgmma"
    x, w = _bf16_card(128, 256, 256, gen)
    mask = torch.zeros(2, 2, dtype=torch.bool, device="cuda")
    mask[1, 0] = True
    out, path = _check_on_card(x, w, mask, (128, 128, 128), "one live tile")
    assert path == "wgmma"
    assert bool((out[:, 128:] == 0).all())


@pytest.mark.gpu
def test_wgmma_dead_mask_column():
    """A whole dead mask column stores exact zeros beside live columns."""
    _needs_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    x, w = _bf16_card(256, 384, 512, gen)
    mask = torch.rand(4, 3, generator=gen, device="cuda") < 0.7
    mask[:, 1] = False
    mask[0, 0] = mask[0, 2] = True
    out, path = _check_on_card(x, w, mask, (128, 128, 128), "dead column")
    assert path == "wgmma"
    assert bool((out[:, 128:256] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("m,bm", [(8, 128), (64, 128), (200, 40)])
def test_wgmma_few_rows(m, bm):
    """M below the 64-row wgmma tile (bm clamps: rows past M are TMA zero
    fill, never stored) and a ragged last tile (M = 200)."""
    _needs_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3 + m)
    x, w = _bf16_card(m, 256, 512, gen)
    out = torch.empty(0)
    for density in DENSITIES:
        mask = torch.rand(4, 2, generator=gen, device="cuda") < density
        out, path = _check_on_card(x, w, mask, (bm, 128, 128),
                                   (m, density))
        assert path == "wgmma"
    assert bool(torch.isfinite(out).all())


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(4096, 1024), (14336, 4096)])
def test_wgmma_full_width_shapes(k, n):
    """granite-8b's wk (64-row tiles: fewer 128-row tiles than SMs) and
    ffn.wo (K = 14336, 112 mask rows) at x of 1024 rows, rho 0.25."""
    _needs_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(k + n)
    x, w = _bf16_card(1024, n, k, gen)
    _, mask = ops.block_prune_2d(w, 0.25, block=(128, 128))
    _, path = _check_on_card(x, w, mask, (128, 128, 128), (k, n))
    assert path == "wgmma"


@pytest.mark.gpu
def test_misaligned_bf16_takes_simt():
    """x starting 2 bytes past a 16-byte boundary goes to simt, and
    agrees with the plain version there."""
    _needs_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    flat = (torch.randn(128 * 256 + 1, generator=gen, device="cuda") / 8
            ).to(torch.bfloat16)
    x = flat[1:].view(128, 256)
    w = (torch.randn(256, 256, generator=gen, device="cuda") / 8
         ).to(torch.bfloat16)
    mask = torch.rand(2, 2, generator=gen, device="cuda") < 0.5
    _, path = _check_on_card(x, w, mask, (128, 128, 128), "misaligned")
    assert path == "simt"
