"""The block-prune kernels' plain versions against the reference's Pallas
kernels (interpret mode) and jnp oracles, the port's ``prune_pytree``
against the reference's, and the CUDA kernels against the plain versions
on the card.

Tolerances:
* tile norms: the port sums the squares in float64 and rounds once (as
  its kernel does), the reference in float32 in XLA's order; they agree
  to the reference test's tolerance (tests/test_kernels.py): rel 1e-5 in
  float32, 2e-2 in bfloat16 (what that test allows bfloat16 inputs);
* masking and masks: bitwise, sign of zero included (compared as
  integers);
* on the card: the kernels against the plain versions bitwise (the
  norms' float64 sums differ only in order, ~1e-16 relative, far inside
  one float32 rounding).

The ``gpu`` test decides inside itself whether a card is present; the
machine with the card has no jax, so the reference tests skip there.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.pruning import (
    block_importance,
    element_masks,
    gate_pytree,
    prune_pytree,
    tileable,
)
from repro_torch.kernels import ops
from repro_torch.kernels.block_prune import (
    LAUNCHES,
    apply_block_mask,
    block_norms,
)
from repro_torch.kernels.ref import apply_block_mask_ref, block_norms_ref

try:
    import jax
    import jax.numpy as jnp

    from repro.core.pruning import prune_pytree as ref_prune_pytree
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.block_prune import apply_block_mask as ref_apply
    from repro.kernels.block_prune import block_norms as ref_norms
except ImportError:          # the GPU host: only the gpu test runs there
    jax = None

SHAPES = [(128, 128), (256, 512), (384, 256)]        # tests/test_kernels.py
DTYPES = ["float32", "bfloat16"]
BLOCKS = [(32, 32), (64, 64), (128, 128), (32, 64)]


def _needs_jax():
    if jax is None:
        pytest.skip("the JAX reference is not installed here")


def _bits(x):
    """A float tensor as its integer bit pattern (sign of zero kept)."""
    x = torch.as_tensor(x)
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def _weights(shape, dtype, seed, zeros=False):
    """Normal weights in ``dtype`` (as float32 numpy, exact), with some
    exact +0 and -0 entries when ``zeros``."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    if zeros:
        w.reshape(-1)[::7] = 0.0
        w.reshape(-1)[::11] = -0.0
    t = torch.from_numpy(w).to(getattr(torch, dtype))
    return t, jnp.asarray(w).astype(getattr(jnp, dtype)) if jax else None


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", BLOCKS)
def test_block_norms_plain_matches_reference(shape, dtype, block):
    _needs_jax()
    w, wj = _weights(shape, dtype, seed=2)
    out = block_norms(w, block)                 # CPU: the plain version
    assert out.dtype == torch.float32
    assert tuple(out.shape) == (shape[0] // block[0], shape[1] // block[1])
    rtol = 2e-2 if dtype == "bfloat16" else 1e-5
    out_k = np.asarray(ref_norms(wj, block=block, interpret=True))
    out_r = np.asarray(jref.block_norms_ref(wj, *block))
    np.testing.assert_allclose(out.numpy(), out_k, rtol=rtol)
    np.testing.assert_allclose(out.numpy(), out_r, rtol=rtol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", [(32, 32), (32, 64)])
def test_apply_block_mask_plain_matches_reference_bitwise(shape, dtype,
                                                          block):
    _needs_jax()
    w, wj = _weights(shape, dtype, seed=3, zeros=True)
    tiles = (shape[0] // block[0], shape[1] // block[1])
    mask = np.random.default_rng(4).random(tiles) > 0.5
    out = apply_block_mask(w, torch.from_numpy(mask), block)
    out_k = ref_apply(wj, jnp.asarray(mask), block=block, interpret=True)
    out_r = jref.apply_block_mask_ref(wj, jnp.asarray(mask), *block)
    for ref in (out_k, out_r):
        ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(
            w.dtype)
        assert torch.equal(_bits(out), _bits(ref))
    # -x * 0 is -0: masked tiles keep the sign of their entries
    dead = ~torch.from_numpy(mask).repeat_interleave(block[0], 0) \
        .repeat_interleave(block[1], 1)
    assert torch.equal(torch.signbit(out[dead]), torch.signbit(w[dead]))
    assert bool((out[dead] == 0).all())


def test_apply_block_mask_per_client():
    """One shared w with C masks, and C stacked matrices with C masks,
    against the reference's kernel client by client."""
    _needs_jax()
    c, block = 3, (32, 32)
    w, wj = _weights((64, 96), "bfloat16", seed=5, zeros=True)
    g, gj = _weights((c, 64, 96), "bfloat16", seed=6, zeros=True)
    mask = np.random.default_rng(7).random((c, 2, 3)) > 0.4
    shared = apply_block_mask(w, torch.from_numpy(mask), block)
    stacked = apply_block_mask(g, torch.from_numpy(mask), block)
    assert tuple(shared.shape) == tuple(stacked.shape) == (c, 64, 96)
    for i in range(c):
        m = jnp.asarray(mask[i])
        for out, x in ((shared[i], wj), (stacked[i], gj[i])):
            ref = ref_apply(x, m, block=block, interpret=True)
            ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
            assert torch.equal(_bits(out), _bits(ref.to(torch.bfloat16)))


def _ref_tree():
    """tests/test_round_engine.py's tree (2-D and stacked 3-D tileable
    leaves, an odd leaf, a 1-D leaf) plus a stacked (L, d) norm scale."""
    rng = np.random.default_rng(8)
    shapes = {"w2d": (16, 24), "w3d": (2, 16, 8), "odd": (5, 7),
              "b": (16,), "ln": (2, 16)}
    tree = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    tree["w2d"][:8, :8] = 0.25           # a tie: equal tiles rank by place
    tree["w2d"][8:, 8:16] = -0.25
    return tree


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prune_pytree_matches_reference_bitwise(use_kernels):
    """Pruned weights and masks equal jax.vmap of the reference's
    prune_pytree over a (C,) rho, through its jnp path and its kernel
    path; the (L, d) norm scale is magnitude-pruned, not exempt."""
    _needs_jax()
    tree = _ref_tree()
    block = 8
    rho = np.array([0.0, 0.25, 0.5, 0.8], np.float32)
    rp, rm = jax.jit(jax.vmap(
        lambda r: ref_prune_pytree({k: jnp.asarray(v)
                                    for k, v in tree.items()},
                                   r, block=block, use_kernels=use_kernels)
    ))(jnp.asarray(rho))
    w = {k: torch.from_numpy(v) for k, v in tree.items()}
    pt, mt = prune_pytree(w, torch.from_numpy(rho), block=block)
    em = element_masks(w, mt, block)
    for k in tree:
        shape = (len(rho),) + tree[k].shape
        got_p = pt[k].expand(shape) if pt[k].dim() == 1 else pt[k]
        got_m = em[k].expand(shape) if em[k].dim() == 1 else em[k]
        ref_p = torch.from_numpy(np.array(rp[k]))
        np.testing.assert_array_equal(got_p.numpy(), ref_p.numpy(),
                                      err_msg=k)
        if tileable(w[k], block):
            # block leaves bitwise, -0 included; on the magnitude route
            # XLA rewrites the reference's w * mask into a select, which
            # gives +0 where the product (the port's) gives -0
            assert torch.equal(_bits(got_p), _bits(ref_p)), k
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(rm[k]),
                                      err_msg=k)
    # tile masks for tileable leaves, element masks for the rest
    assert tuple(mt["w2d"].shape) == (4, 2, 3)
    assert tuple(mt["w3d"].shape) == (4, 2, 2, 1)
    assert tuple(mt["ln"].shape) == (4, 2, 16)
    assert not tileable(w["ln"], block) and tileable(w["w3d"], block)
    n_ln = tree["ln"].size
    for i, r in enumerate(rho):
        assert int((~mt["ln"][i]).sum()) == int(np.floor(r * np.float32(
            n_ln)))
    assert bool(mt["b"].all()) and torch.equal(pt["b"], w["b"])


def test_block_prune_2d_matches_reference_ops():
    """ops.block_prune_2d with a (C,) rho against the reference's
    ops.block_prune_2d (Pallas, interpret) client by client."""
    _needs_jax()
    w, wj = _weights((96, 64), "float32", seed=9)
    rho = np.array([0.1, 0.3, 0.6], np.float32)
    pruned, mask = ops.block_prune_2d(w, torch.from_numpy(rho), (16, 32))
    assert tuple(pruned.shape) == (3, 96, 64) and mask.dtype == torch.bool
    for i, r in enumerate(rho):
        rp, rmask = jops.block_prune_2d(wj, jnp.float32(r), block=(16, 32))
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(rmask))
        assert torch.equal(_bits(pruned[i]), _bits(torch.from_numpy(
            np.array(rp))))


def test_gate_is_the_element_mask_product():
    """Gating stacked gradients with tile masks (the masking kernel) is
    bitwise the reference's g * element_mask, -0 included; element and
    exempt masks multiply."""
    tree = _ref_tree()
    w = {k: torch.from_numpy(v) for k, v in tree.items()}
    rho = torch.tensor([0.25, 0.5, 0.75])
    _, masks = prune_pytree(w, rho, block=8)
    rng = np.random.default_rng(10)
    grads = {k: torch.from_numpy(rng.standard_normal((3,) + v.shape)
                                 .astype(np.float32)).to(torch.bfloat16)
             for k, v in tree.items()}
    grads["w2d"][0, 0, 0] = -0.0
    before = dict(LAUNCHES)
    gated = gate_pytree(grads, masks, 8)
    assert LAUNCHES == before                  # CPU: no kernel launch
    em = element_masks(w, masks, 8)
    for k, g in grads.items():
        assert torch.equal(_bits(gated[k]), _bits(g * em[k].to(g.dtype))), k


def test_block_importance_and_wrapper_checks():
    w = torch.randn(2, 64, 32)
    imp = block_importance(w, 16)
    assert tuple(imp.shape) == (2, 4, 2)
    assert torch.equal(imp.reshape(-1, 2),
                       block_norms_ref(w.reshape(128, 32), 16, 16))
    # the block is clipped to the matrix, as the reference does
    assert tuple(block_norms(torch.randn(8, 256), (128, 128)).shape) \
        == (1, 2)
    with pytest.raises(ValueError):
        block_norms(torch.randn(60, 64), (32, 32))
    with pytest.raises(TypeError):
        block_norms(torch.randn(64, 64, dtype=torch.float64), (32, 32))
    with pytest.raises(TypeError):
        apply_block_mask(torch.randn(64, 64), torch.ones(2, 2), (32, 32))
    with pytest.raises(ValueError):
        apply_block_mask(torch.randn(64, 64),
                         torch.ones(3, 2, dtype=torch.bool), (32, 32))
    with pytest.raises(ValueError):                 # stacked w, one mask
        apply_block_mask(torch.randn(2, 64, 64),
                         torch.ones(2, 2, dtype=torch.bool), (32, 32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_block_kernels_match_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = [((4096, 1024), (32, 32)), ((8192, 4096), (32, 32)),
             ((1024, 14336), (64, 64)), ((512, 512), (128, 128)),
             ((256, 384), (32, 64)),
             ((96, 36), (32, 4)),           # bf16 tile rows not 16 bytes
             ((96, 30), (32, 6)),           # no 16-byte rows at all
             ((8, 256), (128, 128))]        # block clipped to the matrix
    for shape, block in cases:
        w = torch.randn(shape, generator=gen, device="cuda").to(dt)
        w.view(-1)[::13] = -0.0
        before = dict(LAUNCHES)
        norms = block_norms(w, block)
        torch.cuda.synchronize()
        assert LAUNCHES["block_norms"] == before["block_norms"] + 1
        bm, bn = min(block[0], shape[0]), min(block[1], shape[1])
        assert torch.equal(_bits(norms), _bits(block_norms_ref(w, bm, bn))), \
            (shape, block)
        rho = torch.tensor([0.0, 0.25, 0.5, 0.9], device="cuda")
        mask = ops.rank_mask(norms, rho)
        ref_mask = ops.rank_mask(block_norms_ref(w, bm, bn), rho)
        assert torch.equal(mask, ref_mask)
        shared = apply_block_mask(w, mask, block)
        g = torch.randn((4,) + shape, generator=gen, device="cuda").to(dt)
        stacked = apply_block_mask(g, mask, block)
        torch.cuda.synchronize()
        assert LAUNCHES["apply_block_mask"] == \
            before["apply_block_mask"] + 2
        assert torch.equal(_bits(shared),
                           _bits(apply_block_mask_ref(w, mask, bm, bn)))
        assert torch.equal(_bits(stacked),
                           _bits(apply_block_mask_ref(g, mask, bm, bn)))
    with pytest.raises(ValueError):
        block_norms(torch.randn(64, 64, device="cuda").t(), (32, 32))
