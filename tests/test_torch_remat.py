"""Rematerialization (``build_model(cfg, remat=True)``, the default, as
the reference's): each layer's training body runs under
``models.common.remat``, which keeps only the layer's inputs and
recomputes the body in the backward pass through ``torch.func.vjp``.

For each family that wraps its layers (dense, MoE, MLA and VLM decoders,
RWKV6, the Mamba2 hybrid, the encoder-decoder) at ``reduce_for_smoke``
widths in float32: ``remat=True`` against ``remat=False`` under the
step's ``vmap(grad_and_value)`` over two clients. Found on the CPU:
the losses are bitwise equal; the gradients differ by float32 rounding
(at most 1.2e-6 absolute here), because the recomputed body's
vector-Jacobian product runs without a graph (no ``create_graph``) and
sums some products in another order; they are held to 1e-5 relative
plus 2e-6 absolute (whisper's encoder leaves, computed in bfloat16, to
one bfloat16 step: measured 2.4e-4 on ``embed.pos``). Then the remat'd
port against the reference built with ``remat=True``
(``jax.checkpoint``), weights carried as numpy, at the bounds of
tests/torch_parity.py.
"""
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.models.registry import build_model, make_train_batch

FAMILIES = ["granite-8b", "olmoe-1b-7b", "deepseek-v2-lite-16b",
            "phi-3-vision-4.2b", "rwkv6-7b", "zamba2-2.7b",
            "whisper-medium"]


def test_remat_is_the_default():
    cfg = reduce_for_smoke(get_arch("granite-8b"))
    assert build_model(cfg).remat is True
    assert build_model(cfg, remat=False).remat is False


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_equals_no_remat_under_vmap_grad(name):
    cfg = reduce_for_smoke(get_arch(name))
    gen = torch.Generator().manual_seed(0)
    on, off = build_model(cfg, remat=True), build_model(cfg, remat=False)
    params = {k: v.float() for k, v in on.init(gen).items()}
    stacked = {k: torch.stack([v, v * 0.9]) for k, v in params.items()}
    batch = make_train_batch(cfg, 4, 16, gen)
    batch = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in batch.items()}
    g_on, l_on = vmap(grad_and_value(on.loss))(stacked, batch)
    g_off, l_off = vmap(grad_and_value(off.loss))(stacked, batch)
    assert torch.equal(l_on, l_off)
    assert list(g_on) == list(g_off)
    for k in g_on:
        if cfg.family == "encdec" and k.startswith(
                ("encoder.", "enc_final_norm.", "embed.pos")):
            # whisper's encoder computes in bfloat16 whatever the
            # weights' dtype (its frames are bfloat16, as the
            # reference's): these leaves carry bfloat16 rounding, held
            # to one bfloat16 step at the gradients' scale (~0.7)
            torch.testing.assert_close(g_on[k], g_off[k], rtol=2e-2,
                                       atol=3e-3, msg=k)
        else:
            torch.testing.assert_close(g_on[k], g_off[k], rtol=1e-5,
                                       atol=2e-6, msg=k)


def test_remat_keeps_less_alive():
    """The point of remat: the activations of the layers are not held
    through the backward pass (peak live bytes from the op counter)."""
    from repro_torch.launch.op_analysis import analyze_ops
    cfg = reduce_for_smoke(get_arch("granite-8b")).replace(n_layers=6)
    gen = torch.Generator().manual_seed(0)
    peaks = {}
    for remat in (False, True):
        model = build_model(cfg, remat=remat)
        params = {k: torch.empty(v.shape, device="meta")
                  for k, v in model.param_specs().items()}
        batch = {k: v.to("meta") for k, v in
                 make_train_batch(cfg, 8, 128, gen).items()}
        counts, _ = analyze_ops(grad_and_value(model.loss), params, batch)
        peaks[remat] = counts["peak_bytes"]
    assert peaks[True] < 0.6 * peaks[False], peaks


# --------------------------------------------------------------------------- #
# against the reference's jax.checkpoint
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-2.7b",
                                  "whisper-medium"])
def test_remat_against_the_reference(name):
    pytest.importorskip("jax")
    import torch_parity as tp
    from repro.models import build_model as ref_build_model
    pair = tp.FamilyPair(name)
    pair.ref_model = ref_build_model(pair.ref_cfg, remat=True)
    assert pair.model.remat and pair.ref_model.remat
    tp.check_forward_loss_and_gradients(pair)


def test_remat_decoder_against_the_reference():
    """The dense decoder (its stacked layers under remat on both sides):
    loss and every gradient leaf at the float32 bounds."""
    jax = pytest.importorskip("jax")
    import torch_parity as tp
    from repro.models import build_model as ref_build_model
    from repro_torch.models import params_from_numpy
    pair = tp.FamilyPair("granite-8b")
    pair.ref_model = ref_build_model(pair.ref_cfg, remat=True)
    rb, tb = pair.batches(tp.FS)
    rl, rg = jax.jit(jax.value_and_grad(pair.ref_model.loss))(
        pair.ref_params, rb)
    tg, tl = grad_and_value(pair.model.loss)(pair.params, tb)
    assert abs(float(tl) - float(rl)) <= tp.LOSS_TOL * abs(float(rl))
    ref_grads = params_from_numpy(jax.tree_util.tree_map(tp.as_np, rg))
    assert list(tg) == list(ref_grads)
    for k, g in tg.items():
        assert tp.rel(tp.as_np(g), ref_grads[k].numpy()) <= tp.TOL, k
