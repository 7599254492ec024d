"""The port's decoder LM families (MoE, MLA, VLM) against the reference's
``DecoderLM``, the configuration registry and the mixed-dtype weight
carry.

olmoe-1b-7b (MoE), deepseek-v2-lite-16b (MoE with MLA and one dense
prefix layer) and phi-3-vision-4.2b (VLM, 8 image tokens) at
``reduce_for_smoke`` widths on the same float32 weights (made by the
port, carried as numpy) and the same batch: forward logits and the
auxiliary loss, the loss, and every gradient leaf at rel 1e-5 (the
float32 bounds of tests/test_torch_transformer.py; the loss at 1e-6).
At these inputs the MoE layers drop tokens (64 tokens a group, 4
experts, capacity 40), and drop the same ones on both sides.
"""
import numpy as np
import pytest
import torch

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.models import build_model as ref_build_model
from repro.models.common import param_count_tree as ref_param_count
from repro_torch import configs
from repro_torch.models import (
    DecoderLM,
    build_model,
    make_decode_inputs,
    make_train_batch,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.models.common import param_count_tree

from torch_parity import (
    arch_pair,
    as_jax_like,
    decoder_weights,
    port_params_like,
)

B, S = 2, 32
FAMILIES = ["olmoe-1b-7b", "deepseek-v2-lite-16b", "phi-3-vision-4.2b"]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flat_ref_specs(specs):
    return params_from_numpy(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), specs,
        is_leaf=lambda x: hasattr(x, "axes")))


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    name = request.param
    ref_cfg, cfg = arch_pair(name)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    tree = decoder_weights(cfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    rb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens).long(),
          "labels": torch.from_numpy(tokens).long()}
    if cfg.family == "vlm":
        img = torch.from_numpy(0.02 * rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model))).to(torch.bfloat16)
        rb["image_embeds"] = jnp.asarray(img.float().numpy(), jnp.bfloat16)
        tb["image_embeds"] = img
    rp = as_jax_like(tree, ref_model.param_specs(), jnp.float32)
    params = port_params_like(tree, model, torch.float32)
    rl, rg = jax.jit(jax.value_and_grad(ref_model.loss))(rp, rb)
    rlog, raux = jax.jit(ref_model.forward)(rp, rb)
    tg, tl = torch.func.grad_and_value(model.loss)(params, tb)
    tlog, taux = model.forward(params, tb)
    return dict(
        name=name, cfg=cfg, ref_loss=float(rl), loss=float(tl),
        ref_logits=np.asarray(rlog), logits=tlog.detach().numpy(),
        ref_aux=float(raux), aux=float(taux),
        ref_grads=params_from_numpy(jax.tree_util.tree_map(np.asarray, rg)),
        grads=tg)


def test_forward_and_loss_match_reference(family):
    cfg = family["cfg"]
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    assert family["logits"].shape == (B, n_img + S, cfg.vocab_size)
    assert _rel(family["logits"], family["ref_logits"]) <= 1e-5
    assert abs(family["loss"] - family["ref_loss"]) \
        <= 1e-6 * abs(family["ref_loss"])
    if cfg.moe is not None:
        assert family["ref_aux"] > 0
        assert abs(family["aux"] - family["ref_aux"]) \
            <= 1e-5 * family["ref_aux"]
    else:
        assert family["aux"] == 0.0


def test_gradients_match_reference(family):
    assert list(family["grads"]) == list(family["ref_grads"])
    for k, g in family["grads"].items():
        assert g.dtype == torch.float32, k
        assert _rel(g.numpy(), family["ref_grads"][k].numpy()) <= 1e-5, k


@pytest.mark.parametrize("name", FAMILIES + ["granite-8b"])
def test_structure_matches_reference(name):
    """Leaf names, order, shapes and dtypes (the router float32, the rest
    bfloat16) of the reference's tree, at smoke width."""
    ref_cfg, cfg = arch_pair(name)
    ref_specs = ref_build_model(ref_cfg).param_specs()
    specs = DecoderLM(cfg).param_specs()
    ref_flat = _flat_ref_specs(ref_specs)
    assert list(specs) == list(ref_flat)
    ref_dtypes = {k: v.dtype for k, v in params_from_numpy(
        jax.tree_util.tree_map(lambda s: np.zeros((), s.dtype), ref_specs,
                               is_leaf=lambda x: hasattr(x, "axes"))).items()}
    for k, s in specs.items():
        assert s.shape == tuple(ref_flat[k].shape), k
        assert s.dtype == ref_dtypes[k], k
    assert param_count_tree(specs) == ref_param_count(ref_specs)
    if cfg.moe is not None and cfg.moe.first_k_dense:
        assert any(k.startswith("prefix_layers.0.") for k in specs)


def test_param_counts_of_all_ten_configs_match_reference():
    assert configs.list_archs() == ref_configs.list_archs()
    assert len(configs.ARCHS) == 10
    for name in configs.list_archs() + ["granite-8b-sw4096"]:
        cfg, ref_cfg = configs.get_arch(name), ref_configs.get_arch(name)
        for active in (False, True):
            assert cfg.param_count(active) == ref_cfg.param_count(active), \
                name
    # the serving configurations at their full published widths, counted
    # from the parameter specs; granite-8b: 8,254,390,272 without the
    # norms' 299,008
    assert configs.get_arch("granite-8b").param_count() == 8_254_390_272
    for name in ("granite-8b", "olmoe-1b-7b", "deepseek-v2-lite-16b",
                 "phi-3-vision-4.2b"):
        full = ref_build_model(ref_configs.get_arch(name)).param_specs()
        assert param_count_tree(build_model(
            configs.get_arch(name)).param_specs()) == ref_param_count(full)
    assert param_count_tree(build_model(
        configs.get_arch("granite-8b")).param_specs()) == 8_254_689_280


@pytest.mark.parametrize("name,count,tree_count", [
    ("rwkv6-7b", 7_516_454_912, 7_534_415_872),
    ("zamba2-2.7b", 2_420_817_920, 2_422_670_240),
    ("whisper-medium", 810_862_592, 815_306_752)])
def test_new_families_build_at_full_width_as_the_reference(name, count,
                                                           tree_count):
    """The SSM, hybrid and encoder-decoder families build at their full
    published widths with the reference's parameter counts: the
    config's ``param_count()`` and the tree's ``param_count_tree`` (from
    the specs, no weights made; the tree also holds the norms, rwkv6's
    mixing ratios and decay LoRA, Mamba2's convolution and the learned
    positions, which ``param_count()`` leaves out); an ssm config not
    named rwkv* raises, as the reference's ``build_model`` does."""
    cfg, ref_cfg = configs.get_arch(name), ref_configs.get_arch(name)
    assert cfg.param_count() == ref_cfg.param_count() == count
    specs = build_model(cfg).param_specs()
    ref_specs = ref_build_model(ref_cfg).param_specs()
    assert param_count_tree(specs) == ref_param_count(ref_specs) \
        == tree_count
    other = cfg.replace(family="ssm", name="mamba-" + name)
    with pytest.raises(NotImplementedError, match="ssm arch"):
        build_model(other)
    with pytest.raises(NotImplementedError, match="ssm arch"):
        ref_build_model(ref_cfg.replace(family="ssm", name="mamba-" + name))


def test_mixed_dtype_trees_round_trip():
    """A reference tree with bf16 leaves, a float32 router and the
    prefix_layers list crosses to the port with each leaf's dtype and
    value, and back (bf16 leaves as float32 numpy) to the same jax tree."""
    ref_cfg, cfg = arch_pair("deepseek-v2-lite-16b")
    ref_model = ref_build_model(ref_cfg)
    ref_tree = as_jax_like(decoder_weights(cfg, seed=3),
                           ref_model.param_specs(), jnp.bfloat16)
    assert isinstance(ref_tree["prefix_layers"], list)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_tree))
    specs = DecoderLM(cfg).param_specs()
    assert list(params) == list(specs)
    for k, v in params.items():
        assert v.dtype == specs[k].dtype, k
    assert params["layers.ffn.router"].dtype == torch.float32
    back = as_jax_like(params_to_numpy(params), ref_model.param_specs(),
                       jnp.bfloat16)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(ref_tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref_tree)):
        assert a.dtype == b.dtype
        assert np.array_equal(np.asarray(a.astype(jnp.float32)),
                              np.asarray(b.astype(jnp.float32)))


def test_batches_and_decode_inputs():
    _, cfg = arch_pair("phi-3-vision-4.2b")
    gen = torch.Generator()
    gen.manual_seed(0)
    batch = make_train_batch(cfg, 3, 5, gen)
    assert batch["tokens"].shape == (3, 5)
    assert batch["image_embeds"].shape == (3, 8, cfg.d_model)
    assert batch["image_embeds"].dtype == torch.bfloat16
    model = build_model(cfg)
    dec = make_decode_inputs(model, cfg, 3, 16, gen)
    assert dec["token"].shape == (3,)
    assert dec["pos"].tolist() == [15, 15, 15]
    assert dec["cache"]["k"].shape == (cfg.n_layers, 3, 16, cfg.n_kv_heads,
                                       cfg.head_dim)
    assert dec["cache"]["k"].dtype == torch.bfloat16
    _, mcfg = arch_pair("deepseek-v2-lite-16b")
    cache = build_model(mcfg).init_cache(2, 16)
    assert list(cache) == ["ckv"]
    assert cache["ckv"].shape == (mcfg.n_layers, 2, 16, 64 + 16)
    _, wcfg = arch_pair("granite-8b-sw4096")
    assert build_model(wcfg).init_cache(2, 100)["k"].shape[2] == 64
