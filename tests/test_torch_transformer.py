"""The port's dense decoder LM against the reference's ``DecoderLM``.

granite-8b at ``reduce_for_smoke`` widths (2 layers, d_model 256, 4
heads, d_ff 512, vocab 512) on the same weights (made by the port,
carried as numpy) and the same tokens. Tolerances, as relative norm
errors ||port - ref|| / ||ref||:

* float32 parameters: loss rel 1e-6, logits and every gradient leaf rel
  1e-5 (seen: up to 2e-6; matmul sums and XLA's pow/sin/cos differ in
  the last bits);
* bfloat16 parameters: loss rel 1e-3, logits rel 2e-2, every gradient
  leaf rel 3e-2. bf16 rounds at other places in the two frameworks (XLA
  keeps fused elementwise chains in float32); each side's bf16 gradients
  lie ~1.7% from its own float32 gradients, and the two sides ~1.5% from
  each other. So every leaf is also held to the noise itself: the port's
  bf16 gradient may lie no farther from the reference's float32 gradient
  than 1.25 times the reference's own bf16 gradient does.
"""
import numpy as np
import pytest
import torch

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.models import build_model as ref_build_model
from repro.models.common import param_count_tree as ref_param_count
from repro_torch.configs import get_arch
from repro_torch.models import DecoderLM, build_model, params_from_numpy
from repro_torch.models.common import param_count_tree

from torch_parity import as_jax, lm_arch, lm_weights

B, S = 2, 64


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def results():
    """Loss, logits and gradients of both sides, float32 and bfloat16."""
    ref_cfg, cfg = lm_arch()
    tree = lm_weights(seed=0)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    rb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens).long(),
          "labels": torch.from_numpy(tokens).long()}
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    ref_vg = jax.jit(jax.value_and_grad(ref_model.loss))
    ref_fwd = jax.jit(lambda p, b: ref_model.forward(p, b)[0])
    out = {}
    for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                           ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        rp = as_jax(tree, jdt)
        rl, rg = ref_vg(rp, rb)
        rlog = ref_fwd(rp, rb)
        params = {k: v.to(tdt) for k, v in params_from_numpy(tree).items()}
        tg, tl = torch.func.grad_and_value(model.loss)(params, tb)
        tlog, taux = model.forward(params, tb)
        assert float(taux) == 0.0             # the dense family's aux loss
        rg = params_from_numpy(jax.tree_util.tree_map(np.asarray, rg))
        out[name] = dict(
            ref_loss=float(rl), loss=float(tl),
            ref_logits=np.asarray(rlog.astype(jnp.float32)),
            logits=tlog.float().numpy(),
            ref_grads={k: v.float().numpy() for k, v in rg.items()},
            grads={k: v.float().numpy() for k, v in tg.items()},
            dtypes={k: v.dtype for k, v in tg.items()})
    return out


def test_structure_matches_reference():
    """Leaf names, order and shapes of the reference's tree; the
    parameter count at smoke widths and at granite-8b's published widths
    cut to 2 layers (838,881,280, norms included)."""
    from repro.configs import get_arch as ref_get_arch
    ref_cfg, cfg = lm_arch()
    specs = DecoderLM(cfg).param_specs()
    ref_specs = ref_build_model(ref_cfg).param_specs()
    ref_flat = params_from_numpy(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), ref_specs,
        is_leaf=lambda x: hasattr(x, "axes")))
    assert list(specs) == list(ref_flat)
    for k, s in specs.items():
        assert s.shape == tuple(ref_flat[k].shape), k
        assert s.dtype == torch.bfloat16
    full = DecoderLM(get_arch("granite-8b").replace(n_layers=2))
    ref_full = ref_build_model(ref_get_arch("granite-8b").replace(n_layers=2))
    assert param_count_tree(full.param_specs()) == 838_881_280 == \
        ref_param_count(ref_full.param_specs())
    assert len(specs) == 12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_reference(results, dtype):
    r = results[dtype]
    loss_tol, logit_tol = ((1e-6, 1e-5) if dtype == "float32"
                           else (1e-3, 2e-2))
    assert np.isfinite(r["loss"])
    assert abs(r["loss"] - r["ref_loss"]) <= loss_tol * abs(r["ref_loss"])
    assert r["logits"].shape == (B, S, 512)
    assert _rel(r["logits"], r["ref_logits"]) <= logit_tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_reference(results, dtype):
    r = results[dtype]
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert list(r["grads"]) == list(r["ref_grads"])
    for k, g in r["grads"].items():
        assert r["dtypes"][k] == getattr(torch, dtype), k
        assert _rel(g, r["ref_grads"][k]) <= tol, k
        if dtype == "bfloat16":
            ref_f32 = results["float32"]["ref_grads"][k]
            noise = _rel(r["ref_grads"][k], ref_f32)
            assert _rel(g, ref_f32) <= 1.25 * noise, k


def test_rope_tables_and_norm_match_reference():
    """The float32 rope tables at theta 1e7 and RMSNorm's float32 path."""
    from repro.models import common as ref_common
    from repro_torch.models import common
    cos, sin = common.rope_tables(128, 128, 1e7)
    rcos, rsin = ref_common.rope_tables(128, 128, 1e7)
    assert cos.dtype == torch.float32
    np.testing.assert_allclose(cos.numpy(), np.asarray(rcos), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(rsin), rtol=0,
                               atol=2e-6)
    x = np.random.default_rng(1).standard_normal((3, 5, 64)).astype(
        np.float32)
    gamma = np.linspace(0.5, 1.5, 64).astype(np.float32)
    out = common.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma))
    ref = ref_common.rms_norm(jnp.asarray(x), jnp.asarray(gamma))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_long_sequences_and_other_families_raise():
    """Above CHUNKED_ATTN_THRESHOLD tokens attention runs in query chunks
    of gcd(sq, Q_CHUNK); a length whose chunks would be under 16 tokens
    raises (the reference asserts). The families the port does not build
    raise."""
    from repro_torch.models.layers import CHUNKED_ATTN_THRESHOLD, attend
    cfg = lm_arch()[1]
    q = torch.zeros(1, CHUNKED_ATTN_THRESHOLD + 1, 4, 8)
    k = torch.zeros(1, CHUNKED_ATTN_THRESHOLD + 1, 4, 8)
    with pytest.raises(ValueError, match="at least 16"):
        attend(cfg, q, k, k, causal=True)
    with pytest.raises(NotImplementedError):
        build_model(get_arch("granite-8b").replace(family="ssm"))
