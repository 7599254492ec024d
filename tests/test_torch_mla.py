"""The port's multi-head latent attention (``repro_torch.models.mla``)
against the reference's (``repro.models.mla``).

deepseek-v2-lite-16b at ``reduce_for_smoke`` widths (4 heads, kv_lora
64, qk_nope 32, qk_rope 16, v 32), one layer's attention weights (made
by the port, carried as numpy) in float32, the same inputs on both
sides. Tolerances, as relative norm errors: float32 rel 1e-5 (the bound
of tests/test_torch_transformer.py). The latent cache is bfloat16, as
the reference keeps it: the prefill cache is compared to one bf16 ulp
plus 1e-5 of its largest magnitude, as in tests/test_torch_serve.py.

The absorbed decode is also held to the expanded formulation: decoding
position p against the prefill cache of positions 0..p-1 gives the
expanded attention's output at p, to the bf16 rounding of the cached
latent (rel 1e-2: the cache holds bf16 values; seen: 1.6e-3 to 2.2e-3).
"""
import functools

import numpy as np
import pytest
import torch

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")
import jax.numpy as jnp

from repro.models import build_model as ref_build_model
from repro.models import mla as ref_mla
from repro_torch.models import mla, params_from_numpy
from repro_torch.models.common import subtree

from torch_parity import (
    arch_pair,
    as_jax_like,
    assert_cache_close,
    decoder_weights,
)

B, S = 2, 24


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def _attn():
    """(ref cfg, port cfg, ref params, port params) of the first scanned
    layer's MLA weights, float32."""
    ref_cfg, cfg = arch_pair("deepseek-v2-lite-16b")
    tree = decoder_weights(cfg)
    ref_specs = ref_build_model(ref_cfg).param_specs()
    rp = as_jax_like(tree["layers"]["attn"], ref_specs["layers"]["attn"],
                     jnp.float32)
    rp = {k: v[0] for k, v in rp.items()}
    tp = {k: v[0].to(torch.float32) for k, v in
          subtree(params_from_numpy(tree), "layers.attn.").items()}
    return ref_cfg, cfg, rp, tp


def _x(cfg, shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def test_specs_match_reference():
    ref_cfg, cfg, rp, tp = _attn()
    specs = mla.mla_specs(cfg)
    ref_specs = ref_mla.mla_specs(ref_cfg)
    assert sorted(specs) == sorted(ref_specs)
    for k, s in specs.items():
        assert s.shape == ref_specs[k].shape and s.init == ref_specs[k].init


def test_mla_train_and_prefill_cache_match_reference():
    ref_cfg, cfg, rp, tp = _attn()
    x, rx = _x(cfg, (B, S, cfg.d_model))
    y = mla.mla_train(cfg, tp, x)
    ry = ref_mla.mla_train(ref_cfg, rp, rx)
    assert y.shape == (B, S, cfg.d_model)
    assert _rel(y.numpy(), np.asarray(ry)) <= 1e-5
    c = mla.mla_prefill_cache(cfg, tp, x).to(torch.bfloat16)
    rc = ref_mla.mla_prefill_cache(ref_cfg, rp, rx).astype(jnp.bfloat16)
    m = cfg.mla
    assert c.shape == (B, S, m.kv_lora_rank + m.qk_rope_head_dim)
    assert_cache_close({"ckv": c.float().numpy()},
                       {"ckv": np.asarray(rc.astype(jnp.float32))})


@pytest.mark.parametrize("p", [0, 7, S - 1])
def test_mla_decode_matches_reference_and_mla_train(p):
    """Decode position p (each row of the batch) against a cache holding
    positions 0..p-1 from ``mla_prefill_cache``, with S slots."""
    ref_cfg, cfg, rp, tp = _attn()
    x, rx = _x(cfg, (B, S, cfg.d_model), seed=1)
    full = mla.mla_train(cfg, tp, x)                          # (B, S, D)
    cache = torch.zeros(B, S, cfg.mla.kv_lora_rank
                        + cfg.mla.qk_rope_head_dim, dtype=torch.bfloat16)
    if p:
        cache[:, :p] = mla.mla_prefill_cache(cfg, tp, x[:, :p])
    ref_cache = jnp.asarray(cache.float().numpy(), jnp.bfloat16)
    pos = torch.full((B,), p, dtype=torch.int64)
    y, cache2 = mla.mla_decode(cfg, tp, x[:, p], cache, pos)
    assert cache2 is cache                          # written in place
    ry, rcache = ref_mla.mla_decode(ref_cfg, rp, rx[:, p], ref_cache,
                                    jnp.asarray(pos.numpy(), jnp.int32))
    assert _rel(y.numpy(), np.asarray(ry)) <= 1e-5
    assert_cache_close({"ckv": cache.float().numpy()},
                       {"ckv": np.asarray(rcache.astype(jnp.float32))})
    assert _rel(y.numpy(), full[:, p].numpy()) <= 1e-2
