"""The port's prefill, KV cache, decode and generation against the
reference's ``DecoderLM`` and ``launch.serve`` loop.

Five configurations at ``reduce_for_smoke`` widths (2 layers, d_model
256): granite-8b (dense), granite-8b-sw4096 (its 64-token sliding window
at smoke width, decoded past the window so the ring buffer wraps),
olmoe-1b-7b (MoE), deepseek-v2-lite-16b (MoE with MLA and a dense prefix
layer) and phi-3-vision-4.2b (VLM, 8 image tokens). Both sides get the
same weights (made by the port, carried as numpy), tokens and image
embeddings, in float32 (the router is float32 in either case; the cache
is bfloat16 on both sides, as the reference keeps it).

Tolerances, as relative norm errors ||port - ref|| / ||ref||:

* logits of prefill, and of every decode step taken from the same
  cache on both sides (the reference's before the step) whose new
  entries come out equal: rel 1e-5 (the float32 bound of
  tests/test_torch_transformer.py; seen: 1.0e-6 to 3.1e-6);
* the cache is bfloat16, so a new k/v entry may round the other way on
  one side (see below), and the step attends to it at once: such a
  step's logits rel 1e-4 (seen: up to 6.9e-5);
* logits of every decode step when each side decodes from its own
  cache, where such entries add up: rel 3e-4 (seen: up to 1.5e-4 over
  8 steps, 4.4e-5 over 24);
* cache entries: bfloat16 values rounded from float32 k/v that differ
  by float32 noise, so an entry may round the other way: every element
  within one bf16 ulp (the larger of the two sides') plus 1e-5 of the
  tensor's largest magnitude (the noise itself, which decides near 0;
  rope at position p adds float32 noise of p's angle) of the
  reference's, and at most 1e-3 of them not equal; after a chain of
  steps on each side's own cache, 3e-4 of the largest magnitude and any
  share;
* greedy generation: equal ids.

Each side decodes from its own cache (the prefill's spliced into one of
prompt + steps positions) with the same teacher-forced tokens, and the
port also takes each step from the reference's cache.
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
from repro.models import layers as ref_layers
from repro_torch.launch.serve import generate
from repro_torch.models import build_model, layers

from torch_parity import (
    arch_pair,
    as_jax_like,
    assert_cache_close,
    cache_from_numpy,
    cache_to_numpy,
    decoder_weights,
    port_params_like,
)

B, P = 2, 48
STEPS = {"granite-8b-sw4096": 24}        # 48 + 24 > the 64-token window
ARCHS = ["granite-8b", "granite-8b-sw4096", "olmoe-1b-7b",
         "deepseek-v2-lite-16b", "phi-3-vision-4.2b"]
LOGIT_TOL = 1e-5
FLIP_TOL = 1e-4
CHAIN_TOL = 3e-4


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _inputs(cfg, n_tokens, seed=0):
    """Tokens (B, n_tokens) and, for the VLM, image embeddings (float32
    values that are bf16 values) as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (B, n_tokens)).astype(np.int32)}
    if cfg.family == "vlm":
        img = rng.standard_normal((B, cfg.num_image_tokens, cfg.d_model))
        out["image_embeds"] = (torch.from_numpy(img * 0.02).to(
            torch.bfloat16).to(torch.float32).numpy())
    return out


def ref_batch(inputs, n):
    b = {"tokens": jnp.asarray(inputs["tokens"][:, :n])}
    if "image_embeds" in inputs:
        b["image_embeds"] = jnp.asarray(inputs["image_embeds"],
                                        jnp.bfloat16)
    return b


def port_batch(inputs, n):
    b = {"tokens": torch.from_numpy(inputs["tokens"][:, :n]).long()}
    if "image_embeds" in inputs:
        b["image_embeds"] = torch.from_numpy(inputs["image_embeds"]).to(
            torch.bfloat16)
    return b


class Case:
    """One configuration on both sides: models, float32 parameters, inputs
    and the reference's jitted prefill and decode step."""

    def __init__(self, name, **replace):
        self.ref_cfg, self.cfg = arch_pair(name, **replace)
        self.ref_model = ref_build_model(self.ref_cfg)
        self.model = build_model(self.cfg)
        tree = decoder_weights(self.cfg)
        self.ref_params = as_jax_like(tree, self.ref_model.param_specs(),
                                      jnp.float32)
        self.params = port_params_like(tree, self.model, torch.float32)
        self.steps = STEPS.get(name, 8)
        self.inputs = _inputs(self.cfg, P + self.steps)
        self.n_img = (self.cfg.num_image_tokens
                      if self.cfg.family == "vlm" else 0)
        self.ref_prefill = jax.jit(self.ref_model.prefill)
        self.ref_decode = jax.jit(self.ref_model.decode_step)


_CASES = {}


def case(name):
    if name not in _CASES:
        _CASES[name] = Case(name)
    return _CASES[name]


@pytest.fixture(scope="module")
def runs():
    """Per configuration: prefill over P tokens, then ``steps`` decode
    steps at positions n_img + P + i on each side's own cache."""
    out = {}
    for name in ARCHS:
        c = case(name)
        n_ctx = c.n_img + P
        r_logits, r_cache = c.ref_prefill(c.ref_params,
                                          ref_batch(c.inputs, P))
        with torch.inference_mode():
            t_logits, t_cache = c.model.prefill(c.params,
                                                port_batch(c.inputs, P))
        rec = {"prefill": (t_logits.numpy(), np.asarray(r_logits)),
               "prefill_cache": (cache_to_numpy(t_cache),
                                 cache_to_numpy(r_cache))}
        rc = c.ref_model.init_cache(B, n_ctx + c.steps)
        rc = {k: v.at[:, :, :n_ctx].set(r_cache[k]) if v.shape[2] >= n_ctx
              else v for k, v in rc.items()}
        tc = c.model.init_cache(B, n_ctx + c.steps)
        for k, v in tc.items():
            if v.shape[2] >= n_ctx:
                v[:, :, :n_ctx] = t_cache[k]
        steps, chain = [], []
        for i in range(c.steps):
            tok = c.inputs["tokens"][:, P + i]
            pos = np.full((B,), n_ctx + i, np.int32)
            same = cache_from_numpy(cache_to_numpy(rc), "torch")
            r_l, rc = c.ref_decode(c.ref_params, jnp.asarray(tok),
                                   jnp.asarray(pos), rc)
            tok_t = torch.from_numpy(tok).long()
            pos_t = torch.from_numpy(pos).long()
            with torch.inference_mode():
                t_l, same = c.model.decode_step(c.params, tok_t, pos_t,
                                                same)
                c_l, tc2 = c.model.decode_step(c.params, tok_t, pos_t, tc)
            assert tc2 is tc                 # written in place
            steps.append((t_l.numpy(), np.asarray(r_l),
                          cache_to_numpy(same), cache_to_numpy(rc)))
            chain.append(c_l.numpy())
        rec["steps"] = steps
        rec["chain"] = chain
        rec["cache"] = (cache_to_numpy(tc), cache_to_numpy(rc))
        rec["cache_len"] = next(iter(tc.values())).shape[2]
        out[name] = rec
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_reference(runs, name):
    r = runs[name]
    got, ref = r["prefill"]
    cfg = case(name).cfg
    n_ctx = case(name).n_img + P
    assert got.shape == ref.shape == (B, n_ctx, cfg.vocab_size)
    assert _rel(got, ref) <= LOGIT_TOL
    got_c, ref_c = r["prefill_cache"]
    assert_cache_close(got_c, ref_c, "prefill")
    key = "ckv" if cfg.mla is not None else "k"
    assert got_c[key].shape[:3] == (cfg.n_layers, B, n_ctx)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_match_reference(runs, name):
    r = runs[name]
    for i, (got, ref, got_c, ref_c) in enumerate(r["steps"]):
        assert got.shape == (B, case(name).cfg.vocab_size)
        assert np.all(np.isfinite(got))
        assert_cache_close(got_c, ref_c, f"step {i}")
        equal = all(np.array_equal(got_c[k], ref_c[k]) for k in ref_c)
        assert _rel(got, ref) <= (LOGIT_TOL if equal else FLIP_TOL), i
        assert _rel(r["chain"][i], ref) <= CHAIN_TOL, i
    assert_cache_close(*r["cache"], "decode", noise=CHAIN_TOL, share=1.0)


def test_sliding_window_cache_is_a_ring_buffer(runs):
    """granite-8b-sw4096 at smoke width: the cache holds the 64-token
    window, and the decode steps reach position 71, so slots 0-7 were
    written twice (positions 0-7, then 64-71; the step test holds them to
    the reference's)."""
    c = case("granite-8b-sw4096")
    assert c.cfg.sliding_window == 64
    assert runs["granite-8b-sw4096"]["cache_len"] == 64
    assert P + c.steps == 72


def test_decode_past_a_full_cache_drops_the_write():
    """Without a window, a position past the cache's end writes nothing
    (the reference's scatter drops it) and attends to every slot."""
    c = case("granite-8b")
    rng = np.random.default_rng(3)
    cache = {k: rng.standard_normal((2, B, 8, c.cfg.n_kv_heads,
                                     c.cfg.head_dim)).astype(np.float32)
             for k in ("k", "v")}
    cache = {k: torch.from_numpy(v).to(torch.bfloat16).to(torch.float32)
             .numpy() for k, v in cache.items()}
    tok = np.array([1, 2], np.int32)
    pos = np.array([8, 3], np.int32)
    r_l, r_c = c.ref_decode(c.ref_params, jnp.asarray(tok), jnp.asarray(pos),
                            {k: jnp.asarray(v, jnp.bfloat16)
                             for k, v in cache.items()})
    tc = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in cache.items()}
    with torch.inference_mode():
        t_l, tc = c.model.decode_step(c.params, torch.from_numpy(tok).long(),
                                      torch.from_numpy(pos).long(), tc)
    got = cache_to_numpy(tc)
    assert np.array_equal(got["k"][:, 0], cache["k"][:, 0])   # row 0 kept
    assert not np.array_equal(got["k"][:, 1], cache["k"][:, 1])
    assert_cache_close(got, cache_to_numpy(r_c))
    assert _rel(t_l.numpy(), np.asarray(r_l)) <= LOGIT_TOL


# --------------------------------------------------------------------------- #
# The query-chunked path
# --------------------------------------------------------------------------- #
@pytest.fixture
def chunked(monkeypatch):
    """Both sides' chunked path above 32 query tokens, chunks of
    gcd(sq, 32)."""
    for mod in (ref_layers, layers):
        monkeypatch.setattr(mod, "CHUNKED_ATTN_THRESHOLD", 32)
        monkeypatch.setattr(mod, "Q_CHUNK", 32)
    calls = []
    inner = layers._attend_chunked
    monkeypatch.setattr(layers, "_attend_chunked",
                        lambda qg, *a, **kw: calls.append(qg.shape[1])
                        or inner(qg, *a, **kw))
    return calls


@pytest.mark.parametrize("name,n", [
    ("granite-8b", 64),              # 2 chunks of 32
    ("granite-8b-sw4096", 96),       # 3 chunks; the 64-token window bites
    ("phi-3-vision-4.2b", 40),       # 8 image tokens + 40: 3 chunks of 16
])
def test_chunked_prefill_matches_reference(chunked, name, n):
    c = case(name)
    inputs = _inputs(c.cfg, n, seed=1)
    # a fresh jit: the patched constants are read while tracing
    r_logits, r_cache = jax.jit(c.ref_model.prefill)(c.ref_params,
                                                     ref_batch(inputs, n))
    with torch.inference_mode():
        t_logits, t_cache = c.model.prefill(c.params, port_batch(inputs, n))
    assert chunked and set(chunked) == {c.n_img + n}
    assert _rel(t_logits.numpy(), np.asarray(r_logits)) <= LOGIT_TOL
    assert_cache_close(cache_to_numpy(t_cache), cache_to_numpy(r_cache))


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attend_with_query_offset(chunked, causal):
    """``attend`` on the chunked path with a query offset, grouped heads
    and a window, against the reference's."""
    ref_cfg, cfg = arch_pair("granite-8b-sw4096", sliding_window=24)
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 48, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 80, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 80, 2, 8)).astype(np.float32)
    ref = ref_layers.attend(ref_cfg, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v), causal=causal, q_offset=30)
    got = layers.attend(cfg, torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal, q_offset=30)
    assert chunked == [48]
    assert got.shape == (2, 48, 4, 8)
    assert _rel(got.numpy(), np.asarray(ref)) <= LOGIT_TOL


def test_chunks_below_16_raise_as_the_reference_asserts(chunked):
    """40 query tokens with Q_CHUNK 32: gcd 8 < 16."""
    ref_cfg, cfg = arch_pair("granite-8b")
    q = np.zeros((1, 40, 4, 8), np.float32)
    with pytest.raises(AssertionError):
        ref_layers.attend(ref_cfg, jnp.asarray(q), jnp.asarray(q),
                          jnp.asarray(q), causal=True)
    with pytest.raises(ValueError, match="at least 16"):
        layers.attend(cfg, torch.from_numpy(q), torch.from_numpy(q),
                      torch.from_numpy(q), causal=True)


# --------------------------------------------------------------------------- #
# Generation: the launcher's loop against the reference's
# --------------------------------------------------------------------------- #
GEN = 8


def ref_generate(c, batch, gen):
    """``repro.launch.serve.main``'s loop (greedy), with its splice."""
    logits, prompt_cache = c.ref_prefill(c.ref_params, batch)
    prompt_len = batch["tokens"].shape[1]
    cache = c.ref_model.init_cache(B, prompt_len + gen)

    def splice(dst, src):
        if dst.ndim >= 3 and src.ndim == dst.ndim \
                and src.shape[2] == prompt_len \
                and dst.shape[2] >= prompt_len:
            return dst.at[:, :, :prompt_len].set(src.astype(dst.dtype))
        return src.astype(dst.dtype) if dst.shape == src.shape else dst

    cache = jax.tree_util.tree_map(splice, cache, prompt_cache)
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)
    out = [tok]
    for i in range(gen - 1):
        pos = jnp.full((B,), prompt_len + i, jnp.int32)
        logits, cache = c.ref_decode(c.ref_params, tok, pos, cache)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.stack(out, axis=1))


@pytest.mark.parametrize("name", ["granite-8b", "olmoe-1b-7b",
                                  "deepseek-v2-lite-16b",
                                  "phi-3-vision-4.2b"])
def test_greedy_generation_matches_reference(name):
    """8 greedy tokens from a 48-token prompt. (phi-3-vision: the prompt
    cache also holds the image tokens, so by the reference's splice rule
    decode starts from a zero cache on both sides.)"""
    c = case(name)
    ref_ids = ref_generate(c, ref_batch(c.inputs, P), GEN)
    res = generate(c.model, c.params, port_batch(c.inputs, P), GEN)
    assert res.tokens.shape == (B, GEN) and res.logits.shape[:2] == (B, GEN)
    assert res.step_ms == []                    # CUDA events: card only
    np.testing.assert_array_equal(res.tokens.numpy(), ref_ids)


def test_sampled_generation_is_seeded():
    """--temperature > 0 draws from generators seeded 100 + i: the same
    ids twice, and other ids than greedy decoding."""
    c = case("granite-8b")
    batch = port_batch(c.inputs, P)
    a = generate(c.model, c.params, batch, GEN, temperature=2.0)
    b = generate(c.model, c.params, batch, GEN, temperature=2.0)
    greedy = generate(c.model, c.params, batch, GEN)
    assert torch.equal(a.tokens, b.tokens)
    assert torch.equal(a.tokens[:, 0], greedy.tokens[:, 0])
    assert not torch.equal(a.tokens, greedy.tokens)
