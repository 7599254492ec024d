"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

Data crosses between the JAX reference and the PyTorch port only as numpy
arrays. The reference's quantizer uniforms are rebuilt here in jax from
the round's integer seed, exactly as its step draws them
(``repro.core.ltfl_step`` splits the round key into C + 1 client keys,
``repro.core.compressors.ltfl_quantizer`` splits each client key per
leaf and draws ``uniform(k, leaf.shape)``), and handed to the port
through its ``uniforms`` hook.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import LTFLConfig as RefLTFLConfig
from repro.configs.ltfl_paper import ResNetConfig as RefResNetConfig
from repro.models import build_model as ref_build_model
from repro_torch.configs import LTFLConfig, ResNetConfig
from repro_torch.launch.serve import generate, splice
from repro_torch.models import (
    ResNet,
    build_model,
    params_from_numpy,
    params_to_numpy,
)

# the small configuration every parity test uses: ResNet width 8,
# U = 4 devices, per-device batch 4, a short Algorithm-1 solve
WIDTH = dict(stem_channels=8, group_channels=(8, 16, 32, 32))
LTFL = dict(num_devices=4, bo_iters=4, alt_max_iters=2)
BATCH = 4


def ref_resnet_config():
    return RefResNetConfig(**WIDTH)


def port_resnet_config():
    return ResNetConfig(**WIDTH)


def ref_ltfl():
    return RefLTFLConfig(**LTFL)


def port_ltfl():
    return LTFLConfig(**LTFL)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _reference_draws(key, n_clients, shapes):
    def per_client(k):
        leaf_keys = jax.random.split(k, len(shapes))
        return [jax.random.uniform(leaf_keys[i], s)
                for i, s in enumerate(shapes)]
    keys = jax.random.split(key, n_clients + 1)
    return jax.vmap(per_client)(keys[:n_clients])


def initial_weights(seed=0):
    """Initial ResNet weights as the reference's numpy tree, made once
    with the port's initializer and handed to both sides."""
    model = ResNet(port_resnet_config())
    gen = torch.Generator()
    gen.manual_seed(seed)
    return params_to_numpy(model.init(gen))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _reference_draws_flat(key, n_clients, n_leaves, width):
    def per_client(k):
        leaf_keys = jax.random.split(k, n_leaves)
        return jax.vmap(lambda lk: jax.random.uniform(lk, (width,)))(
            leaf_keys)
    keys = jax.random.split(key, n_clients + 1)
    return jax.vmap(per_client)(keys[:n_clients])


def jax_uniforms(seed, n_clients, shapes):
    """The reference step's quantizer uniforms for round seed ``seed``:
    one (C, *shape) float32 tensor per leaf, in leaf order (split and
    vmapped over clients as the reference step does).

    With partitionable threefry (jax's default since 0.5) element i of
    ``uniform(k, shape)`` depends only on k and the flat index i, so one
    draw of the widest leaf's length per key, cut to each leaf, gives the
    same numbers at one compile instead of one per leaf shape."""
    shapes = tuple(tuple(s) for s in shapes)
    key = jax.random.PRNGKey(seed)
    if not jax.config.jax_threefry_partitionable:
        draws = _reference_draws(key, n_clients, shapes)
        return [torch.from_numpy(np.array(d)) for d in draws]
    sizes = [int(np.prod(s)) for s in shapes]
    flat = np.asarray(_reference_draws_flat(key, n_clients, len(shapes),
                                            max(sizes)))
    return [torch.from_numpy(flat[:, i, :n].reshape((n_clients,) + s).copy())
            for i, (n, s) in enumerate(zip(sizes, shapes))]


def tree_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_drop_uniforms(seed, n_clients):
    """The reference step's in-step packet-drop draw for round seed
    ``seed``: ``uniform(keys[-1], (C,))`` where ``keys`` splits the round
    key into C + 1 (``repro.core.ltfl_step``)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_clients + 1)
    return torch.from_numpy(np.array(jax.random.uniform(keys[-1],
                                                        (n_clients,))))


def lm_arch():
    """granite-8b at ``reduce_for_smoke`` widths (2 layers, d_model 256,
    4 heads, d_ff 512, vocab 512) on both sides."""
    from repro.configs import get_arch as ref_get_arch
    from repro.configs import reduce_for_smoke as ref_reduce
    from repro_torch.configs import get_arch, reduce_for_smoke
    return (ref_reduce(ref_get_arch("granite-8b")),
            reduce_for_smoke(get_arch("granite-8b")))


def lm_weights(seed=0):
    """Initial decoder-LM weights as the reference's numpy tree (float32
    values, each exactly a bfloat16 value), made with the port's
    initializer and handed to both sides."""
    from repro_torch.models import DecoderLM
    gen = torch.Generator()
    gen.manual_seed(seed)
    return params_to_numpy(DecoderLM(lm_arch()[1]).init(gen))


def as_jax(tree, dtype):
    """A numpy tree as jax arrays of ``dtype``."""
    import jax.numpy as jnp
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), tree)


# --------------------------------------------------------------------------- #
# Decoder LMs of every family, mixed-dtype trees and KV caches
# --------------------------------------------------------------------------- #
def arch_pair(name, **replace):
    """``name`` at ``reduce_for_smoke`` widths on both sides (reference,
    port), with the same ``ArchConfig.replace`` fields applied."""
    from repro.configs import get_arch as ref_get_arch
    from repro.configs import reduce_for_smoke as ref_reduce
    from repro_torch.configs import get_arch, reduce_for_smoke
    return (ref_reduce(ref_get_arch(name)).replace(**replace),
            reduce_for_smoke(get_arch(name)).replace(**replace))


def decoder_weights(cfg, seed=0):
    """Initial ``DecoderLM`` weights for the port's config ``cfg`` as the
    reference's numpy tree (float32; the bf16 leaves' values exactly
    bfloat16 values, the router's float32 draws)."""
    from repro_torch.models import DecoderLM
    gen = torch.Generator()
    gen.manual_seed(seed)
    return params_to_numpy(DecoderLM(cfg).init(gen))


def as_jax_like(tree, specs, dtype):
    """A numpy tree as jax arrays: leaves whose ``ParamSpec`` (from the
    reference's ``param_specs()``) is float32 stay float32 (the MoE
    router), the rest become ``dtype``."""
    import jax.numpy as jnp
    return jax.tree_util.tree_map(
        lambda x, s: jnp.asarray(
            x, jnp.float32 if s.dtype == jnp.float32 else dtype),
        tree, specs, is_leaf=lambda x: hasattr(x, "axes"))


def port_params_like(tree, model, dtype):
    """The same numpy tree as the port's parameters: float32 where the
    port's spec is float32, ``dtype`` elsewhere."""
    from repro_torch.models import params_from_numpy
    specs = model.param_specs()
    return {k: v.to(torch.float32 if specs[k].dtype == torch.float32
                    else dtype)
            for k, v in params_from_numpy(tree).items()}


def cache_to_numpy(cache):
    """A KV cache dict (jax or torch; bf16) as float32 numpy arrays."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().to(torch.float32).cpu().numpy()
        else:
            out[k] = np.asarray(v.astype(np.float32))
    return out


def cache_from_numpy(cache, side):
    """Float32 numpy cache arrays (each exactly a bf16 value) as a bf16
    cache on ``side`` ("jax" or "torch")."""
    if side == "jax":
        import jax.numpy as jnp
        return {k: jnp.asarray(v, jnp.bfloat16) for k, v in cache.items()}
    return {k: torch.from_numpy(np.array(v)).to(torch.bfloat16)
            for k, v in cache.items()}


def assert_cache_close(got, ref, where="", noise=1e-5, share=1e-3):
    """Every element within one bf16 ulp plus ``noise`` times the largest
    |ref| of ``ref``; at most ``share`` of them not equal."""
    def ulp(x):
        return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)

    assert sorted(got) == sorted(ref), where
    for k in ref:
        g, r = got[k], ref[k]
        assert g.shape == r.shape, (where, k)
        tol = noise * np.max(np.abs(r))
        assert np.all(np.abs(g - r) <= np.maximum(ulp(g), ulp(r)) + tol), \
            (where, k, np.max(np.abs(g - r) - np.maximum(ulp(g), ulp(r))))
        assert np.mean(g != r) <= share, (where, k, np.mean(g != r))


# --------------------------------------------------------------------------- #
# The SSM, hybrid and encoder-decoder families (tests/test_torch_rwkv_hybrid.py
# and tests/test_torch_encdec.py): rwkv6-7b, zamba2-2.7b and whisper-medium
# at ``reduce_for_smoke`` widths, both models on the same weights (made by
# the port, the leaves whose init is zeros or ones moved off it by 0.1
# normals so that every term counts; carried as numpy), tokens and frames.
# rwkv6 and zamba2 in float32. The reference's encoder takes its frames in
# bfloat16 and its ``lax.scan`` cannot carry them up to float32, so
# whisper's encoder leaves are bfloat16 on both sides and the rest float32,
# and the port's decoder gets the reference's encoder output (``encode``
# replaced on the model instance); tests/test_torch_encdec.py holds the
# encoder to the bf16 noise. Tolerances, as relative norm errors, those of
# tests/test_torch_families.py and tests/test_torch_serve.py: logits and
# every gradient leaf rel 1e-5, the loss rel 1e-6; the prefill's float32
# state rel 1e-5 and its bf16 cache to one bf16 ulp on <= 1e-3 of its
# elements; a chain of decode steps from each side's own cache rel 3e-4
# (a bf16 tm_prev / cm_prev / k/v entry may round the other way on one
# side); greedy generation through ``launch.serve.generate`` gives the
# reference serve loop's ids; prefill-then-decode against forward over the
# same tokens (tests/test_models_smoke.py's consistency check): the port's
# gap at most twice the reference's plus 1e-5 (on both sides the gap is the
# bf16 cache's rounding).
# --------------------------------------------------------------------------- #

# batch, prompt and decode steps of the family checks
FB, FS, FSTEPS = 2, 32, 6
TOL, LOSS_TOL, CHAIN_TOL = 1e-5, 1e-6, 3e-4


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16_leaf(cfg, name):
    return cfg.family == "encdec" and name.startswith("encoder.")


def _path_name(path):
    return ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _moved_init(model, seed):
    """The port's init from ``seed``, the leaves whose init is zeros or
    ones moved off it by 0.1 normals (numpy, seed + 1), each value made a
    bfloat16 value."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    flat = model.init(gen)
    rng = np.random.default_rng(seed + 1)
    for k, s in model.param_specs().items():
        if s.init in ("zeros", "ones"):
            flat[k] = (flat[k].float() + torch.from_numpy(
                0.1 * rng.standard_normal(s.shape).astype(np.float32))
            ).to(s.dtype)
    return flat


class FamilyPair:
    """Both models, the carried weights on both sides, and a batch."""

    def __init__(self, name):
        self.ref_cfg, self.cfg = arch_pair(name)
        self.ref_model = ref_build_model(self.ref_cfg, remat=False)
        self.model = build_model(self.cfg)
        tree = params_to_numpy(_moved_init(self.model, 0))
        rng = np.random.default_rng(1)
        self.params = {k: v.to(torch.bfloat16 if bf16_leaf(self.cfg, k)
                               else torch.float32)
                       for k, v in params_from_numpy(tree).items()}
        self.ref_params = jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.asarray(x, jnp.bfloat16 if bf16_leaf(
                self.cfg, _path_name(p)) else jnp.float32), tree)
        self.tokens = rng.integers(0, self.cfg.vocab_size,
                                   (FB, FS + FSTEPS)).astype(np.int32)
        self.frames = None
        if self.cfg.family == "encdec":
            self.frames = torch.from_numpy(0.02 * rng.standard_normal(
                (FB, self.cfg.encoder_seq, self.cfg.d_model))).to(
                    torch.bfloat16)
            enc = jax.jit(self.ref_model.encode)(self.ref_params,
                                                 self.ref_frames())
            self.ref_enc = torch.from_numpy(np.array(
                enc.astype(jnp.float32))).to(torch.bfloat16)
            self.model.encode = lambda params, frames: self.ref_enc

    def ref_frames(self):
        return jnp.asarray(self.frames.float().numpy(), jnp.bfloat16)

    def batches(self, n, labels=True):
        tok = self.tokens[:, :n]
        rb = {"tokens": jnp.asarray(tok)}
        tb = {"tokens": torch.from_numpy(tok).long()}
        if labels:
            rb["labels"], tb["labels"] = rb["tokens"], tb["tokens"]
        if self.frames is not None:
            rb["frames"], tb["frames"] = self.ref_frames(), self.frames
        return rb, tb


def check_structure(pair):
    """Leaf names, order, shapes and dtypes of the reference's tree."""
    ref_specs = pair.ref_model.param_specs()
    ref_flat = params_from_numpy(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), ref_specs,
        is_leaf=lambda x: hasattr(x, "axes")))
    specs = pair.model.param_specs()
    assert list(specs) == list(ref_flat)
    for k, s in specs.items():
        assert s.shape == tuple(ref_flat[k].shape), k
        assert s.dtype == ref_flat[k].dtype, k


def check_forward_loss_and_gradients(pair):
    rb, tb = pair.batches(FS)
    rl, rg = jax.jit(jax.value_and_grad(pair.ref_model.loss))(
        pair.ref_params, rb)
    rlog, raux = jax.jit(pair.ref_model.forward)(pair.ref_params, rb)
    tg, tl = torch.func.grad_and_value(pair.model.loss)(pair.params, tb)
    tlog, taux = pair.model.forward(pair.params, tb)
    assert tlog.shape == (FB, FS, pair.cfg.vocab_size)
    assert rel(as_np(tlog), as_np(rlog)) <= TOL
    assert abs(float(tl) - float(rl)) <= LOSS_TOL * abs(float(rl))
    assert float(taux) == float(raux) == 0.0
    ref_grads = params_from_numpy(jax.tree_util.tree_map(as_np, rg))
    assert list(tg) == list(ref_grads)
    checked = 0
    for k, g in tg.items():
        assert g.dtype == pair.params[k].dtype, k
        if pair.cfg.family == "encdec" and (
                k.startswith(("encoder.", "enc_final_norm."))
                or k == "embed.pos"):
            continue      # the encoder's side: tests/test_torch_encdec.py
        assert rel(as_np(g), ref_grads[k].numpy()) <= TOL, k
        checked += 1
    assert checked >= 20


def _splice_ref(cache, prompt_cache, n):
    def one(dst, src):
        if dst.ndim >= 3 and src.ndim == dst.ndim and src.shape[2] == n \
                and dst.shape[2] >= n:
            return dst.at[:, :, :n].set(src.astype(dst.dtype))
        return src.astype(dst.dtype) if dst.shape == src.shape else dst
    return jax.tree_util.tree_map(one, cache, prompt_cache)


def _check_cache(got, want, where, chain=False):
    f32 = {k for k, v in want.items() if v.dtype == jnp.float32}
    for k in f32:
        assert got[k].dtype == torch.float32, (where, k)
        assert rel(as_np(got[k]), as_np(want[k])) <= (
            CHAIN_TOL if chain else TOL), (where, k)
    bf16 = {k: as_np(got[k]) for k in want if k not in f32}
    assert all(got[k].dtype == torch.bfloat16 for k in bf16), where
    if chain:
        assert_cache_close(bf16, {k: as_np(want[k]) for k in bf16}, where,
                           noise=CHAIN_TOL, share=1.0)
    else:
        assert_cache_close(bf16, {k: as_np(want[k]) for k in bf16}, where)


def check_prefill_and_decode_chain(pair):
    """Prefill of S tokens (logits and cache), the cache spliced into one
    of S + STEPS positions on each side by the reference's rule, then
    STEPS teacher-forced decode steps, each side from its own cache."""
    rb, tb = pair.batches(FS, labels=False)
    rlog, rpc = jax.jit(pair.ref_model.prefill)(pair.ref_params, rb)
    with torch.inference_mode():
        tlog, tpc = pair.model.prefill(pair.params, tb)
    assert rel(as_np(tlog), as_np(rlog)) <= TOL
    assert sorted(tpc) == sorted(rpc)
    _check_cache(tpc, rpc, "prefill")

    rcache = _splice_ref(pair.ref_model.init_cache(FB, FS + FSTEPS), rpc, FS)
    tcache = pair.model.init_cache(FB, FS + FSTEPS)
    tcache = {k: splice(tcache[k], tpc[k], FS) for k in tcache}
    decode = jax.jit(pair.ref_model.decode_step)
    for i in range(FSTEPS):
        tok = pair.tokens[:, FS + i]
        pos = np.full((FB,), FS + i, np.int32)
        rl, rcache = decode(pair.ref_params, jnp.asarray(tok),
                            jnp.asarray(pos), rcache)
        with torch.inference_mode():
            tl, tcache = pair.model.decode_step(
                pair.params, torch.from_numpy(tok).long(),
                torch.from_numpy(pos).long(), tcache)
        assert rel(as_np(tl), as_np(rl)) <= CHAIN_TOL, i
        for k in rcache:          # each leaf in the reference's dtype
            assert str(tcache[k].dtype)[6:] == str(rcache[k].dtype), k
    _check_cache(tcache, rcache, "after the decode chain", chain=True)


def check_prefill_then_decode(pair):
    """Decode of token S after a prefill of S tokens against forward over
    S + 1 tokens, on each side; the port's gap within twice the
    reference's (plus 1e-5)."""
    gaps = []
    for side in ("ref", "port"):
        rb, tb = pair.batches(FS + 1, labels=False)
        pb = dict(rb if side == "ref" else tb)
        pb["tokens"] = pb["tokens"][:, :FS]
        pos = np.full((FB,), FS, np.int32)
        tok = pair.tokens[:, FS]
        if side == "ref":
            m, p = pair.ref_model, pair.ref_params
            _, pc = jax.jit(m.prefill)(p, pb)
            cache = _splice_ref(m.init_cache(FB, FS + 1), pc, FS)
            dec, _ = jax.jit(m.decode_step)(p, jnp.asarray(tok),
                                            jnp.asarray(pos), cache)
            full, _ = jax.jit(m.forward)(p, rb)
        else:
            m, p = pair.model, pair.params
            with torch.inference_mode():
                _, pc = m.prefill(p, pb)
                cache = m.init_cache(FB, FS + 1)
                cache = {k: splice(cache[k], pc[k], FS) for k in cache}
                dec, _ = m.decode_step(p, torch.from_numpy(tok).long(),
                                       torch.from_numpy(pos).long(), cache)
                full, _ = m.forward(p, tb)
        gaps.append(rel(as_np(dec), as_np(full)[:, FS]))
    ref_gap, gap = gaps
    assert gap <= 2 * ref_gap + 1e-5, gaps


def check_greedy_generation(pair):
    """``generate`` (prefill, splice, greedy decode) against the
    reference launcher's loop on the same model: equal ids."""
    rb, tb = pair.batches(FS, labels=False)
    n_gen = 6
    rlog, rpc = jax.jit(pair.ref_model.prefill)(pair.ref_params, rb)
    cache = _splice_ref(pair.ref_model.init_cache(FB, FS + n_gen), rpc, FS)
    tok = jnp.argmax(rlog[:, -1, :], axis=-1).astype(jnp.int32)
    ids = [np.asarray(tok)]
    decode = jax.jit(pair.ref_model.decode_step)
    for i in range(n_gen - 1):
        logits, cache = decode(pair.ref_params, tok,
                               jnp.full((FB,), FS + i, jnp.int32), cache)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        ids.append(np.asarray(tok))
    res = generate(pair.model, pair.params, tb, n_gen)
    assert res.tokens.shape == (FB, n_gen)
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(ids, 1))


# --------------------------------------------------------------------------- #
# The datacenter step of every family (tests/test_torch_datacenter_*.py):
# tests/test_torch_datacenter.py's check of granite-8b, for any config at
# ``reduce_for_smoke`` widths
# --------------------------------------------------------------------------- #
DC_C, DC_LR, DC_BLOCK = 4, 0.05, 32
DC_CONTROLS = {"rho": np.array([0.25, 0.1, 0.5, 0.25], np.float32),
               "delta": np.array([8.0, 8.0, 4.0, 2.0], np.float32),
               "drop_prob": np.array([0.05, 0.05, 0.6, 0.3], np.float32),
               "weights": np.array([500.0, 450.0, 520.0, 610.0], np.float32)}


def _bf16_ulp(x):
    """One bf16 ulp at |x| (float32)."""
    a = x.abs().to(torch.bfloat16)
    up = torch.nextafter(a, torch.full_like(a, float("inf")))
    return up.to(torch.float32) - a.to(torch.float32)


def dc_batch(cfg, seq=64, seed=1):
    """A (C, 2, seq) token batch, plus image embeddings or frames (C, 2,
    n, D) bf16 for the VLM and encoder-decoder families: (ref, port)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (DC_C, 2, seq)).astype(np.int32)
    rb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens).long(),
          "labels": torch.from_numpy(tokens).long()}
    extra = {"vlm": ("image_embeds", cfg.num_image_tokens),
             "encdec": ("frames", cfg.encoder_seq)}.get(cfg.family)
    if extra is not None:
        key, n = extra
        x = torch.from_numpy(0.02 * rng.standard_normal(
            (DC_C, 2, n, cfg.d_model))).to(torch.bfloat16)
        rb[key] = jnp.asarray(x.float().numpy(), jnp.bfloat16)
        tb[key] = x
    return rb, tb


def check_datacenter_step(name, seed=0):
    """One block-pruned LTFL step (block 32, the LTFL quantizer, in-step
    drops; C = 4 clients with their own rho, delta, drop_prob and
    weights) of ``name`` against the reference's jitted step from the
    same weights, with the reference's quantizer uniforms and drop draw.
    The weights are float32 (bf16 values; whisper's encoder leaves
    bfloat16, ``bf16_leaf``): in bfloat16 the two sides' gradients differ
    by more bf16 noise on these families than on granite-8b (jax's CPU
    backend keeps excess precision inside fused bf16 ops, the port rounds
    each op), enough to move more than 5% of a leaf by an ulp (seen: rwkv6
    and zamba2 embed.tok). The leaves whose init is zeros or ones start
    off it (``_moved_init``): at exactly zero one bf16 ulp of the new
    value is an ulp of the update itself, below the noise that whisper's
    bfloat16 encoder (0.7% of its output, tests/test_torch_encdec.py)
    puts into every gradient (seen from zero: up to 72% of
    decoder.ln_x.beta's elements past it, at a 3% norm error of the
    update). Checked:
    tile and element masks bitwise; clients received equal; the loss rel
    1e-3, each client's range_sq rel 5e-2 and the aggregate's grad_norm
    rel 5e-3; per updated leaf at most 5% of the elements more than one
    bf16 ulp off the reference's, none farther than its largest update
    plus one ulp, and the update's relative norm error at most 0.25
    (tests/test_torch_datacenter.py's bounds and reasons)."""
    from repro.core.ltfl_step import make_fl_train_step as ref_make_step
    from repro.core.pruning import prune_pytree as ref_prune_pytree
    from repro.optim import sgd as ref_sgd
    from repro_torch.core.compressors import ltfl_quantizer
    from repro_torch.core.ltfl_step import make_fl_train_step
    from repro_torch.core.pruning import element_masks, prune_pytree
    from repro_torch.optim import sgd

    ref_cfg, cfg = arch_pair(name)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    tree = params_to_numpy(_moved_init(model, seed))
    rp = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(x, jnp.bfloat16 if bf16_leaf(
            cfg, _path_name(p)) else jnp.float32), tree)
    p0 = {k: v.to(torch.bfloat16 if bf16_leaf(cfg, k) else torch.float32)
          for k, v in params_from_numpy(tree).items()}
    rb, tb = dc_batch(cfg)
    ctl = {k: jnp.asarray(v) for k, v in DC_CONTROLS.items()}
    tc = {k: torch.from_numpy(v) for k, v in DC_CONTROLS.items()}

    ref_step = jax.jit(ref_make_step(ref_model, ref_sgd(DC_LR), DC_C,
                                     prune_block=DC_BLOCK))
    rp1, _, _, rm = ref_step(rp, (), (), rb, ctl, jax.random.PRNGKey(seed))
    step = make_fl_train_step(
        model, sgd(DC_LR), DC_C, prune_block=DC_BLOCK, prune_kind="block",
        compressor=ltfl_quantizer(uniforms=jax_uniforms),
        drop_uniforms=jax_drop_uniforms)
    p1, _, _, m = step(p0, (), (), tb, tc, seed)

    # masks
    _, masks = prune_pytree(p0, tc["rho"], block=DC_BLOCK)
    got = element_masks(p0, masks, DC_BLOCK)
    want = params_from_numpy(tree_numpy(jax.jit(jax.vmap(
        lambda p, r: ref_prune_pytree(p, r, block=DC_BLOCK)[1],
        in_axes=(None, 0)))(rp, ctl["rho"])))
    assert list(got) == list(want)
    for k, g in got.items():
        np.testing.assert_array_equal(
            np.broadcast_to(g.numpy(), want[k].shape), want[k].numpy(),
            err_msg=f"{name} mask {k}")
    # metrics
    assert float(m["clients_received"]) == float(rm["clients_received"])
    assert abs(float(m["loss"]) - float(rm["loss"])) \
        <= 1e-3 * abs(float(rm["loss"])), (float(m["loss"]),
                                           float(rm["loss"]))
    np.testing.assert_allclose(m["range_sq"].numpy(),
                               np.asarray(rm["range_sq"]), rtol=5e-2)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(rm["grad_norm"]), rtol=5e-3)
    # updated weights
    ref1 = params_from_numpy(tree_numpy(rp1))
    for k, v0 in p0.items():
        assert p1[k].dtype == v0.dtype, k
        new, want_new, old = (t.to(torch.float32)
                              for t in (p1[k], ref1[k], v0))
        diff = (new - want_new).abs()
        ulp = _bf16_ulp(want_new)
        assert float((diff > ulp).float().mean()) <= 0.05, (name, k)
        ref_upd = want_new - old
        assert bool((diff <= ref_upd.abs().max() + ulp).all()), (name, k)
        if float(ref_upd.norm()) > 0:
            err = float(((new - old) - ref_upd).norm() / ref_upd.norm())
            assert err <= 0.25, (name, k, err)
    return m


def check_decode_from_the_prefill_cache(pair):
    """One decode step from the prefill's own cache, unspliced: its
    float32 leaves (RWKV6's tm_prev / cm_prev, the hybrid's conv state
    under float32 weights) are read as float32 at every layer, as the
    reference's scan reads them, though the step's outputs take another
    dtype (RWKV6 casts tm_prev / cm_prev to bf16)."""
    rb, tb = pair.batches(FS, labels=False)
    _, rpc = jax.jit(pair.ref_model.prefill)(pair.ref_params, rb)
    with torch.inference_mode():
        _, tpc = pair.model.prefill(pair.params, tb)
    assert any(v.dtype == torch.float32 and k not in ("state", "ssm")
               for k, v in tpc.items())
    tok = pair.tokens[:, FS]
    pos = np.full((FB,), FS, np.int32)
    rl, rcache = jax.jit(pair.ref_model.decode_step)(
        pair.ref_params, jnp.asarray(tok), jnp.asarray(pos), rpc)
    with torch.inference_mode():
        tl, tcache = pair.model.decode_step(
            pair.params, torch.from_numpy(tok).long(),
            torch.from_numpy(pos).long(), tpc)
    assert rel(as_np(tl), as_np(rl)) <= TOL
    for k in rcache:
        assert str(tcache[k].dtype)[6:] == str(rcache[k].dtype), k


def host_bo_draws(seed: int, alternations: int, iters: int, d: int,
                  init_points: int = 4, n_candidates: int = 512):
    """The host optimizer's numpy draw order (per alternation: the init
    uniforms, then per iteration the candidate uniforms and the
    0.1-scaled local normals) as the port's ``BODraws`` with a leading
    alternation axis, float32: tests/test_device_control.py's
    ``host_bo_draws``."""
    from repro_torch.control import BODraws
    rng = np.random.default_rng(seed)
    ui = np.empty((alternations, init_points, d))
    uc = np.empty((alternations, iters, n_candidates, d))
    ep = np.empty((alternations, iters, n_candidates // 4, d))
    for a in range(alternations):
        ui[a] = rng.uniform(size=(init_points, d))
        for m in range(iters):
            uc[a, m] = rng.uniform(size=(n_candidates, d))
            ep[a, m] = rng.normal(0.0, 0.1, size=(n_candidates // 4, d))
    return BODraws(*(torch.from_numpy(x.astype(np.float32))
                     for x in (ui, uc, ep)))


def mlp_world(n_train=600, n_test=128, seed=0):
    """The engine tests' small world on the port's side: an MLP (hidden
    16, downsample 4) from a seeded generator and synthetic CIFAR train
    and test sets; returns (model, params, train, test)."""
    from repro_torch.data import ArrayDataset, synthetic_cifar
    from repro_torch.models import MLP, MLPConfig
    imgs, labels = synthetic_cifar(n_train, seed=seed)
    timgs, tlabels = synthetic_cifar(n_test, seed=seed + 1)
    model = MLP(MLPConfig(hidden=(16,), downsample=4))
    gen = torch.Generator()
    gen.manual_seed(seed)
    return (model, model.init(gen),
            ArrayDataset({"images": imgs, "labels": labels}),
            ArrayDataset({"images": timgs, "labels": tlabels}))
