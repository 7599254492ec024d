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
import numpy as np
import torch

from repro.configs.base import LTFLConfig as RefLTFLConfig
from repro.configs.ltfl_paper import ResNetConfig as RefResNetConfig
from repro_torch.configs import LTFLConfig, ResNetConfig
from repro_torch.models import ResNet, params_to_numpy

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
