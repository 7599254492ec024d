"""The rank program of ``test_torch_tensor_parallel.py``: the dense,
MoE, VLM and RWKV6 families' tensor-parallel step, prefill and decode on
one rank of a (2, 4) gloo mesh. A module of its own, without jax, so
that each spawned rank imports only the port."""
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.core.compressors import ltfl_quantizer
from repro_torch.core.ltfl_step import make_fl_train_step
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import sgd

C, ROWS, SEQ, BLOCK, LR, SEED, STEPS = 2, 4, 16, 64, 0.05, 11, 4
# name: (arch, ArchConfig fields, MoEConfig fields); the MoE configs have
# 8 experts at top 2, so 2 sit on each of the 4 'model' ranks
CONFIGS = {"granite": ("granite-8b", dict(n_kv_heads=2), {}),
           "qwen": ("qwen1.5-32b", dict(n_heads=6, n_kv_heads=6,
                                        head_dim=32), {}),
           # capacity 8 a group of 64 tokens: assignments are dropped
           "olmoe": ("olmoe-1b-7b", {}, dict(num_experts=8, top_k=2,
                                              capacity_factor=0.5)),
           "deepseek": ("deepseek-v2-lite-16b", {},
                        dict(num_experts=8, top_k=2)),
           # 6 heads and 6 experts, which 'model' 4 does not split: wq,
           # w_uk and w_uv cut heads (gathered, attended whole, split
           # before wo), and the experts and router are whole
           "deepseek_cut": ("deepseek-v2-lite-16b",
                            dict(n_heads=6, n_kv_heads=6),
                            dict(num_experts=6, top_k=2)),
           # 8 image tokens ahead of the 16 text tokens: a stream of 24
           "phi": ("phi-3-vision-4.2b", {}, {}),
           # 8 heads of 32, two a rank
           "rwkv": ("rwkv6-7b", {}, {})}
# olmoe's router (256, 8) is pruned by tiles of 8 (its 2-column shards
# by sub-tiles, as the full-width router's 4 columns at block 32);
# deepseek's, not tileable at 64, by magnitude; rwkv6's u (8, 32) by tiles
# of 8 (its 2-row head shards by sub-tiles, as the full-width u's 4 rows a
# rank at block 32)
BLOCKS = {"olmoe": 8, "rwkv": 8}
LAYOUTS = {"d_model": {}, "seq": {"act": "seq"},
           "whole": {"rules_override": {"act_embed": None}}}
# (layout, uplink): the quantizer under the baseline layout; every layout
# unquantized, where no stochastic level can flip
CASES = [("d_model", "ltfl")] + [(layout, "none") for layout in LAYOUTS]
# the fallbacks' config runs the layout that splits the most
ONLY = {"deepseek_cut": [("seq", "none")]}
CONTROLS = {"rho": [0.25, 0.5], "delta": [3.0, 5.0],
            "weights": [40.0, 60.0], "drop_prob": [0.0, 0.0]}


def reduced(cfg, name):
    """``reduce_for_smoke(cfg)`` with ``name``'s fields (either side's
    config classes)."""
    _, replace, moe = CONFIGS[name]
    cfg = cfg.replace(**replace)
    if moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def port_config(name):
    return reduced(reduce_for_smoke(get_arch(CONFIGS[name][0])), name)


def block(name):
    return BLOCKS.get(name, BLOCK)


def cases(name):
    return ONLY.get(name, CASES)


def controls():
    return {k: torch.tensor(v) for k, v in CONTROLS.items()}


def source(uniforms):
    """The injected uniforms (numpy, one (C, *leaf) array a leaf) as a
    quantizer's uniform source."""
    def draw(seed, n, shapes):
        assert seed == SEED and n == C
        assert [tuple(s) for s in shapes] == [u.shape[1:] for u in uniforms]
        return [torch.from_numpy(u) for u in uniforms]
    return draw


def images(cfg):
    """The VLM's (C, ROWS, num_image_tokens, d_model) image embeddings
    (float32, seeded), or None for the other families."""
    if cfg.family != "vlm":
        return None
    rng = np.random.default_rng(2)
    return (0.02 * rng.standard_normal(
        (C, ROWS, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)


def port(name, tree, tokens):
    """(config, model, float32 params, {"tokens", "labels"} and the VLM's
    "image_embeds")."""
    cfg = port_config(name)
    model = build_model(cfg)
    params = {k: v.float() for k, v in params_from_numpy(tree).items()}
    t = torch.from_numpy(tokens).long()
    batch = {"tokens": t, "labels": t}
    img = images(cfg)
    if img is not None:
        batch["image_embeds"] = torch.from_numpy(img)
    return cfg, model, params, batch


def stream_len(cfg):
    """The prompt's residual stream in serving: the image tokens and SEQ
    text tokens."""
    return SEQ + (cfg.num_image_tokens if cfg.family == "vlm" else 0)


def decode_cache(model, cache, pcache, n):
    """The decode cache from the prefill's ``pcache`` over a stream of
    ``n``: spliced into ``cache`` (allocated for n + STEPS) along the
    sequence axis where the cache has one; a recurrent state as it is
    (torch or jax arrays)."""
    out = {}
    for k, v in pcache.items():
        axes = model.cache_axes()[k]
        if "seq" not in axes:
            out[k] = v
            continue
        idx = (slice(None),) * axes.index("seq") + (slice(0, n),)
        if hasattr(cache[k], "at"):                   # jax
            out[k] = cache[k].at[idx].set(v)
        else:
            out[k] = cache[k].clone()
            out[k][idx] = v
    return out


def make_step(model, uniforms, uplink="ltfl", prune_block=BLOCK, **kw):
    comp = (ltfl_quantizer(uniforms=source(uniforms)) if uplink == "ltfl"
            else "none")
    return make_fl_train_step(model, sgd(LR), C, prune_block=prune_block,
                              compressor=comp, **kw)


def run_rank(rank, port_no, out_dir):
    """Every case's TP step (full updated weights, loss, range sums), and
    client 0's prefill (gathered logits and cache) and STEPS decode steps
    (gathered logits) under the baseline rules, from the inputs that
    ``out_dir``/inputs.pt holds; rank 0 saves them to ``out_dir``/tp.pt."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.models.common import logical_rule_scope
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port_no))
    torch.set_num_threads(1)
    # a file: numpy arguments pickled to each spawned rank cost seconds
    data = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    dist.init_process_group("gloo", rank=rank, world_size=8)
    try:
        mesh = make_test_mesh(device_type="cpu")
        out = {}
        for name, (tree, tokens, steps, uniforms) in data.items():
            cfg, model, params, batch = port(name, tree, tokens)
            base = sh.base_rules(mesh, client_axes=("data",))
            psh = sh.param_shardings(mesh, model, base)
            stacked = sh.stacked_shardings(mesh, model, base, C, "client")
            gather = sh.stacked_shardings(mesh, model, base, C, None)
            bsh = sh.batch_shardings(mesh, base, batch, leading="client")
            dparams = {k: sh.distribute(v, psh[k]) for k, v in params.items()}
            dbatch = {k: sh.distribute(v, bsh[k]) for k, v in batch.items()}
            for layout, uplink in cases(name):
                rules = dryrun_lib._apply_variant_rules(
                    dict(base), LAYOUTS[layout], cfg)
                step = make_step(model, uniforms, uplink, block(name),
                                 param_shardings=stacked,
                                 gather_shardings=gather)
                with logical_rule_scope(rules, mesh):
                    new, _, _, m = step(dparams, (), (), dbatch, controls(),
                                        SEED)
                out[name, layout, uplink] = (
                    {k: v.full_tensor() for k, v in new.items()},
                    {k: m[k] for k in ("loss", "range_sq")})
            local = {k: sh.local_slice(v, psh[k]).contiguous()
                     for k, v in params.items()}
            ctx = tp.context_for(mesh, base)
            n = stream_len(cfg)
            cache = model.init_cache(ROWS, n + STEPS)
            csh = sh.cache_shardings(mesh, base, model, cache)
            with torch.inference_mode(), logical_rule_scope(base, mesh):
                logits, pcache = model.prefill(
                    local, {k: v[0] for k, v in batch.items()
                            if k != "labels"})
                whole = {}
                for k, v in cache.items():
                    # every rank holds all ROWS rows: 'model' splits only
                    # (MLA's latent cache not at all)
                    spec = tuple(None if e == "data" else e
                                 for e in csh[k].spec)
                    cache[k] = sh.local_slice(v, sh.NamedSharding(mesh,
                                                                  spec))
                    whole[k] = (pcache[k] if "model" not in spec else
                                tp.all_gather(pcache[k], ctx,
                                              spec.index("model")
                                              - len(spec)))
                cache = decode_cache(model, cache, pcache, n)
                got = {"prefill": tp.all_gather(logits, ctx, -1),
                       "cache": whole, "decode": []}
                pos = torch.full((ROWS,), n)
                for t in steps:
                    lg, cache = model.decode_step(
                        local, torch.from_numpy(t).long(), pos, cache)
                    got["decode"].append(tp.all_gather(lg, ctx, -1))
                    pos = pos + 1
            out[name, "serve"] = got
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "tp.pt"))
    finally:
        dist.destroy_process_group()
