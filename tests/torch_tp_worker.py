"""The rank program of ``test_torch_tensor_parallel.py``: every
language-model family's tensor-parallel step, prefill and decode on one
rank of a (2, 4) gloo mesh (the dense, MoE and VLM decoders, RWKV6, the
Mamba2 hybrid and the encoder-decoder). A module of its own, without
jax, so that each spawned rank imports only the port."""
import dataclasses
import datetime
import os
import time

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
           "rwkv": ("rwkv6-7b", {}, {}),
           # two segments of two Mamba2 layers (16 heads of 32, four a
           # rank), so the shared block runs at two sites
           "zamba2": ("zamba2-2.7b", dict(n_layers=4), {}),
           # a vocabulary that 4 does not divide: whole, as 51,865 is on
           # 'model' 16
           "whisper": ("whisper-medium", dict(vocab_size=510), {})}
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
# the fallbacks' config runs the layout that splits the most. whisper's
# frames are bfloat16, so the gradient of its encoder input is rounded to
# bfloat16 on every side, at the same ops: its float32 inputs differ by
# the order of the ranks' partial sums, so 10 of the 16,384 elements of
# client 0's frames' gradient land 1-2 bfloat16 ulps apart under
# {"act": "seq"} (16 under the d_model layout; tools/tp_grad_noise.py
# whisper --layout seq) and one embed.pos coordinate 1.2e-6 off, past the
# 1e-6 the others meet. Only the unsharded order of those sums (the first
# block's wq, wk and wv whole on every rank) would round them alike, so
# whisper runs the other layouts
ONLY = {"deepseek_cut": [("seq", "none")],
        "whisper": [("d_model", "ltfl"), ("d_model", "none"),
                    ("whole", "none")]}
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


def extra_inputs(cfg):
    """The batch's inputs besides the tokens (float32, seeded): the VLM's
    (C, ROWS, num_image_tokens, d_model) "image_embeds", the
    encoder-decoder's (C, ROWS, encoder_seq, d_model) "frames"."""
    if cfg.family == "vlm":
        rng = np.random.default_rng(2)
        return {"image_embeds": (0.02 * rng.standard_normal(
            (C, ROWS, cfg.num_image_tokens, cfg.d_model))
        ).astype(np.float32)}
    if cfg.family == "encdec":
        rng = np.random.default_rng(3)
        return {"frames": (0.02 * rng.standard_normal(
            (C, ROWS, cfg.encoder_seq, cfg.d_model))).astype(np.float32)}
    return {}


def port(name, tree, tokens):
    """(config, model, float32 params, {"tokens", "labels"} and the
    family's ``extra_inputs``)."""
    cfg = port_config(name)
    model = build_model(cfg)
    params = {k: v.float() for k, v in params_from_numpy(tree).items()}
    t = torch.from_numpy(tokens).long()
    batch = {"tokens": t, "labels": t}
    batch.update({k: torch.from_numpy(v)
                  for k, v in extra_inputs(cfg).items()})
    return cfg, model, params, batch


def vocab_whole(cfg, logits, ctx):
    """Logits over the whole vocabulary: a vocab-parallel slice gathered
    over the 'model' dim of ``ctx``, whole ones as they are."""
    from repro_torch.models import tensor_parallel as tp
    if logits.shape[-1] == cfg.vocab_size:
        return logits
    return tp.all_gather(logits, ctx, -1)


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


def wait_for(path, timeout=300):
    """``path``, once it exists (its writer renames it into place whole),
    waiting at most ``timeout`` seconds."""
    deadline = time.time() + timeout
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)
    return path


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
    # a file: numpy arguments pickled to each spawned rank cost seconds;
    # the ranks start while the test still computes it
    data = torch.load(wait_for(os.path.join(out_dir, "inputs.pt")),
                      weights_only=False)
    dist.init_process_group("gloo", rank=rank, world_size=8,
                            timeout=datetime.timedelta(seconds=300))
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
                    dict(base), LAYOUTS[layout])
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
                got = {"prefill": vocab_whole(cfg, logits, ctx),
                       "cache": whole, "decode": []}
                pos = torch.full((ROWS,), n)
                for t in steps:
                    lg, cache = model.decode_step(
                        local, torch.from_numpy(t).long(), pos, cache)
                    got["decode"].append(vocab_whole(cfg, lg, ctx))
                    pos = pos + 1
            out[name, "serve"] = got
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "tp.pt"))
    finally:
        dist.destroy_process_group()
