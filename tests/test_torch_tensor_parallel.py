"""Tensor parallelism over 'model' for every language-model family
(``models.tensor_parallel``) on a real (2, 4) mesh of 8 gloo ranks:
clients on 'data', weights on 'model' by the rule table, each rank
computing on its shards. Held against the port's unsharded step and the
reference's unsharded ``make_fl_train_step`` (its own mesh tests fail on
the installed jax, so it runs on one device), on the same weights
(carried across as numpy), batch and quantizer uniforms (the
reference's, rebuilt from the round seed and handed to the port).

Reduced configs (``reduce_for_smoke``, float32, 2 layers, width 256):

* granite-8b with 2 kv heads: its 4 q heads split over 'model', its kv
  heads do not (kv_fused 128 = 4 x 32 cuts each 64-wide head, as 1024 /
  16 = 64 cuts a 128-wide one at full width), so each rank attends its
  q heads against the kv heads cut out of the gathered projections; the
  decode cache splits over head_dim;
* qwen1.5-32b with 6 heads of 32 (QKV bias): no head count divides 4,
  so q, k and v are gathered, attended whole and split before ``wo``
  (as qwen's 40 heads over 16 at full width); its stacked biases are
  pruned by magnitude on their gathered importance;
* olmoe-1b-7b with 8 experts at top 2 (2 a rank) and capacity factor
  0.5, so that a group of 64 tokens drops assignments past its capacity
  of 8 (the test asserts it does): a wrong grouping, such as groups cut
  from the sequence shards of {"act": "seq"}, shows there. Block 8, so
  the router's 2-column shards are pruned by sub-tiles, as the full-width
  router's 4 columns are at block 32;
* deepseek-v2-lite-16b with 8 experts at top 2: MLA over 4 heads (one a
  rank, the latent replicated), a dense prefix layer and one shared
  expert (d_ff on 'model'); its router, not tileable at 64, is pruned by
  magnitude;
* deepseek-v2-lite-16b with 6 heads and 6 experts ("deepseek_cut", the
  sequence layout unquantized, against both unsharded steps, and
  serving): the heads' shards cut heads and the experts do not split
  over 4, the fallbacks;
* phi-3-vision-4.2b ("phi"): the dense blocks (4 heads of 64, one a
  rank) over a stream of 8 image embeddings (seeded, float32; an input)
  ahead of the 16 tokens, 24 rows, which {"act": "seq"} splits 6 a rank
  across the image/text boundary; the loss drops the image rows of each
  rank's vocabulary slice; the decode cache holds the image rows and
  decoding starts at position 24;
* rwkv6-7b ("rwkv"): ``reduce_for_smoke`` gives 8 heads of 32, two a
  rank: each rank runs the recurrence of its heads over the whole
  sequence (every layout), the output norm's sum of squares summed over
  'model', the channel mix's partial sums reduce-scattered onto the
  gate's columns; prefill's cache is the state over the rank's heads and
  the token-shift states as the stream lays them out, and decoding
  continues from it. Block 8, so that u (8 x 32) is pruned by tiles, on
  each rank's 2 heads by sub-tiles of 2 x 8 (as the full-width u, 64 x
  64 at block 32, is on its 4 rows a rank at 'model' 16);
* zamba2-2.7b ("zamba2") at 4 layers, two segments of two Mamba2 layers
  (16 heads of 32, four a rank), so the shared attention block (4 heads
  of 64, one a rank) runs at two sites and its gradient sums over them
  on each rank's shard. in_proj's 1,072 fused columns and the
  convolution's 544 channels split 268 and 136 a rank, which cut across
  z | x | B | C | dt and the heads' 128 channels a rank, as production's
  shards do: the projection and the convolution's output are gathered
  whole as activations, the recurrence runs on the rank's heads, and
  prefill's cache is the rank's heads' state and its convolution
  channels. in_proj and conv_w are pruned by magnitude at block 64, as
  at full width at block 32;
* whisper-medium ("whisper") with a vocabulary of 510, which 4 does not
  divide: the embedding and head are whole and the loss is the whole
  cross-entropy, as for the published 51,865 on 16. The encoder (16
  frames, {"act": "seq"} splitting them 4 a rank) and the decoder (4
  heads, one a rank) each lay out their own stream; cross-attention
  reads the encoder's output, made whole once, and decode the cross
  cache's rank's heads. The reference's encoder takes its frames in
  bfloat16 and its ``lax.scan`` cannot carry the float32 stream that
  float32 layers make of them, so the reference's ``encode`` is run as
  a Python loop over its own layer functions (``_ref_model``) and every
  side is float32.

The routing of the MoE configs has no near-ties on these inputs (each
token's k + 1 largest router probabilities apart by more than 1e-6, on
each client's pruned weights and in serving), so the float32 rounding
of the tensor-parallel sums cannot reorder them.

The step runs with the LTFL quantizer under the baseline layout (the
residual stream split over d_model) and unquantized under all three
layouts: over d_model, over the sequence ({"act": "seq"}) and whole
('act_embed' None); deepseek_cut, zamba2 and whisper run fewer
(``torch_tp_worker.ONLY``, whose comment says why: zamba2 unquantized
only, whisper all but the sequence layout). At block 64 the 32- and 48-wide kv and q shards cut
tiles, so their norms come from sub-tiles. The ranks get their inputs
through a file and run ``torch_tp_worker.run_rank`` (no jax there).

Tolerances (the worst seen in parentheses): the loss and range sums 1e-5
relative (loss 1.5e-7 against the reference, phi; range sums 1.9e-6,
olmoe and rwkv); every updated weight 1e-6 absolute (unquantized
1.2e-7): the reductions over 'model' sum in another order. With the
quantizer that float32 rounding can carry a coordinate across a
stochastic level boundary, so a leaf may have up to 1e-4 of its
coordinates off by a level, each within the leaf's largest update
(seen: 1.5e-5 of a leaf, two coordinates of olmoe's wq; one or two
coordinates of a leaf for phi (wk, wv, wi_up) and rwkv (cm.wk, cm.wr,
cm.wv, tm.wk, tm.wg); none unquantized). The prefill's logits rel 1e-5
(1.3e-6, rwkv) and its bf16 cache within one bf16 ulp on at most 1e-3
of its elements; RWKV6's cache (the float32 state and the token-shift
states, float32 here) rel 1e-5 (9.0e-7); 4 decode steps from it, each
side from its own cache, rel 3e-4 (2.0e-4, deepseek_cut, whose
unsharded decode is as far from the reference's: the bf16 cache; phi
4.6e-5, rwkv 6.4e-6): ``torch_parity``'s bounds. The reference's
prefill and decode step run under ``jax.jit``. zamba2 and whisper (the
worst seen): the loss 7.2e-8 relative to the reference's, unquantized
weights 1.4e-7, the prefill's logits 2.1e-6 and zamba2's float32 states
2.4e-6, decode 3.2e-5. On a 'model' dim of one
rank the step is bitwise the unsharded step, with the quantizer and the
int8 wire format.

Every language model takes the tensor-parallel path; a model without a
family (the edge MLP and ResNet) raises when asked for it.
"""
import math
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

pytest.importorskip("jax")
import jax                                                       # noqa: E402
import jax.numpy as jnp                                          # noqa: E402

from repro.core.ltfl_step import make_fl_train_step as ref_make_step  # noqa
from repro.models import build_model as ref_build_model         # noqa: E402
from repro.optim import sgd as ref_sgd                          # noqa: E402
from repro_torch.core.ltfl_step import make_fl_train_step       # noqa: E402
from repro_torch.models import build_model, params_from_numpy   # noqa: E402
from repro_torch.optim import sgd                               # noqa: E402
from torch_tp_worker import (                                   # noqa: E402
    C, CONFIGS, CONTROLS, LR, ROWS, SEED, SEQ, STEPS, block, cases,
    controls, decode_cache, extra_inputs, make_step, port, port_config,
    reduced, run_rank, source, stream_len)

from torch_parity import (                                      # noqa: E402
    CHAIN_TOL,
    TOL,
    arch_pair,
    as_jax,
    assert_cache_close,
    cache_to_numpy,
    jax_uniforms,
    rel,
    tree_numpy,
)

LOSS_TOL, WEIGHT_TOL, FLIPS = 1e-5, 1e-6, 1e-4
MOE = [n for n in CONFIGS if CONFIGS[n][2]]
TIE_GAP = 1e-6
# blocks at which every weight of two or more dims is pruned by tiles (a
# leaf pruned by magnitude gathers its float32 importance, which an
# all-gather's shape and dtype cannot tell from a float32 router)
GATHER_BLOCK = {"granite": 64, "olmoe": 8, "deepseek": 8, "phi": 64,
                "rwkv": 8, "zamba2": 4, "whisper": 64}
# gathers of the TP step that share their element count and dtype with a
# 'model'-sharded leaf and are not weights: deepseek's float32 tile-norm
# grids of w_gate / w_up and of w_down at block 8 (2,048 values, as many
# as its router), and its residual stream (4 rows x 32 tokens x 64 of
# d_model a rank, bf16, as many values as wo) gathered whole for the MoE
# block's input
NOT_WEIGHTS = {"deepseek": {((128, 16), torch.float32),
                            ((64, 32), torch.float32),
                            ((4, 4, 32, 64), torch.bfloat16)}}


def _weights(cfg):
    """The port's initial weights of ``cfg`` (seed 0) as the reference's
    numpy tree."""
    from repro_torch.models import params_to_numpy
    gen = torch.Generator()
    gen.manual_seed(0)
    return params_to_numpy(build_model(cfg).init(gen))


def _inputs(name):
    """(numpy weights, (C, ROWS, SEQ) tokens, decode tokens, uniforms)."""
    cfg = port_config(name)
    tree = _weights(cfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (C, ROWS, SEQ))
    steps = rng.integers(0, cfg.vocab_size, (STEPS, ROWS))
    shapes = [tuple(v.shape) for v in
              build_model(cfg).abstract_params().values()]
    uniforms = [u.numpy() for u in jax_uniforms(SEED, C, shapes)]
    return tree, tokens, steps, uniforms


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def inputs():
    return {name: _inputs(name) for name in CONFIGS}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    torch.save(inputs, out / "inputs.pt")
    mp.spawn(run_rank, args=(_free_port(), str(out)), nprocs=8, join=True)
    return torch.load(out / "tp.pt")


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _assert_step(got, want, want_loss, want_rsq, old, flips):
    """Loss and range sums within LOSS_TOL relative, every weight within
    WEIGHT_TOL; with the quantizer (``flips``) a leaf may have up to
    FLIPS of its coordinates off by a stochastic level (the reductions'
    float32 rounding crossed a level boundary), each within the leaf's
    largest update."""
    new, m = got
    assert _rel(m["loss"], want_loss) <= LOSS_TOL
    np.testing.assert_allclose(np.asarray(m["range_sq"]), want_rsq,
                               rtol=LOSS_TOL, atol=0)
    for k, v in want.items():
        diff = (new[k] - v).abs()
        off = diff > WEIGHT_TOL
        if flips:
            assert float(off.float().mean()) <= FLIPS, k
            assert bool((diff <= (v - old[k]).abs().max()).all()), k
        else:
            assert not bool(off.any()), (k, float(diff.max()))


def _ref_config(name):
    from repro.configs import get_arch, reduce_for_smoke
    return reduced(reduce_for_smoke(get_arch(CONFIGS[name][0])), name)


def _ref_model(name):
    """The reference's model of ``name``. For the encoder-decoder its
    ``encode`` runs as a Python loop over its own layer functions: its
    ``lax.scan`` cannot carry the float32 stream that float32 layers make
    of the bfloat16 frames. The frames' bfloat16 roundings (the frames and
    positions, their sum, the first norm's output, and the gradients at
    each) are explicit ``lax.reduce_precision`` on float32 values: XLA's
    CPU backend keeps excess precision inside fused bfloat16 ops
    (``torch_parity``), and these roundings it keeps, forward and in the
    gradient, where the port rounds."""
    model = ref_build_model(_ref_config(name))
    if model.cfg.family != "encdec":
        return model
    from repro.models.common import apply_norm
    from repro.models.layers import attention_train, mlp_apply
    cfg = model.cfg

    def bf16(t):
        return jax.lax.reduce_precision(t, exponent_bits=8, mantissa_bits=7)

    def encode(params, frames):
        pos = params["embed"]["pos"][:frames.shape[1]]
        x = bf16(bf16(frames) + bf16(pos)[None])
        for i in range(cfg.encoder_layers):
            lp = jax.tree_util.tree_map(lambda t: t[i], params["encoder"])
            first = bf16 if i == 0 else (lambda t: t)
            h = first(apply_norm(cfg, first(x), lp["ln1"]))
            x = first(x) + attention_train(cfg, lp["attn"], h,
                                           causal=False, rope=False)
            x = x + mlp_apply(cfg, lp["mlp"], apply_norm(cfg, x, lp["ln2"]))
        return apply_norm(cfg, x, params["enc_final_norm"])
    model.encode = encode
    return model


def _ref_batch(name, tokens, labels=False, client=None):
    """The reference's batch of ``tokens`` (and the family's extra
    inputs; with ``client``, that client's rows)."""
    batch = {"tokens": tokens}
    if labels:
        batch["labels"] = tokens
    for k, v in extra_inputs(port_config(name)).items():
        batch[k] = jnp.asarray(v if client is None else v[client],
                               jnp.float32)
    return batch


@pytest.mark.parametrize("name,layout,uplink", [
    (name, layout, uplink) for name in CONFIGS
    for layout, uplink in cases(name)])
def test_tp_step_matches_the_unsharded_step(ranks, inputs, name, layout,
                                            uplink):
    tree, tokens, _, uniforms = inputs[name]
    _, model, params, batch = port(name, tree, tokens)
    new, _, _, m = make_step(model, uniforms, uplink, block(name))(
        params, (), (), batch, controls(), SEED)
    _assert_step(ranks[name, layout, uplink], new, m["loss"],
                 m["range_sq"].numpy(), params, uplink == "ltfl")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_step_matches_the_reference(ranks, inputs, name):
    # each config's first case: the quantized baseline layout, and for
    # the fallbacks' config its sequence layout unquantized
    layout, uplink = cases(name)[0]
    tree, tokens, _, _ = inputs[name]
    _, _, params, _ = port(name, tree, tokens)
    ref_step = jax.jit(ref_make_step(_ref_model(name),
                                     ref_sgd(LR), C,
                                     prune_block=block(name),
                                     quantize=uplink == "ltfl"))
    t = jnp.asarray(tokens, jnp.int32)
    ctl = {k: jnp.asarray(v, jnp.float32) for k, v in CONTROLS.items()}
    rp, _, _, rm = ref_step(as_jax(tree, jnp.float32), (), (),
                            _ref_batch(name, t, labels=True), ctl,
                            jax.random.PRNGKey(SEED))
    want = {k: v.float() for k, v in
            params_from_numpy(tree_numpy(rp)).items()}
    _assert_step(ranks[name, layout, uplink], want, rm["loss"],
                 np.asarray(rm["range_sq"]), params, uplink == "ltfl")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_prefill_and_decode_match_the_reference(ranks, inputs, name):
    tree, tokens, steps, _ = inputs[name]
    cfg = port_config(name)
    ref_model = _ref_model(name)
    rp = as_jax(tree, jnp.float32)
    logits, pcache = jax.jit(ref_model.prefill)(
        rp, _ref_batch(name, jnp.asarray(tokens[0], jnp.int32), client=0))
    got = ranks[name, "serve"]
    assert rel(got["prefill"].numpy(), np.asarray(logits)) <= TOL
    assert sorted(got["cache"]) == sorted(pcache)
    for k, v in pcache.items():
        if v.dtype == jnp.bfloat16:       # k/v entries
            assert_cache_close(cache_to_numpy({k: got["cache"][k]}),
                               cache_to_numpy({k: v}), name)
        else:   # recurrent and token-shift states (float32 here)
            assert rel(got["cache"][k].float().numpy(),
                       np.asarray(v, np.float32)) <= TOL, k
    n = stream_len(cfg)
    cache = decode_cache(build_model(cfg),
                         ref_model.init_cache(ROWS, n + STEPS),
                         pcache, n)
    pos = jnp.full((ROWS,), n, jnp.int32)
    decode = jax.jit(ref_model.decode_step)
    for i, t in enumerate(steps):
        lg, cache = decode(rp, jnp.asarray(t, jnp.int32), pos, cache)
        assert rel(got["decode"][i].numpy(), np.asarray(lg)) <= CHAIN_TOL, \
            (name, i)
        pos = pos + 1


@pytest.mark.parametrize("name", list(GATHER_BLOCK))
def test_no_model_shard_is_gathered_whole(name):
    # the TP step on the test mesh's fake group (meta tensors): no
    # all-gather's output holds a 'model'-sharded weight leaf (or a
    # client stack of them) in its dtype, over any group, but for the
    # gathers NOT_WEIGHTS names, which no leaf's gather could be; the
    # whole-weight path gathers every leaf, which shows the check sees
    # such gathers
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import fake_process_group, make_test_mesh
    from repro_torch.launch.op_analysis import OpCounter
    cfg = port_config(name)
    variant = {"prune_block": GATHER_BLOCK[name]}
    fake_process_group(8)
    try:
        mesh = make_test_mesh(device_type="cpu")
        model = build_model(cfg)
        built = dryrun_lib.build_train(cfg, ShapeConfig("t", 32, 8, "train"),
                                       mesh, variant)
        psh = sh.param_shardings(mesh, model, built.rules)
        leaves, shapes = set(), set()
        for k, v in model.abstract_params().items():
            if "model" in psh[k].spec:
                local = tuple(psh[k].local_shape(tuple(v.shape)))
                for n in (1, C // 2):
                    leaves.add((v.numel() * n, v.dtype))
                    shapes.add(((4 * n,) + local, v.dtype))
                shapes.add(((4 * local[0],) + local[1:], v.dtype))
        assert leaves
        # the exclusions are not the shape of any leaf's gather
        assert not NOT_WEIGHTS.get(name, set()) & shapes
        if name in MOE:          # the experts and the router's columns
            assert all("model" in psh[k].spec for k in psh
                       if k.split(".")[-1] in ("router", "w_gate", "w_up",
                                               "w_down"))

        def whole_gathers(counter):
            return [e for e in counter.coll_log if e["kind"] == "all-gather"
                    and (math.prod(e["shape"]), e["dtype"]) in leaves
                    and (e["shape"], e["dtype"])
                    not in NOT_WEIGHTS.get(name, set())]

        counter = OpCounter(base=built.args_bytes)
        with counter:
            built.fn()
        assert counter.coll_log and not whole_gathers(counter)
        assert counter.coll_kinds["reduce-scatter"] > 0   # the residual
        # the same step on whole weights
        from repro_torch.core import ltfl_step
        real = ltfl_step.make_fl_train_step

        def whole(*a, **kw):
            return real(*a, **dict(kw, tensor_parallel=False))
        ltfl_step.make_fl_train_step = whole
        dryrun_lib.make_fl_train_step = whole
        try:
            built = dryrun_lib.build_train(
                cfg, ShapeConfig("t", 32, 8, "train"), mesh, variant)
            counter = OpCounter(base=built.args_bytes)
            with counter:
                built.fn()
        finally:
            ltfl_step.make_fl_train_step = real
            dryrun_lib.make_fl_train_step = real
        assert whole_gathers(counter)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["granite", "olmoe", "deepseek", "phi",
                                  "rwkv", "zamba2", "whisper"])
def test_one_rank_model_dim_is_the_unsharded_step(inputs, name):
    # a (1, 1) mesh of one gloo rank: the TP path (every family) is
    # bitwise the unsharded step, with the LTFL quantizer and with the
    # int8 wire format
    import torch.distributed as dist

    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    tree, tokens, _, uniforms = inputs[name]
    _, model, params, batch = port(name, tree, tokens)
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        rules = sh.base_rules(mesh, client_axes=("data",))
        psh = sh.param_shardings(mesh, model, rules)
        stacked = sh.stacked_shardings(mesh, model, rules, C, "client")
        bsh = sh.batch_shardings(mesh, rules, batch, leading="client")
        dparams = {k: sh.distribute(v, psh[k]) for k, v in params.items()}
        dbatch = {k: sh.distribute(v, bsh[k]) for k, v in batch.items()}
        for kw in ({}, {"int8_collective": True}):
            def make(**extra):
                if kw:
                    return make_fl_train_step(
                        model, sgd(LR), C, prune_block=block(name),
                        int8_uniforms=source(uniforms), **kw, **extra)
                return make_step(model, uniforms, "ltfl", block(name),
                                 **extra)
            step = make(param_shardings=stacked)
            new, _, _, m = step(dparams, (), (), dbatch, controls(), SEED)
            want, _, _, wm = make()(params, (), (), batch, controls(), SEED)
            assert torch.equal(m["loss"], wm["loss"])
            for k, v in want.items():
                assert torch.equal(new[k].to_local(), v), k
    finally:
        dist.destroy_process_group()


def _routing(monkeypatch, fn):
    """``fn()``'s MoE routing: the least nonzero gap among each token's k
    + 1 largest router probabilities, the tokens with an exact tie (and
    whether each of those gives every expert the same probability), and
    the assignments kept and made."""
    from repro_torch.models import moe
    seen = {"gap": math.inf, "tied": 0, "uniform": True, "kept": 0,
            "made": 0}
    route, masks = moe._route, moe._dispatch_masks

    def recording_route(p, x, k, n_experts):
        probs, top_w, top_i = route(p, x, k, n_experts)
        top = torch.topk(probs, k + 1, dim=-1).values
        gap = top[..., :-1] - top[..., 1:]
        if bool((gap > 0).any()):
            seen["gap"] = min(seen["gap"], float(gap[gap > 0].min()))
        tied = (gap == 0).any(-1)
        seen["tied"] += int(tied.sum())
        spread = probs.amax(-1) - probs.amin(-1)
        seen["uniform"] &= bool((spread[tied] == 0).all())
        return probs, top_w, top_i

    def recording_masks(top_w, top_i, *args):
        dispatch, combine = masks(top_w, top_i, *args)
        seen["kept"] += int(dispatch.sum())
        seen["made"] += top_i.numel()
        return dispatch, combine

    monkeypatch.setattr(moe, "_route", recording_route)
    monkeypatch.setattr(moe, "_dispatch_masks", recording_masks)
    with torch.no_grad():
        fn()
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("name", MOE)
def test_moe_routing_has_no_near_ties(monkeypatch, inputs, name):
    # the routing the TP runs compare: every client's forward on its
    # pruned weights (the step's), the prefill and the decode steps; and
    # olmoe's capacity drops assignments. Exact ties come only from
    # tokens whose input is all zero (every expert alike: a pruned
    # embedding row at a sequence's start), which every side routes by
    # expert index
    from repro_torch.core.pruning import prune_pytree
    from repro_torch.models import params_from_numpy as from_numpy
    tree, tokens, steps, _ = inputs[name]
    cfg, model, params, batch = port(name, tree, tokens)
    pruned, _ = prune_pytree(params, controls()["rho"], block=block(name))
    for c in range(C):
        seen = _routing(monkeypatch, lambda: model.loss(
            {k: v[c] for k, v in pruned.items()},
            {k: v[c] for k, v in batch.items()}))
        assert seen["gap"] > TIE_GAP and seen["uniform"], (name, c, seen)
        if name == "olmoe":
            assert seen["kept"] < seen["made"], "no assignment was dropped"
    serve = build_model(cfg, remat=False)
    whole = {k: v.float() for k, v in from_numpy(tree).items()}

    def prefill_and_decode():
        _, pcache = serve.prefill(whole, {"tokens": batch["tokens"][0]})
        cache = serve.init_cache(ROWS, SEQ + STEPS)
        for k in cache:
            cache[k][:, :, :SEQ] = pcache[k]
        pos = torch.full((ROWS,), SEQ)
        for t in steps:
            _, cache = serve.decode_step(whole, torch.from_numpy(t).long(),
                                         pos, cache)
            pos = pos + 1
    seen = _routing(monkeypatch, prefill_and_decode)
    assert seen["gap"] > TIE_GAP and seen["uniform"], (name, seen)


@pytest.mark.parametrize("name", [
    "granite-8b", "olmoe-1b-7b", "phi-3-vision-4.2b", "rwkv6-7b",
    "zamba2-2.7b", "whisper-medium", "mlp", "resnet"])
def test_every_language_model_takes_the_tp_path(name):
    # the six language-model families compute on their shards by default
    # and when asked; a model without a family (the edge MLP and ResNet)
    # computes whole weights, and asked for shards it raises
    from repro_torch.configs import ResNetConfig, get_arch, reduce_for_smoke
    from repro_torch.core.ltfl_step import _tensor_parallel
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.models.mlp import MLP
    from repro_torch.models.resnet import ResNet
    if name == "mlp":
        model = MLP()
    elif name == "resnet":
        model = ResNet(ResNetConfig(stem_channels=8,
                                    group_channels=(8, 8, 8, 8)))
    else:
        cfg = reduce_for_smoke(get_arch(name))
        assert cfg.family in tp.FAMILIES
        model = build_model(cfg)
        assert _tensor_parallel(model, None) is True
        assert _tensor_parallel(model, True) is True
        assert _tensor_parallel(model, False) is False
        return
    assert _tensor_parallel(model, None) is False
    with pytest.raises(NotImplementedError, match="families"):
        _tensor_parallel(model, True)
