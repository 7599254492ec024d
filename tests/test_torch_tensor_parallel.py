"""Tensor parallelism over 'model' for the dense decoder family
(``models.tensor_parallel``) on a real (2, 4) mesh of 8 gloo ranks:
clients on 'data', weights on 'model' by the rule table, each rank
computing on its shards. Held against the port's unsharded step and the
reference's unsharded ``make_fl_train_step`` (its own mesh tests fail on
the installed jax, so it runs on one device), on the same weights
(carried across as numpy), batch and quantizer uniforms (the
reference's, rebuilt from the round seed and handed to the port).

Two reduced configs (``reduce_for_smoke``, float32, 2 layers, width 256):

* granite-8b with 2 kv heads: its 4 q heads split over 'model', its kv
  heads do not (kv_fused 128 = 4 x 32 cuts each 64-wide head, as 1024 /
  16 = 64 cuts a 128-wide one at full width), so each rank attends its
  q heads against the kv heads cut out of the gathered projections; the
  decode cache splits over head_dim;
* qwen1.5-32b with 6 heads of 32 (QKV bias): no head count divides 4,
  so q, k and v are gathered, attended whole and split before ``wo``
  (as qwen's 40 heads over 16 at full width); its stacked biases are
  pruned by magnitude on their gathered importance.

The step runs with the LTFL quantizer under the baseline layout (the
residual stream split over d_model) and unquantized under all three
layouts: over d_model, over the sequence ({"act": "seq"}) and whole
('act_embed' None). At block 64 the 32- and 48-wide kv and q shards cut
tiles, so their norms come from sub-tiles. The ranks get their inputs
through a file and run ``torch_tp_worker.run_rank`` (no jax there).

Tolerances (the worst seen in parentheses): the loss and range sums 1e-5
relative (loss 0 against the port, 7.2e-8 against the reference); every
updated weight 1e-6 absolute (6.0e-8): the reductions over 'model' sum
in another order. With the quantizer that float32 rounding can carry a
coordinate across a stochastic level boundary, so a leaf may have up to
1e-4 of its coordinates off by a level, each within the leaf's largest
update (seen: one coordinate in a leaf, against both the port and the
reference; none unquantized). The prefill's logits rel 1e-5 (9.4e-7) and
its bf16 cache within one bf16 ulp on at most 1e-3 of its elements; 4
decode steps from it, each side from its own cache, rel 3e-4 (4.1e-5):
``torch_parity``'s bounds. On a 'model' dim of one rank the step is
bitwise the unsharded step, with the quantizer and the int8 wire format.
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
    BLOCK, C, CASES, CONFIGS, CONTROLS, LR, ROWS, SEED, SEQ, STEPS,
    controls, make_step, port, port_config, run_rank, source)

from torch_parity import (                                      # noqa: E402
    CHAIN_TOL,
    TOL,
    arch_pair,
    as_jax,
    assert_cache_close,
    cache_to_numpy,
    decoder_weights,
    jax_uniforms,
    rel,
    tree_numpy,
)

LOSS_TOL, WEIGHT_TOL, FLIPS = 1e-5, 1e-6, 1e-4


def _inputs(name):
    """(numpy weights, (C, ROWS, SEQ) tokens, decode tokens, uniforms)."""
    cfg = port_config(name)
    tree = decoder_weights(cfg, seed=0)
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


@pytest.mark.parametrize("layout,uplink", CASES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_step_matches_the_unsharded_step(ranks, inputs, name, layout,
                                            uplink):
    tree, tokens, _, uniforms = inputs[name]
    _, model, params, batch = port(name, tree, tokens)
    new, _, _, m = make_step(model, uniforms, uplink)(
        params, (), (), batch, controls(), SEED)
    _assert_step(ranks[name, layout, uplink], new, m["loss"],
                 m["range_sq"].numpy(), params, uplink == "ltfl")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_step_matches_the_reference(ranks, inputs, name):
    uplink = "ltfl"
    tree, tokens, _, _ = inputs[name]
    _, _, params, _ = port(name, tree, tokens)
    ref_cfg, _ = arch_pair(CONFIGS[name][0], **CONFIGS[name][1])
    ref_step = jax.jit(ref_make_step(ref_build_model(ref_cfg), ref_sgd(LR),
                                     C, prune_block=BLOCK,
                                     quantize=uplink == "ltfl"))
    t = jnp.asarray(tokens, jnp.int32)
    ctl = {k: jnp.asarray(v, jnp.float32) for k, v in CONTROLS.items()}
    rp, _, _, rm = ref_step(as_jax(tree, jnp.float32), (), (),
                            {"tokens": t, "labels": t}, ctl,
                            jax.random.PRNGKey(SEED))
    want = {k: v.float() for k, v in
            params_from_numpy(tree_numpy(rp)).items()}
    _assert_step(ranks[name, "d_model", uplink], want, rm["loss"],
                 np.asarray(rm["range_sq"]), params, uplink == "ltfl")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_prefill_and_decode_match_the_reference(ranks, inputs, name):
    tree, tokens, steps, _ = inputs[name]
    ref_cfg, _ = arch_pair(CONFIGS[name][0], **CONFIGS[name][1])
    ref_model = ref_build_model(ref_cfg)
    rp = as_jax(tree, jnp.float32)
    logits, pcache = ref_model.prefill(
        rp, {"tokens": jnp.asarray(tokens[0], jnp.int32)})
    got = ranks[name, "serve"]
    assert rel(got["prefill"].numpy(), np.asarray(logits)) <= TOL
    assert_cache_close(cache_to_numpy(got["cache"]),
                       cache_to_numpy(pcache), name)
    cache = ref_model.init_cache(ROWS, SEQ + STEPS)
    cache = {k: v.at[:, :, :SEQ].set(pcache[k]) for k, v in cache.items()}
    pos = jnp.full((ROWS,), SEQ, jnp.int32)
    for i, t in enumerate(steps):
        lg, cache = ref_model.decode_step(rp, jnp.asarray(t, jnp.int32), pos,
                                          cache)
        assert rel(got["decode"][i].numpy(), np.asarray(lg)) <= CHAIN_TOL, \
            (name, i)
        pos = pos + 1


def test_no_model_shard_is_gathered_whole():
    # the TP step on the test mesh's fake group (meta tensors): no
    # all-gather's output holds a 'model'-sharded weight leaf (or a
    # client stack of them) in its dtype; the whole-weight path gathers
    # every one, which shows the check sees such gathers
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import fake_process_group, make_test_mesh
    from repro_torch.launch.op_analysis import OpCounter
    cfg = port_config("granite")
    fake_process_group(8)
    try:
        mesh = make_test_mesh(device_type="cpu")
        model = build_model(cfg)
        built = dryrun_lib.build_train(cfg, ShapeConfig("t", 32, 8, "train"),
                                       mesh, {"prune_block": BLOCK})
        psh = sh.param_shardings(mesh, model, built.rules)
        leaves = {(v.numel() * n, v.dtype)
                  for k, v in model.abstract_params().items()
                  if "model" in psh[k].spec for n in (1, C // 2)}
        assert leaves

        def whole_gathers(counter):
            return [e for e in counter.coll_log if e["kind"] == "all-gather"
                    and (math.prod(e["shape"]), e["dtype"]) in leaves]

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
                cfg, ShapeConfig("t", 32, 8, "train"), mesh,
                {"prune_block": BLOCK})
            counter = OpCounter(base=built.args_bytes)
            with counter:
                built.fn()
        finally:
            ltfl_step.make_fl_train_step = real
            dryrun_lib.make_fl_train_step = real
        assert whole_gathers(counter)
    finally:
        dist.destroy_process_group()


def test_one_rank_model_dim_is_the_unsharded_step(inputs):
    # a (1, 1) mesh of one gloo rank: the TP path (dense family) is bitwise
    # the unsharded step, with the LTFL quantizer and with the int8 wire
    import torch.distributed as dist

    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    tree, tokens, _, uniforms = inputs["granite"]
    _, model, params, batch = port("granite", tree, tokens)
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
                        model, sgd(LR), C, prune_block=BLOCK,
                        int8_uniforms=source(uniforms), **kw, **extra)
                return make_step(model, uniforms, **extra)
            new, _, _, m = make(param_shardings=stacked)(
                dparams, (), (), dbatch, controls(), SEED)
            want, _, _, wm = make()(params, (), (), batch, controls(), SEED)
            assert torch.equal(m["loss"], wm["loss"])
            for k, v in want.items():
                assert torch.equal(new[k].to_local(), v), k
    finally:
        dist.destroy_process_group()
