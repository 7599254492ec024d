"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the
8-rank test mesh, each pair in its own process (one fake process group a
process), the processes run side by side.

granite-8b x train_4k on (2, 4) is held to the committed reference
record (artifacts/dryrun/granite-8b__train_4k__data2xmodel4__baseline.json):
the client count, the analytic model FLOPs, and the inputs one device
holds -- the parameters (its ``alias_bytes``), the batch (tokens and
labels, int32, (2, 128, 4096) over 'data': 4,194,304 bytes) and 40 bytes
of controls and seed (its ``args_bytes``). The reference's CI pairs that
fail on its installed jax complete here (granite-8b x decode_32k,
whisper-medium x prefill_32k, and train_4k as a scanned segment of 2
rounds with about twice the single round's FLOPs), and its documented
skip prints SKIP and exits 0. No jax is imported.

Every family computes on its 'model' shards (tensor parallelism): the
activation variants ({"act": "seq"}, 'act_*' overrides) lay out the
residual stream and give records of their own; the encoder-decoder's
encoder stream is laid out from its own shape (whisper-medium's 1,500
frames split over 4 under {"act": "seq"}, and stay whole over 16).
granite-8b x train_4k under {"act": "seq"} peaks below the whole-weight
step's record for the same pair (391,199,604,656 bytes a device, the
port's dry run before tensor parallelism), and so does
deepseek-v2-lite-16b x train_4k (412,236,220,148 bytes).

The recurrent families' train_4k (4,096 steps a layer, counted from four
of them: tests/test_torch_dryrun_scan.py) finish within 120 s each:
rwkv6-7b under {"act": "seq"} (tensor parallel over heads, the sequence
gathered whole for the recurrence) and zamba2-2.7b (tensor parallel over
the Mamba2 heads and the shared block's).
"""
import json
import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(REPO, "artifacts", "dryrun",
                      "granite-8b__train_4k__data2xmodel4__baseline.json")
PAIRS = {
    "train": ("granite-8b", "train_4k", "{}"),
    "scan": ("granite-8b", "train_4k", '{"scan": 2}'),
    "decode": ("granite-8b", "decode_32k", "{}"),
    "prefill": ("whisper-medium", "prefill_32k", "{}"),
    "skip": ("qwen1.5-32b", "long_500k", "{}"),
}
# the activation variants (the reference's perf-pass overrides)
VARIANTS = [{"act": "seq"}, {"rules_override": {"act_embed": None}},
            {"rules_override": {"act_seq": ["model"], "d_ff": None}}]
for _i, _v in enumerate(VARIANTS):
    PAIRS[f"act{_i}"] = ("granite-8b", "train_4k", json.dumps(_v))
PAIRS["moe"] = ("deepseek-v2-lite-16b", "train_4k", json.dumps(VARIANTS[0]))
# the recurrent families' train_4k, each within its own TIMEOUT
PAIRS["rwkv_seq"] = ("rwkv6-7b", "train_4k", json.dumps(VARIANTS[0]))
PAIRS["zamba2"] = ("zamba2-2.7b", "train_4k", "{}")
TIMEOUT = {"rwkv_seq": 120, "zamba2": 120}
# train_4k on (2, 4), the port's step on whole weights
WHOLE_WEIGHT_PEAK = 391199604656
MOE_WHOLE_WEIGHT_PEAK = 412236220148              # deepseek-v2-lite-16b


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_torch")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    start = time.time()
    for name, (arch, shape, variant) in PAIRS.items():
        d = out / name
        procs[name] = (d, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--test-mesh", "--variant", variant,
             "--out", str(d)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    done = {}
    for name, (d, p) in procs.items():
        try:
            stdout, stderr = p.communicate(
                timeout=max(TIMEOUT.get(name, 300) - (time.time() - start),
                            0))
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
            stderr += f"\n{name}: past its {TIMEOUT.get(name, 300)} s"
        files = sorted(d.glob("*.json")) if d.exists() else []
        done[name] = (p.returncode, stdout, stderr,
                      [json.loads(f.read_text()) for f in files])
    return done


def _ok(run):
    rc, stdout, stderr, records = run
    assert rc == 0, stderr[-3000:]
    assert "dry-run complete" in stdout
    return records


def test_train_matches_the_reference_record(runs):
    (rec,) = _ok(runs["train"])
    with open(RECORD) as f:
        ref = json.load(f)
    assert rec["n_clients"] == ref["n_clients"] == 2
    assert rec["model_flops"] == ref["model_flops"] == 6491516650389504
    assert rec["alias_bytes"] == ref["alias_bytes"] == 4127793152
    assert rec["args_bytes"] == ref["args_bytes"] == 4131987496
    assert rec["args_bytes"] - rec["alias_bytes"] - 40 == 4194304
    assert rec["mesh"] == "data2xmodel4" and rec["mode"] == "train"
    assert rec["flops_per_device"] > rec["model_flops"] > 0
    assert rec["collective_count"] > 0 and rec["collective_wire_bytes"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")


def test_scanned_segment_scales_flops(runs):
    (rec,) = _ok(runs["scan"])
    (one,) = _ok(runs["train"])
    assert rec["variant"] == {"scan": 2}
    assert 1.8 <= rec["flops_per_device"] / one["flops_per_device"] <= 2.2


@pytest.mark.parametrize("name", ["decode", "prefill"])
def test_ci_pairs_complete(runs, name):
    (rec,) = _ok(runs[name])
    assert rec["mode"] == name
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0


def test_documented_skip(runs):
    rc, stdout, _, records = runs["skip"]
    assert rc == 0
    assert "SKIP" in stdout and not records


@pytest.mark.parametrize("block", [64, 128])
def test_pruning_kernels_run_on_shards(block):
    # reduced granite-8b on the (2, 4) test mesh: block_norms reads each
    # tileable leaf's 'model' shard, at whole tiles where the shards hold
    # them (all of them at block 64) and at sub-tiles as wide as a shard
    # where they cut tiles (at 128 the 256-wide leaves split into 64-wide
    # shards); no leaf is read whole
    import math

    import torch.distributed as dist

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.pruning import tileable
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import fake_process_group, make_test_mesh
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.models import build_model
    fake_process_group(8)
    try:
        mesh = make_test_mesh(device_type="cpu")
        arch = reduce_for_smoke(get_arch("granite-8b"))
        built = dryrun_lib.build_train(arch, ShapeConfig("t", 32, 8, "train"),
                                       mesh, {"prune_block": block})
        counter = OpCounter(base=built.args_bytes)
        with counter:
            built.fn()
        model = build_model(arch)
        psh = sh.param_shardings(mesh, model, built.rules)
        want = whole = 0
        for k, v in model.abstract_params().items():
            if not tileable(v, block):
                continue
            local = psh[k].local_shape(tuple(v.shape))
            want += math.prod(local) * v.element_size()
            whole += v.numel() * v.element_size()
        assert counter.kernel_reads["block_norms"] == want
        assert want < whole
        assert counter.kernel_reads["apply_block_mask"] > 0
        assert counter.kernel_reads["stochastic_quant"] > 0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("i", range(len(VARIANTS)))
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b"])
def test_activation_variants_lay_out_the_moe_family(arch, i):
    # the MoE family's variants resolve to rules that move the residual
    # stream's split (over the sequence, or none) and keep the experts,
    # the router's columns and the heads on 'model'
    from repro_torch import configs
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import build_model
    from repro_torch.models.tensor_parallel import TPContext
    mesh = AbstractMesh((("data", 2), ("model", 4)))
    cfg = configs.get_arch(arch)
    base = sh.base_rules(mesh)
    rules = dryrun_lib._apply_variant_rules(dict(base), VARIANTS[i])
    changed = {k for k in rules if rules[k] != base[k]}
    assert changed == [{"act_seq", "act_embed"}, {"act_embed"},
                       {"act_seq", "d_ff"}][i]

    def split(r):
        ctx = TPContext(mesh, 1, 0, 4, r)
        return ctx.on_model((4096, cfg.d_model), ("act_seq", "act_embed"))
    assert split(base) == -1                     # d_model, the baseline
    assert split(rules) == [-2, None, -2][i]     # the sequence, or whole
    psh = sh.param_shardings(mesh, build_model(cfg), rules)
    for k, s in psh.items():
        if k.split(".")[-1] in ("router", "w_gate", "w_up", "w_down", "wq",
                                "w_uk", "w_uv"):
            assert "model" in s.spec, (k, s.spec)


@pytest.mark.parametrize("i", range(len(VARIANTS)))
@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "rwkv6-7b"])
def test_activation_variants_lay_out_the_vlm_and_rwkv_families(arch, i):
    # the VLM's and RWKV6's variants resolve to rules that move the
    # residual stream's split (over the sequence, or none) and keep the
    # heads (and RWKV6's channel-mix d_ff where the variant leaves it)
    # on 'model'
    from repro_torch import configs
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import build_model
    from repro_torch.models.tensor_parallel import TPContext
    mesh = AbstractMesh((("data", 2), ("model", 4)))
    cfg = configs.get_arch(arch)
    base = sh.base_rules(mesh)
    rules = dryrun_lib._apply_variant_rules(dict(base), VARIANTS[i])
    changed = {k for k in rules if rules[k] != base[k]}
    assert changed == [{"act_seq", "act_embed"}, {"act_embed"},
                       {"act_seq", "d_ff"}][i]

    def split(r):
        ctx = TPContext(mesh, 1, 0, 4, r)
        return ctx.on_model((4096, cfg.d_model), ("act_seq", "act_embed"))
    assert split(base) == -1
    assert split(rules) == [-2, None, -2][i]
    psh = sh.param_shardings(mesh, build_model(cfg), rules)
    heads = ("wq", "wk", "wv") if cfg.family == "vlm" else \
        ("wr", "wk", "wv", "wg", "u")
    for k, s in psh.items():
        if k.startswith(("layers.attn.", "layers.tm.")) \
                and k.split(".")[-1] in heads:
            assert "model" in s.spec, (k, s.spec)
        if k == "layers.cm.wv":
            assert ("model" in s.spec) == (i != 2), (k, s.spec)


@pytest.mark.parametrize("i", range(len(VARIANTS)))
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-medium"])
def test_activation_variants_lay_out_the_hybrid_and_encdec_families(arch,
                                                                      i):
    # the hybrid's and the encoder-decoder's variants resolve to rules
    # that move the residual stream's split and keep the heads (and the
    # Mamba2 layers' fused columns, channels and rows) on 'model'; the
    # encoder's stream of 1,500 frames is laid out from its own shape:
    # over the sequence on 'model' 4 (375 a rank), whole on 16 under
    # {"act": "seq"} (1,500 does not divide), back on d_model where
    # 'act_embed' keeps 'model'
    from repro_torch import configs
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import build_model
    from repro_torch.models.tensor_parallel import TPContext
    cfg = configs.get_arch(arch)
    for size, enc in ((4, [-2, None, -2]), (16, [None, None, -1])):
        mesh = AbstractMesh((("data", 2), ("model", size)))
        base = sh.base_rules(mesh)
        rules = dryrun_lib._apply_variant_rules(dict(base), VARIANTS[i])
        changed = {k for k in rules if rules[k] != base[k]}
        assert changed == [{"act_seq", "act_embed"}, {"act_embed"},
                           {"act_seq", "d_ff"}][i]

        def split(r, seq):
            ctx = TPContext(mesh, 1, 0, size, r)
            return ctx.on_model((seq, cfg.d_model), ("act_seq", "act_embed"))
        assert split(base, 4096) == -1
        assert split(rules, 4096) == [-2, None, -2][i]
        if cfg.family == "encdec":
            assert split(base, cfg.encoder_seq) == -1
            assert split(rules, cfg.encoder_seq) == enc[i]
    psh = sh.param_shardings(mesh, build_model(cfg), rules)
    for k, s in psh.items():
        if k.split(".")[-2] in ("attn", "self_attn", "cross_attn", "mamba"):
            assert "model" in s.spec, (k, s.spec)


@pytest.mark.parametrize("name", ["rwkv_seq", "zamba2"])
def test_recurrent_train_pairs_finish(runs, name):
    # C1: the step-by-step recurrences of train_4k, counted from four
    # steps a scan, finish on the test mesh within their timeouts
    (rec,) = _ok(runs[name])
    arch, shape, variant = PAIRS[name]
    assert rec["arch"] == arch and rec["mode"] == "train"
    assert rec["variant"] == json.loads(variant) and rec["n_clients"] == 2
    assert rec["flops_per_device"] > rec["model_flops"] > 0
    assert rec["bytes_per_device"] > rec["args_bytes"] > 0
    assert rec["compile_seconds"] < TIMEOUT[name]
    assert rec["collective_count"] > 0        # tensor parallel over heads


def test_moe_dry_run_peaks_below_the_whole_weight_record(runs):
    (rec,) = _ok(runs["moe"])
    assert rec["arch"] == "deepseek-v2-lite-16b" and rec["mode"] == "train"
    assert rec["variant"] == VARIANTS[0] and rec["n_clients"] == 2
    assert 0 < rec["bytes_per_device"] < MOE_WHOLE_WEIGHT_PEAK
    assert rec["collective_count"] > 0


@pytest.mark.parametrize("i", range(len(VARIANTS)))
def test_activation_variants_lay_out_the_dense_family(runs, i):
    from repro_torch import configs
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import AbstractMesh
    mesh = AbstractMesh((("data", 2), ("model", 4)))
    arch = configs.get_arch("granite-8b")
    base = sh.base_rules(mesh)
    rules = dryrun_lib._apply_variant_rules(dict(base), VARIANTS[i])
    assert rules != base
    (rec,) = _ok(runs[f"act{i}"])
    (one,) = _ok(runs["train"])
    assert rec["variant"] == VARIANTS[i]
    keys = ("bytes_per_device", "flops_per_device", "hbm_bytes_per_device",
            "collective_wire_bytes", "collective_count")
    assert any(rec[k] != one[k] for k in keys), rec
    if i == 0:                                   # {"act": "seq"}
        assert rec["bytes_per_device"] < WHOLE_WEIGHT_PEAK
        assert rec["bytes_per_device"] < one["bytes_per_device"]


def test_parameter_rules_override_applies():
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import AbstractMesh
    mesh = AbstractMesh((("data", 2), ("model", 4)))
    rules = dryrun_lib._apply_variant_rules(
        sh.base_rules(mesh), {"rules_override": {"d_ff": None,
                                                 "embed": ["data"]}})
    assert rules["d_ff"] is None and rules["embed"] == ("data",)
