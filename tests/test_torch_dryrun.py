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
"""
import json
import os
import subprocess
import sys

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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_torch")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    for name, (arch, shape, variant) in PAIRS.items():
        d = out / name
        procs[name] = (d, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--test-mesh", "--variant", variant,
             "--out", str(d)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    done = {}
    for name, (d, p) in procs.items():
        stdout, stderr = p.communicate(timeout=300)
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
    # tileable leaf's 'model' shard where the shards hold whole tiles
    # (all of them at block 64; at 128 the 256-wide leaves split into
    # 64-wide shards, which are gathered and read whole)
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
            cut = any(local[d] % block for d in (-2, -1))
            n = v.numel() if cut else math.prod(local)
            want += n * v.element_size()
            whole += v.numel() * v.element_size()
        assert counter.kernel_reads["block_norms"] == want
        assert want < whole
        assert counter.kernel_reads["apply_block_mask"] > 0
        assert counter.kernel_reads["stochastic_quant"] > 0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("variant", [
    {"act": "seq"}, {"rules_override": {"act_embed": None}},
    {"rules_override": {"act_seq": ["model"], "d_ff": None}}])
def test_activation_variants_raise(variant):
    # the port lays out no activation (no tensor parallelism): these
    # variants would write records equal to the baseline's
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import AbstractMesh
    mesh = AbstractMesh((("data", 2), ("model", 4)))
    with pytest.raises(ValueError, match="tensor parallelism"):
        dryrun_lib._apply_variant_rules(sh.base_rules(mesh), variant)


def test_parameter_rules_override_applies():
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import AbstractMesh
    mesh = AbstractMesh((("data", 2), ("model", 4)))
    rules = dryrun_lib._apply_variant_rules(
        sh.base_rules(mesh), {"rules_override": {"d_ff": None,
                                                 "embed": ["data"]}})
    assert rules["d_ff"] is None and rules["embed"] == ("data",)
