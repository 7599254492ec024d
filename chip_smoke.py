#!/usr/bin/env python3
"""Card check for the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py                # needs one CUDA card and nvcc
    python3 chip_smoke.py --profile DIR  # also writes torch.profiler
                                         # tables (see the end of this list)

Phases; any failure exits non-zero before the result lines:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every hand-written kernel from the sources in this checkout (one
   nvcc per source, started together), with ptxas' register report;
3. kernel vs plain version: the quantizer at all 32 leaf shapes of the
   paper-width ResNet x 30 clients, float32 and bfloat16, mixed per-client
   bits (1, 2, 4, 8), the same uniforms; float32 must agree exactly,
   bfloat16 to within one quantization step on < 1e-3 of the elements;
4. small reference: one round step at width 8, 4 clients, on the card and
   on the CPU (plain version) with the same injected uniforms — loss and
   the updated weights must agree (float32 tolerance, rare one-step flips);
5. main path: ``FedRunner`` + ``LTFLScheme`` on the card at the paper's
   full width (ResNetConfig() defaults, 4,901,450 parameters), U = 30
   devices, per-device batch 50, synthetic CIFAR of 20,000 images, eval
   on, 3 rounds; every loss finite and the quantizer launched exactly
   once per leaf per round (32), counted from 0 just before the run;
6. timing: the kernel and its plain version with CUDA events, at the
   largest leaf (30 x 2,359,296) and over all 32 leaves of a round, the
   latter both launched from Python (eager) and replayed from a CUDA
   graph (the device time, reported as ``ms``);
7. block kernels vs plain versions: ``block_norms`` and
   ``apply_block_mask`` at all 9 tileable leaf shapes of granite-8b's
   full widths (2 layers), float32 and bfloat16, blocks 32/64/128, C = 4
   per-client masks (rho 0.25/0.1/0.5/0.9): the norms, the tile masks
   ranked from them, the masked weights (one shared w) and the gated
   stacked gradients must all be bitwise equal (compared as integers,
   so the sign of zero counts);
8. small datacenter reference: one block-pruned step of granite-8b at
   ``reduce_for_smoke`` widths on the card (kernels) and on the CPU
   (plain versions) with the same weights, batch and injected draws:
   tile masks equal; in float32 the loss and the updated weights agree
   within phase 4's tolerances, in bfloat16 within the parity tests'
   (tests/test_torch_datacenter.py);
9. datacenter main path: ``repro_torch.launch.train.run_datacenter`` on
   granite-8b at its published widths with the depth cut to 2 layers
   (838,881,280 parameters, bf16), the launcher's defaults (4 clients x
   batch 2 x seq 128, rho 0.25, delta 8, drop 0.05, block 32, lr 0.05),
   3 steps: every loss finite and, counted from 0 just before the run,
   per step 9 ``block_norms``, 18 ``apply_block_mask`` (9 for the
   weights, 9 for the gradient gate) and 12 ``stochastic_quant``
   launches; step times and the peak device memory are printed;
10. timing: each block kernel, its plain version and the one-call
   PyTorch equivalent (``library_ms``) with CUDA events, at the largest
   leaf (embed.tok, 49152 x 4096) and over a step's 9 leaves, eager and
   graph-replayed, beside the bound (bytes over 3.35 TB/s).

``--profile DIR`` also writes torch.profiler tables of one edge round
(``DIR/profile_round.txt``) and one datacenter step
(``DIR/profile_step.txt``).

The last three lines are the ``kernels`` JSON, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"
KERNELS = ["stochastic_quant", "block_prune"]   # csrc/<name>.cu, built
C = 30                                  # clients (U) on the edge main path
DC_CLIENTS = 4                          # clients on the datacenter path
DC_LAYERS = 2                           # granite-8b's 36 layers cut to 2
DC_STEPS = 3
DC_RHO = (0.25, 0.1, 0.5, 0.9)          # per-client cuts in phases 7, 10
HBM_BYTES_PER_S = 3.35e12               # H100 SXM, published, 700 W
F32_FLOPS = 67e12                       # H100 SXM non-tensor-core float32
QUANT_FLOPS_PER_ELEM = 10               # abs, sub, div, floor, sub, cmp,
                                        # add, clip (2), mul-add (2)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls, CUDA events."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean ms per replay of ``fn`` captured in a CUDA graph: the
    device time of its launches without the host's per-launch cost."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def leaf_shapes():
    from repro_torch.models import ResNet
    return {k: s.shape for k, s in ResNet().param_specs().items()}


def make_batch(shapes, dtype, seed):
    """Per leaf: g (C, L), rand (C, L), rng (C, 3) on the card, with the
    per-client bits cycling 1, 2, 4, 8."""
    import torch
    from repro_torch.kernels.ops import level_counts
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    bits = torch.tensor([1.0, 2.0, 4.0, 8.0], device="cuda").repeat(
        C // 4 + 1)[:C]
    out = []
    for shape in shapes.values():
        n = math.prod(shape)
        g = (torch.randn(C, n, generator=gen, device="cuda") * 0.01).to(dtype)
        rand = torch.rand(C, n, generator=gen, device="cuda")
        a = g.to(torch.float32).abs()
        rng = torch.stack([a.amin(1), a.amax(1), level_counts(bits)], 1)
        out.append((g, rand, rng.contiguous()))
    return out


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.time()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        results = list(pool.map(build.build, KERNELS))
    for name, (lib, text) in zip(KERNELS, results):
        log(f"[build] {name}: {lib.name}")
        for line in text.splitlines():
            if "ptxas" in line and ("registers" in line or "Compiling" in line
                                    or "spill" in line):
                log(f"[build]   {line.strip()}")
        build.load(name)
    log(f"[build] {len(KERNELS)} kernel(s) in {time.time() - t0:.1f} s")


def phase_kernel_vs_plain(shapes) -> float:
    import torch
    from repro_torch.kernels.ref import stochastic_quant_ref
    from repro_torch.kernels.stochastic_quant import stochastic_quant
    max_err_f32 = None
    for dtype in (torch.float32, torch.bfloat16):
        worst, mism, total = 0.0, 0, 0
        for (g, rand, rng), name in zip(make_batch(shapes, dtype, seed=1),
                                        shapes):
            out = stochastic_quant(g, rand, rng)
            ref = stochastic_quant_ref(g, rand, rng)
            torch.cuda.synchronize()
            diff = (out.to(torch.float32) - ref.to(torch.float32)).abs()
            step = ((rng[:, 1] - rng[:, 0]) / rng[:, 2])[:, None]
            worst = max(worst, float(diff.max()))
            mism += int((diff > 0).sum())
            total += diff.numel()
            if dtype == torch.float32 and float(diff.max()) != 0.0:
                fail(f"f32 kernel != plain at {name}: max "
                     f"{float(diff.max())}")
            if dtype == torch.bfloat16 and bool(
                    (diff > step * 1.01 + 1e-30).any()):
                fail(f"bf16 kernel off by more than one step at {name}")
        frac = mism / total
        log(f"[check] {str(dtype)[6:]}: 32 leaves x {C} clients, "
            f"{total} elements: max_abs_err={worst!r} "
            f"mismatch_fraction={frac!r}")
        if frac >= 1e-3:
            fail(f"{dtype}: mismatch fraction {frac} >= 1e-3")
        if dtype == torch.float32:
            max_err_f32 = worst
    return max_err_f32


def phase_small_reference() -> None:
    """One step at width 8, U = 4 on the card and on the CPU, same
    weights, data, controls and uniforms."""
    import numpy as np
    import torch
    from repro_torch.configs import ResNetConfig
    from repro_torch.core.compressors import ltfl_quantizer
    from repro_torch.core.ltfl_step import make_fl_train_step
    from repro_torch.data import synthetic_cifar
    from repro_torch.models import ResNet
    from repro_torch.optim import sgd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n_clients, batch = 4, 8
    model = ResNet(ResNetConfig(stem_channels=8,
                                group_channels=(8, 16, 32, 64)))
    gen = torch.Generator()
    gen.manual_seed(3)
    params = model.init(gen)
    imgs, labels = synthetic_cifar(n_clients * batch, seed=3)
    batch_np = {"images": imgs.reshape(n_clients, batch, 32, 32, 3),
                "labels": labels.reshape(n_clients, batch)}
    controls_np = {"rho": np.array([0.0, 0.2, 0.4, 0.5], np.float32),
                   "delta": np.array([8.0, 4.0, 2.0, 1.0], np.float32),
                   "weights": np.array([400, 450, 500, 550], np.float32),
                   "alpha": np.array([1, 1, 0, 1], np.float32)}

    def cpu_uniforms(seed, nc, shapes):
        g = torch.Generator()
        g.manual_seed(seed)
        return [torch.rand((nc,) + tuple(s), generator=g) for s in shapes]

    results = {}
    for dev in ("cpu", "cuda"):
        step = make_fl_train_step(model, sgd(0.05), n_clients,
                                  prune_kind="magnitude",
                                  compressor=ltfl_quantizer(
                                      uniforms=cpu_uniforms))
        p, _, _, m = step(
            {k: v.to(dev) for k, v in params.items()}, (), (),
            {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()},
            {k: torch.from_numpy(v).to(dev) for k, v in controls_np.items()},
            7)
        results[dev] = ({k: v.cpu() for k, v in p.items()}, float(m["loss"]))
    (pc, lc), (pg, lg) = results["cpu"], results["cuda"]
    if not math.isclose(lc, lg, rel_tol=1e-4):
        fail(f"small reference: loss cpu {lc} vs cuda {lg}")
    worst = 0.0
    for k, v0 in params.items():
        uc, ug = (pc[k] - v0) / 0.05, (pg[k] - v0) / 0.05
        scale = float(uc.abs().max()) + 1e-12
        off = float(((ug - uc).abs() > 1e-3 * scale).float().mean())
        worst = max(worst, off)
        if off >= 1e-3 or float((ug - uc).abs().max()) > scale:
            fail(f"small reference: update of {k} differs "
                 f"(fraction {off})")
    log(f"[reference] width-8 step, cpu vs cuda: loss {lc!r} vs {lg!r}, "
        f"worst off-fraction {worst!r}")


def phase_main_path(profile_dir):
    import numpy as np
    import torch
    from repro_torch.configs import LTFLConfig, ResNetConfig
    from repro_torch.data import ArrayDataset, synthetic_cifar
    from repro_torch.fed import FedRunner, LTFLScheme
    from repro_torch.kernels.stochastic_quant import LAUNCHES
    from repro_torch.models import ResNet

    t0 = time.time()
    imgs, labels = synthetic_cifar(20000, seed=0)
    timgs, tlabels = synthetic_cifar(2000, seed=1)
    train = ArrayDataset({"images": imgs, "labels": labels})
    test = ArrayDataset({"images": timgs, "labels": tlabels})
    model = ResNet(ResNetConfig())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    n_leaves = len(params)
    log(f"[main] data + init {time.time() - t0:.1f} s: {n_leaves} leaves, "
        f"{sum(p.numel() for p in params.values())} parameters")

    LAUNCHES["stochastic_quant"] = 0
    torch.cuda.reset_peak_memory_stats()
    runner = FedRunner(model, params, LTFLConfig(), train, test,
                       LTFLScheme(), batch_size=50, seed=0, eval_every=1,
                       device="cuda")
    # where a round's wall time goes: the step call and the eval, each
    # timed to a synchronize (the rest is host work: Algorithm 1, the
    # batch gather and upload, accounting)
    spent = {"step": 0.0, "eval": 0.0}

    def timed(key, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.time()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += time.time() - t
            return out
        return call

    runner._step = timed("step", runner._step)
    runner.evaluate = timed("eval", runner.evaluate)
    rounds = []
    for rnd in range(3):
        before = LAUNCHES["stochastic_quant"]
        spent.update(step=0.0, eval=0.0)
        torch.cuda.synchronize()
        t = time.time()
        rec = runner.run_round(rnd)
        torch.cuda.synchronize()
        wall = time.time() - t
        launched = LAUNCHES["stochastic_quant"] - before
        log(f"[main] round {rnd}: loss={rec.train_loss!r} "
            f"acc={rec.test_acc!r} delay={rec.delay!r}s "
            f"energy={rec.energy!r}J received={rec.received}/{C} "
            f"gamma={rec.gamma!r} rho_mean={rec.rho_mean!r} "
            f"delta_mean={rec.delta_mean!r} wall={wall!r}s "
            f"step={spent['step']!r}s eval={spent['eval']!r}s "
            f"host={wall - spent['step'] - spent['eval']!r}s "
            f"quant_launches={launched}")
        if not math.isfinite(rec.train_loss):
            fail(f"round {rnd}: loss {rec.train_loss}")
        if launched != n_leaves:
            fail(f"round {rnd}: {launched} quantizer launches, want "
                 f"{n_leaves}")
        rounds.append(wall)
    launches = LAUNCHES["stochastic_quant"]
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] 3 rounds: launches={launches} round_wall_s={rounds} "
        f"max_memory_allocated={peak} bytes")
    if launches != 3 * n_leaves:
        fail(f"main path launched the quantizer {launches} times")
    if not all(np.isfinite(v.detach().cpu().numpy()).all()
               for v in runner.params.values()):
        fail("non-finite weights after 3 rounds")
    if profile_dir is not None:
        profile_round(runner, profile_dir)
    return launches


def profile_round(runner, out_dir: Path) -> None:
    """A torch.profiler table of one more edge round, by device time."""
    profile_call(lambda: runner.run_round(3), out_dir / "profile_round.txt",
                 "round")


def profile_call(fn, out_file: Path, label: str) -> None:
    """Run ``fn`` once under torch.profiler; write the device-time table
    to ``out_file`` and print the wall time, the device busy time and the
    idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out_file.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t
    # device busy time: the union of the device-side events' intervals
    # (microseconds on the host's clock), so nothing is counted twice
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy_us += e - s
            end = e
        elif e > end:
            busy_us += e - end
            end = e
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    out_file.write_text(table)
    if spans:
        log(f"[profile] {label} wall {wall!r} s (profiler on), "
            f"{len(spans)} device events, device busy {busy_us / 1e6!r} s,"
            f" idle share {1.0 - busy_us / 1e6 / wall!r}")
    else:
        log(f"[profile] {label}: no device events recorded: idle share "
            "not measured")
    log(f"[profile] top of the {label}'s device-time table:")
    for line in table.splitlines()[:16]:
        log(f"[profile] {line}")


def phase_timing(shapes):
    import torch
    from repro_torch.kernels.ref import stochastic_quant_ref
    from repro_torch.kernels.stochastic_quant import stochastic_quant
    leaves = make_batch(shapes, torch.float32, seed=2)
    big = max(range(len(leaves)), key=lambda i: leaves[i][0].numel())
    g, rand, rng = leaves[big]

    def all_kernel():
        for g_, r_, q_ in leaves:
            stochastic_quant(g_, r_, q_)

    def all_plain():
        for g_, r_, q_ in leaves:
            stochastic_quant_ref(g_, r_, q_)

    res = {
        "largest_kernel_ms": cuda_ms(lambda: stochastic_quant(g, rand, rng),
                                     20),
        "largest_plain_ms": cuda_ms(
            lambda: stochastic_quant_ref(g, rand, rng), 10),
        # eager: 32 launches from Python, host launch cost included
        "round_kernel_eager_ms": cuda_ms(all_kernel, 10),
        "round_plain_eager_ms": cuda_ms(all_plain, 5),
        # the same launches replayed from a CUDA graph: device time
        "round_kernel_ms": graph_ms(all_kernel, 20),
        "round_plain_ms": graph_ms(all_plain, 10),
    }
    # the least time for the same work: each input read once, each output
    # written once (g 4 B, rand 4 B, out 4 B per element + 12 B per client
    # range row), or ~10 float32 operations per element, whichever is more
    elems_big = g.numel()
    elems_all = sum(x[0].numel() for x in leaves)

    def bound(elems, rows):
        t_bytes = (elems * 12 + rows * 12) / HBM_BYTES_PER_S * 1e3
        t_ops = elems * QUANT_FLOPS_PER_ELEM / F32_FLOPS * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    res["largest_bound_ms"], _ = bound(elems_big, C)
    res["round_bound_ms"], res["bound_by"] = bound(elems_all,
                                                   C * len(leaves))
    res["round_elements"] = elems_all
    res["largest_elements"] = elems_big
    for k in ("largest", "round"):
        res[f"{k}_achieved_GBps"] = (res[f"{k}_elements"] * 12
                                     / (res[f"{k}_kernel_ms"] * 1e-3) / 1e9)
    log(f"[timing] {json.dumps(res)}")
    return res


def bits(x):
    """A float tensor as its integer bit pattern (the sign of zero counts)."""
    import torch
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def dc_arch():
    """granite-8b at its published widths, depth cut to DC_LAYERS."""
    from repro_torch.configs import get_arch
    return get_arch("granite-8b").replace(n_layers=DC_LAYERS)


def dc_matrices(block: int = 32):
    """The tileable leaves of the full-width config as the (rows, N)
    matrices the block kernels see (leading dims collapsed), by name."""
    import torch
    from repro_torch.core.pruning import tileable
    from repro_torch.models import DecoderLM
    out = {}
    for name, spec in DecoderLM(dc_arch()).param_specs().items():
        if tileable(torch.empty(spec.shape, device="meta"), block):
            out[name] = (math.prod(spec.shape[:-1]), spec.shape[-1])
    return out


def phase_block_vs_plain(mats):
    """Both block kernels against their plain versions, bitwise, at every
    tileable leaf shape, f32 and bf16, blocks 32/64/128, C per-client
    masks. Returns the largest |difference| of the norms and of the
    masked outputs (0.0 when bitwise)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_prune import apply_block_mask, block_norms
    from repro_torch.kernels.ref import apply_block_mask_ref, block_norms_ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    rho = torch.tensor(DC_RHO, device="cuda")
    worst, worst_mask, tiles = 0.0, 0.0, 0

    def max_diff(a, b):
        return float((_f32(a) - _f32(b)).abs().max())

    for dtype in (torch.float32, torch.bfloat16):
        for name, (m, n) in mats.items():
            w = (torch.randn(m, n, generator=gen, device="cuda")
                 * 0.02).to(dtype)
            w.view(-1)[::9973] = -0.0
            g = (torch.randn(DC_CLIENTS, m, n, generator=gen, device="cuda")
                 * 1e-3).to(dtype)
            for b in (32, 64, 128):
                where = f"{name} {(m, n)} {str(dtype)[6:]} block {b}"
                norms = block_norms(w, (b, b))
                ref = block_norms_ref(w, b, b)
                torch.cuda.synchronize()
                worst = max(worst, float((norms - ref).abs().max()))
                if not torch.equal(bits(norms), bits(ref)):
                    fail(f"block_norms != plain at {where}")
                tiles += norms.numel()
                pruned, mask = ops.block_prune_2d(w, rho, (b, b))
                ref_mask = ops.rank_mask(ref, rho)
                torch.cuda.synchronize()
                if not torch.equal(mask, ref_mask):
                    fail(f"tile masks differ at {where}")
                ref_pruned = apply_block_mask_ref(w, ref_mask, b, b)
                worst_mask = max(worst_mask, max_diff(pruned, ref_pruned))
                if not torch.equal(bits(pruned), bits(ref_pruned)):
                    fail(f"apply_block_mask (weights) != plain at {where}")
                del pruned, ref_pruned
                gated = apply_block_mask(g, mask, (b, b))
                ref_gated = apply_block_mask_ref(g, mask, b, b)
                worst_mask = max(worst_mask, max_diff(gated, ref_gated))
                if not torch.equal(bits(gated), bits(ref_gated)):
                    fail(f"apply_block_mask (gradients) != plain at {where}")
                del gated, ref_gated
            del w, g
    torch.cuda.empty_cache()
    log(f"[check] block kernels: {len(mats)} leaf shapes x f32/bf16 x "
        f"blocks 32/64/128, {tiles} tiles, C = {DC_CLIENTS}: norms, masks, "
        f"masked weights and gated gradients bitwise equal "
        f"(max norm difference {worst!r}, max masked-output difference "
        f"{worst_mask!r})")
    return worst, worst_mask


def _f32(t):
    import torch
    return t.to(torch.float32)


def _bf16_ulp(x):
    """One bf16 ulp at |x|, as float32."""
    import torch
    a = x.abs().to(torch.bfloat16)
    return _f32(torch.nextafter(a, torch.full_like(a, float("inf")))) \
        - _f32(a)


def phase_small_datacenter() -> None:
    """One block-pruned step at reduce_for_smoke widths on the card and on
    the CPU: same weights, batch, controls, uniforms and drop draw."""
    import torch
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.core.compressors import ltfl_quantizer
    from repro_torch.core.ltfl_step import make_fl_train_step
    from repro_torch.core.pruning import prune_pytree
    from repro_torch.models import build_model, make_train_batch
    from repro_torch.optim import sgd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    arch = reduce_for_smoke(get_arch("granite-8b"))
    model = build_model(arch)
    gen = torch.Generator()
    gen.manual_seed(3)
    init = {k: _f32(v) for k, v in model.init(gen).items()}
    batch = {k: v.reshape(DC_CLIENTS, 2, 64) for k, v in
             make_train_batch(arch, DC_CLIENTS * 2, 64, gen).items()}
    controls = {"rho": [0.25, 0.1, 0.5, 0.25], "delta": [8.0, 8.0, 4.0, 2.0],
                "drop_prob": [0.05, 0.05, 0.6, 0.3],
                "weights": [500.0, 450.0, 520.0, 610.0]}
    controls = {k: torch.tensor(v) for k, v in controls.items()}

    def cpu_uniforms(seed, nc, shapes):
        g = torch.Generator()
        g.manual_seed(seed)
        return [torch.rand((nc,) + tuple(s), generator=g) for s in shapes]

    def cpu_drops(seed, nc):
        g = torch.Generator()
        g.manual_seed(seed + 1)
        return torch.rand((nc,), generator=g)

    lr = 0.05
    for dtype in (torch.float32, torch.bfloat16):
        out = {}
        for dev in ("cpu", "cuda"):
            step = make_fl_train_step(
                model, sgd(lr), DC_CLIENTS, prune_block=32,
                prune_kind="block",
                compressor=ltfl_quantizer(uniforms=cpu_uniforms),
                drop_uniforms=cpu_drops)
            p = {k: v.to(dev, dtype) for k, v in init.items()}
            _, masks = prune_pytree(p, controls["rho"].to(dev), block=32)
            p1, _, _, m = step(p, (), (),
                               {k: v.to(dev) for k, v in batch.items()},
                               {k: v.to(dev) for k, v in controls.items()},
                               7)
            out[dev] = ({k: v.cpu() for k, v in p1.items()},
                        {k: v.cpu() for k, v in masks.items()},
                        float(m["loss"]), float(m["clients_received"]))
        (pc, mc, lc, rc), (pg, mg, lg, rg) = out["cpu"], out["cuda"]
        name = str(dtype)[6:]
        for k in mc:
            if not torch.equal(mc[k], mg[k]):
                fail(f"small datacenter {name}: masks of {k} differ")
        if rc != rg:
            fail(f"small datacenter {name}: received {rc} vs {rg}")
        loss_tol = 1e-4 if dtype == torch.float32 else 1e-3
        if not math.isclose(lc, lg, rel_tol=loss_tol):
            fail(f"small datacenter {name}: loss cpu {lc} vs cuda {lg}")
        worst = 0.0
        for k, v0 in init.items():
            v0 = _f32(v0.to(dtype))
            new_c, new_g = _f32(pc[k]), _f32(pg[k])
            if dtype == torch.float32:      # phase 4's tolerances
                uc, ug = (new_c - v0) / lr, (new_g - v0) / lr
                scale = float(uc.abs().max()) + 1e-12
                off = float(((ug - uc).abs() > 1e-3 * scale).float().mean())
                bad = off >= 1e-3 or float((ug - uc).abs().max()) > scale
            else:                           # tests/test_torch_datacenter.py
                diff = (new_g - new_c).abs()
                ulp = _bf16_ulp(new_c)
                off = float((diff > ulp).float().mean())
                bad = off > 0.05 or bool(
                    (diff > (new_c - v0).abs().max() + ulp).any())
            worst = max(worst, off)
            if bad:
                fail(f"small datacenter {name}: update of {k} differs "
                     f"(fraction {off})")
        log(f"[reference] datacenter step at smoke widths, {name}, cpu vs "
            f"cuda: masks equal, received {rc!r}, loss {lc!r} vs {lg!r}, "
            f"worst off-fraction {worst!r}")


def phase_datacenter(profile_dir):
    """The datacenter main path at full widths through the launcher's
    function; launch counts per step, step times, peak memory."""
    import torch
    from repro_torch.kernels import block_prune, stochastic_quant
    from repro_torch.launch import train

    arch = dc_arch()
    args = train.build_parser().parse_args(["--steps", str(DC_STEPS)])
    counters = (block_prune.LAUNCHES, stochastic_quant.LAUNCHES)
    want = {"block_norms": 9, "apply_block_mask": 18,
            "stochastic_quant": 12}

    def counts():
        return {k: v for c in counters for k, v in c.items()}

    log(f"[datacenter] granite-8b at its published widths (d_model "
        f"{arch.d_model}, {arch.n_heads} heads, {arch.n_kv_heads} KV heads, "
        f"d_ff {arch.d_ff}, vocab {arch.vocab_size}), depth cut 36 -> "
        f"{arch.n_layers} layers")
    per_step = []
    last = {}

    def on_step(i, m):
        now = counts()
        per_step.append({k: now[k] - last.get(k, 0) for k in now})
        last.update(now)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        for k in c:
            c[k] = 0
    t0 = time.time()
    run, records = train.run_datacenter(arch, args, "cuda", on_step=on_step)
    wall = time.time() - t0
    total = counts()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(v.numel() for v in run.params.values())
    for i, (m, got) in enumerate(zip(records, per_step)):
        log(f"[datacenter] step {i}: loss={m['loss']!r} "
            f"grad_norm={m['grad_norm']!r} "
            f"received={m['clients_received']!r} "
            f"step_s={m['seconds']!r} launches={got}")
        if not math.isfinite(m["loss"]):
            fail(f"datacenter step {i}: loss {m['loss']}")
        if {k: got[k] for k in want} != want:
            fail(f"datacenter step {i}: launches {got}, want {want}")
    log(f"[datacenter] {n_params} parameters, {len(records)} steps in "
        f"{wall!r} s (set-up included), step_s="
        f"{[m['seconds'] for m in records]}, max_memory_allocated={peak} "
        f"bytes, launches={total}")
    if n_params != 838_881_280:
        fail(f"full-width 2-layer granite-8b has {n_params} parameters")
    if not all(bool(torch.isfinite(v).all()) for v in run.params.values()):
        fail("non-finite weights after the datacenter steps")
    if profile_dir is not None:
        profile_call(lambda: run.step(DC_STEPS),
                     profile_dir / "profile_step.txt", "datacenter step")
    del run
    torch.cuda.empty_cache()
    return total, peak, records


def _bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_block_timing(mats, block: int = 32):
    """CUDA-event times of both block kernels, their plain versions and
    one-call PyTorch equivalents on bf16 leaves at the main path's shapes
    and block, C per-client masks: the largest leaf and a whole step's
    leaves (eager and graph-replayed)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_prune import apply_block_mask, block_norms
    from repro_torch.kernels.ref import apply_block_mask_ref, block_norms_ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    rho = torch.tensor(DC_RHO, device="cuda")
    c, b = DC_CLIENTS, block
    ws = {k: (torch.randn(m, n, generator=gen, device="cuda")
              * 0.02).to(torch.bfloat16) for k, (m, n) in mats.items()}
    masks = {k: ops.rank_mask(block_norms_ref(w, b, b), rho)
             for k, w in ws.items()}
    big = "embed.tok"

    def views(w):
        m, n = w.shape[-2:]
        return m // b, n // b

    def lib_norms(w):
        tr, tc = views(w)
        return torch.linalg.vector_norm(w.view(tr, b, tc, b), dim=(1, 3),
                                        dtype=torch.float32)

    def lib_mask(w, mask):
        tr, tc = views(w)
        lead = w.shape[:-2] if w.dim() == 3 else (1,)
        return torch.mul(w.view(*lead, tr, b, tc, b),
                         mask.view(c, tr, 1, tc, 1))

    fns = {
        "norms": (lambda w, m: block_norms(w, (b, b)),
                  lambda w, m: block_norms_ref(w, b, b),
                  lambda w, m: lib_norms(w)),
        "mask": (lambda w, m: apply_block_mask(w, m, (b, b)),
                 lambda w, m: apply_block_mask_ref(w, m, b, b),
                 lib_mask),
    }
    res = {}

    def time_all(tag, kind, inputs, big_inputs):
        kern, plain, lib = fns[kind]
        for label, fn in (("kernel", kern), ("plain", plain),
                          ("library", lib)):
            res[f"{tag}_largest_{label}_ms"] = cuda_ms(
                lambda: fn(*big_inputs), 10)

            def step_all():
                for x, m in inputs:
                    fn(x, m)

            res[f"{tag}_step_{label}_eager_ms"] = cuda_ms(step_all, 5)
            res[f"{tag}_step_{label}_ms"] = graph_ms(step_all, 10)
            torch.cuda.empty_cache()

    # the library calls compute the same functions (norms summed in
    # float32 in another order: rel 1e-5, as tests/test_kernels.py)
    w, m = ws[big], masks[big]
    if not torch.allclose(lib_norms(w), block_norms_ref(w, b, b),
                          rtol=1e-5, atol=0.0):
        fail("library norms differ from the plain version")
    if not torch.equal(bits(lib_mask(w, m).reshape(c, *w.shape)),
                       bits(apply_block_mask_ref(w, m, b, b))):
        fail("library masking differs from the plain version")
    pairs = [(ws[k], masks[k]) for k in ws]
    time_all("norms", "norms", pairs, (ws[big], masks[big]))
    time_all("mask", "mask", pairs, (ws[big], masks[big]))
    elems = {k: w.numel() for k, w in ws.items()}
    tiles = {k: m[0].numel() for k, m in masks.items()}
    n_all, t_all = sum(elems.values()), sum(tiles.values())
    # block_norms: read w once (2 B/elem), write 4 B a tile; 2 ops an
    # element (square, add), counted at the float32 rate
    res["norms_step_bound_ms"], res["norms_bound_by"] = _bound(
        2 * n_all + 4 * t_all, 2 * n_all)
    res["norms_largest_bound_ms"], _ = _bound(
        2 * elems[big] + 4 * tiles[big], 2 * elems[big])
    # masking the shared weights: read w once, write C copies, read C
    # masks (1 B a tile); one multiply per output element
    res["mask_step_bound_ms"], res["mask_bound_by"] = _bound(
        2 * (1 + c) * n_all + c * t_all, c * n_all)
    res["mask_largest_bound_ms"], _ = _bound(
        2 * (1 + c) * elems[big] + c * tiles[big], c * elems[big])
    del ws
    torch.cuda.empty_cache()
    # gating the stacked gradients: read and write C copies
    gs = {k: (torch.randn(c, m, n, generator=gen, device="cuda")
              * 1e-3).to(torch.bfloat16) for k, (m, n) in mats.items()}
    time_all("gate", "mask", [(gs[k], masks[k]) for k in gs],
             (gs[big], masks[big]))
    res["gate_step_bound_ms"], res["gate_bound_by"] = _bound(
        4 * c * n_all + c * t_all, c * n_all)
    res["gate_largest_bound_ms"], _ = _bound(
        4 * c * elems[big] + c * tiles[big], c * elems[big])
    res["step_elements"], res["largest_elements"] = n_all, elems[big]
    del gs
    torch.cuda.empty_cache()
    log(f"[timing] block kernels (bf16, block {b}, C = {c}): "
        f"{json.dumps(res)}")
    return res


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(SRC))
    args = sys.argv[1:]
    profile_dir = None
    if "--profile" in args:
        i = args.index("--profile")
        if i + 1 >= len(args):
            fail("--profile needs a directory")
        profile_dir = Path(args[i + 1]).resolve()

    t_start = time.time()
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")

    phase_build()
    shapes = leaf_shapes()
    if len(shapes) != 32:
        fail(f"paper-width ResNet has {len(shapes)} leaves, want 32")
    max_err = phase_kernel_vs_plain(shapes)
    phase_small_reference()
    launches = phase_main_path(profile_dir)
    t = phase_timing(shapes)
    mats = dc_matrices()
    if len(mats) != 9:
        fail(f"full-width granite-8b has {len(mats)} tileable leaves, "
             "want 9")
    norm_err, mask_err = phase_block_vs_plain(mats)
    phase_small_datacenter()
    dc_launches, _, _ = phase_datacenter(profile_dir)
    bt = phase_block_timing(mats)
    log(f"[done] {time.time() - t_start:.1f} s")

    def block_row(name, key, launches, err, extra):
        return {
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/block_prune.cu",
            "replaces": {"block_norms": "src/repro/kernels/block_prune.py:31",
                         "apply_block_mask":
                         "src/repro/kernels/block_prune.py:52"}[name],
            "launches": launches,
            "max_abs_err": err,
            "ms": bt[f"{key}_step_kernel_ms"],
            "plain_ms": bt[f"{key}_step_plain_ms"],
            "bound_ms": bt[f"{key}_step_bound_ms"],
            "bound_by": bt[f"{key}_bound_by"],
            "library_ms": bt[f"{key}_step_library_ms"],
            "eager_ms": bt[f"{key}_step_kernel_eager_ms"],
            "plain_eager_ms": bt[f"{key}_step_plain_eager_ms"],
            "library_eager_ms": bt[f"{key}_step_library_eager_ms"],
            "largest_leaf_ms": bt[f"{key}_largest_kernel_ms"],
            "largest_leaf_plain_ms": bt[f"{key}_largest_plain_ms"],
            "largest_leaf_library_ms": bt[f"{key}_largest_library_ms"],
            "largest_leaf_bound_ms": bt[f"{key}_largest_bound_ms"],
            **extra,
        }

    kernels = [{
        "name": "stochastic_quant",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stochastic_quant.cu",
        "replaces": "src/repro/kernels/stochastic_quant.py:59",
        "launches": launches,
        "datacenter_launches": dc_launches["stochastic_quant"],
        "max_abs_err": max_err,
        "max_abs_err_vs_plain": max_err,
        "ms": t["round_kernel_ms"],
        "kernel_ms": t["round_kernel_ms"],
        "plain_ms": t["round_plain_ms"],
        "bound_ms": t["round_bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "largest_leaf_ms": t["largest_kernel_ms"],
        "largest_leaf_plain_ms": t["largest_plain_ms"],
        "largest_leaf_bound_ms": t["largest_bound_ms"],
        "eager_ms": t["round_kernel_eager_ms"],
        "plain_eager_ms": t["round_plain_eager_ms"],
    }, block_row("block_norms", "norms", dc_launches["block_norms"],
                 norm_err, {}),
        block_row("apply_block_mask", "mask",
                  dc_launches["apply_block_mask"], mask_err, {
                      "gate_ms": bt["gate_step_kernel_ms"],
                      "gate_plain_ms": bt["gate_step_plain_ms"],
                      "gate_library_ms": bt["gate_step_library_ms"],
                      "gate_bound_ms": bt["gate_step_bound_ms"],
                      "gate_eager_ms": bt["gate_step_kernel_eager_ms"],
                      "gate_largest_leaf_ms":
                          bt["gate_largest_kernel_ms"],
                  })]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
