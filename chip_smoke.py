#!/usr/bin/env python3
"""Card check for the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py                # needs one CUDA card and nvcc
    python3 chip_smoke.py --profile DIR  # also writes a torch.profiler
                                         # table of one main-path round to
                                         # DIR/profile_round.txt

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
   graph (the device time, reported as ``ms``).

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
KERNELS = ["stochastic_quant"]          # csrc/<name>.cu of the main path
C = 30                                  # clients (U) on the main path
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
    """A torch.profiler table of one more round, by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.time()
        runner.run_round(3)
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
    (out_dir / "profile_round.txt").write_text(table)
    if spans:
        log(f"[profile] round wall {wall!r} s (profiler on), "
            f"{len(spans)} device events, device busy {busy_us / 1e6!r} s,"
            f" idle share {1.0 - busy_us / 1e6 / wall!r}")
    else:
        log("[profile] no device events recorded: idle share not measured")
    log("[profile] top of the device-time table:")
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
    log(f"[done] {time.time() - t_start:.1f} s")

    kernels = [{
        "name": "stochastic_quant",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stochastic_quant.cu",
        "replaces": "src/repro/kernels/stochastic_quant.py:58",
        "launches": launches,
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
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
