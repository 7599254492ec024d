"""The LTFL step on a language model at published widths (the port's
datacenter path: ``repro_torch.core.ltfl_step.make_fl_train_step`` with
block pruning, the B1 quantizer and in-step packet drops, SGD).

Set-up builds one step, draws the weights and a pool of distinct
batches on the device from the seed, and drives the step through its
first three steps (batches 0, 1, 2 of the pool): these are the steps the
output check follows, and they warm up every shape the window uses. The
window then calls the same step on the pool's batches in turn (step i
takes batch i mod pool and seed ``step_seed(seed, i)``) for ``--seconds``
and counts every token of every step it completed.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Tuple

import torch

from ltflbench import compare, counts, harness
from ltflbench import trace as tracing
from ltflbench.refs import lm, ltfl

MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "rope_theta")
POOL_STREAM = 1 << 62
CHECK_STEPS = 3


class Datacenter:
    """The cell's inputs, made from the seed: weights, batches, controls,
    per-step seeds; and its counts."""

    def __init__(self, cell: dict, seed: int, device: torch.device):
        from repro_torch.configs import get_arch
        cf, p = cell["config_file"], cell["params"]
        self.cfg = {k: cf[k] for k in MODEL_KEYS}
        self.arch = get_arch(cf["arch"]).replace(**self.cfg)
        self.dtype = getattr(torch, cf["dtype"])
        self.p, self.seed, self.device = p, int(seed), device
        c, b, s = p["clients"], p["per_client_batch"], p["seq_len"]
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed + POOL_STREAM)
        self.pool = torch.randint(0, cf["vocab_size"], (p["pool"], c, b, s),
                                  generator=gen, device=device)

        def full(v):
            return torch.full((c,), float(v), dtype=torch.float32,
                              device=device)

        self.controls = {"rho": full(p["rho"]), "delta": full(p["delta"]),
                         "drop_prob": full(p["drop_prob"]),
                         "weights": full(p["weights"])}
        self.spec = lm.spec(self.cfg)

    def weights(self) -> harness.Tree:
        return harness.make_weights(self.spec, self.seed, self.dtype,
                                    self.device)

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        t = self.pool[i % self.p["pool"]]
        return {"tokens": t, "labels": t}

    def seed_of(self, i: int) -> int:
        return harness.step_seed(self.seed, i)

    @property
    def tokens_per_step(self) -> int:
        p = self.p
        return p["clients"] * p["per_client_batch"] * p["seq_len"]

    def flops_per_step(self) -> float:
        c, p = self.cfg, self.p
        return counts.lm_train_flops(
            c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"],
            c["d_ff"], c["n_layers"], c["vocab_size"],
            p["clients"] * p["per_client_batch"], p["seq_len"])

    def bytes_per_step(self) -> Tuple[float, float]:
        """(B1's bytes, B2 and B3's bytes) a step."""
        b, c = self.p["prune_block"], self.p["clients"]
        elem = torch.finfo(self.dtype).bits // 8
        sizes = [math.prod(s) for s, _ in self.spec.values()]
        tileable = [math.prod(s) for s, _ in self.spec.values()
                    if len(s) >= 2 and s[-2] % b == 0 and s[-1] % b == 0]
        return (counts.quant_bytes(sizes, c, elem),
                counts.prune_bytes(tileable, c, elem, b))


class Program:
    """The port's step, built as the reference launcher builds it, and
    its state; the optimizer records the norms of the gradient it takes
    while ``record`` is set."""

    def __init__(self, dc: Datacenter):
        from repro_torch.core.ltfl_step import make_fl_train_step
        from repro_torch.models import build_model
        from repro_torch.optim import sgd
        from repro_torch.optim.optimizers import Optimizer
        if dc.device.type == "cuda":
            # as the launcher sets it: bf16 products accumulate in f32
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = False
        self.model = build_model(dc.arch)
        shapes = {k: tuple(v.shape)
                  for k, v in self.model.abstract_params().items()}
        if shapes != {k: s for k, (s, _) in dc.spec.items()}:
            raise ValueError(f"the program's leaves {shapes} are not the "
                             "reference's")
        base = sgd(dc.p["lr"])
        self.record, self.recorded = False, None

        def update(grads, state, params):
            if self.record:
                self.recorded = harness.leaf_norms(grads)
                self.record = False
            return base.update(grads, state, params)

        self.opt = Optimizer(base.init, update, base.update_with_lr)
        self.step = make_fl_train_step(self.model, self.opt, dc.p["clients"],
                                       prune_block=dc.p["prune_block"],
                                       prune_kind="block")
        self.dc = dc
        self.state = None

    def start(self, params: harness.Tree) -> dict:
        """Steps 0-2 from ``params``; returns their readings (tensors)."""
        self.state = (params, self.opt.init(params),
                      self.step.init_comp_state(params))
        losses = []
        self.record = True
        for i in range(CHECK_STEPS):
            losses.append(self.advance(i))
        return {"loss": losses, "grad": self.recorded,
                "change": harness.change_norms(self.state[0], params)}

    def advance(self, i: int) -> torch.Tensor:
        dc = self.dc
        p, o, c, m = self.step(*self.state, dc.batch(i), dc.controls,
                               dc.seed_of(i))
        self.state = (p, o, c)
        return m["loss"]


def reference_readings(dc: Datacenter, fp8: bool = False) -> dict:
    """The plain reference over steps 0-2 from freshly drawn weights."""
    params = dc.weights()
    cur, losses, grad = params, [], None
    for i in range(CHECK_STEPS):
        b = dc.batch(i)
        batches = [{k: v[c] for k, v in b.items()}
                   for c in range(dc.p["clients"])]
        cur, loss, agg = ltfl.step(
            cur, batches, dc.controls, dc.seed_of(i), dc.p["lr"],
            lambda w, x: lm.loss(w, x, dc.cfg, fp8), "block",
            dc.p["prune_block"])
        losses.append(loss)
        if grad is None:
            grad = harness.leaf_norms(agg)
        del agg
    return harness.to_host({"loss": losses, "grad": grad,
                            "change": harness.change_norms(cur, params)})


def run(cell: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> harness.Result:
    dc = Datacenter(cell, seed, device)
    prog = Program(dc)
    readings = prog.start(dc.weights())
    harness.sync(device)
    setup_s = time.perf_counter() - t_start
    e2e, ctx = {}, None
    if not trace:
        n, elapsed = harness.window(prog.advance, CHECK_STEPS, seconds,
                                    device)
        e2e = {"train_tokens_per_s": n * dc.tokens_per_step / elapsed,
               "setup_s": setup_s}
    else:
        n = cell["params"]["trace_steps"]
        tr = tracing.capture(
            lambda: [prog.advance(CHECK_STEPS + i) for i in range(n)],
            lambda: harness.sync(device))
        qb, pb = dc.bytes_per_step()
        ctx = {"trace": tr, "flops": n * dc.flops_per_step(),
               "peak_flops": counts.PEAK_FLOPS["bf16"],
               "quant_bytes": n * qb, "prune_bytes": n * pb}
    peak = harness.peak_bytes(device)
    prog_r = harness.to_host(readings)
    del prog, readings
    harness.free(device)
    found = compare.gaps(prog_r, reference_readings(dc))
    return harness.result(found, cell["params"]["limits"], n, peak, e2e,
                          ctx)
