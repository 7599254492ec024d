"""The paper's federated round (Section 6, Table 2) on the port's scanned
engine: ``repro_torch.fed.ScanRunner`` with host rng and host control,
``LTFLScheme`` (Algorithm 1 on the host every ``recontrol_every``
rounds, magnitude pruning, the B1 quantizer, power control), the
pre-activation ResNet, evaluation every ``eval_every`` rounds.

Set-up makes CIFAR-shaped data (class templates, shifts and noise) and
the weights on the device from the seed, builds one runner and makes
its first ``run(rounds_per_call)`` call, the call the window repeats
(every ``run`` call restarts the round count, so each opens with
Algorithm 1 and an evaluation). The output check follows that call's
rounds with the plain reference, which re-makes the host's draws and
Algorithm 1's decision from the seed (``refs.algorithm1``). The window
then calls ``run(rounds_per_call)`` until ``--seconds`` have passed and
counts every round completed.
"""
from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np
import torch

from ltflbench import compare, counts, harness
from ltflbench import trace as tracing
from ltflbench.refs import algorithm1, ltfl, resnet

RESNET_KEYS = ("image_size", "in_channels", "num_classes", "stem_channels",
               "group_channels", "blocks_per_group")
DATA_STREAM = 1 << 62


def synthetic_cifar(n_train: int, n_test: int, cfg: dict, seed: int,
                    device: torch.device):
    """CIFAR-shaped data from ``seed``: one smooth random template a
    class (8 x 8 fields upsampled), each image its class's template
    rolled by up to 3 pixels each way plus noise of std 0.5, scaled into
    [-1, 1]. Returns ((images, labels) train, (images, labels) test) as
    numpy, images NHWC float32, labels int32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + DATA_STREAM)
    k, hw, ch = cfg["num_classes"], cfg["image_size"], cfg["in_channels"]
    rep = hw // 8
    templates = torch.randn((k, 8, 8, ch), generator=gen, device=device)
    templates = templates.repeat_interleave(rep, 1).repeat_interleave(rep, 2)
    ar = torch.arange(hw, device=device)

    def draw(n):
        labels = torch.randint(0, k, (n,), generator=gen, device=device)
        shift = torch.randint(-3, 4, (n, 2), generator=gen, device=device)
        rows = (ar[None, :] - shift[:, :1]) % hw
        cols = (ar[None, :] - shift[:, 1:]) % hw
        img = templates[labels[:, None, None], rows[:, :, None],
                        cols[:, None, :]]
        img = img + 0.5 * torch.randn(img.shape, generator=gen,
                                      device=device)
        img = img / img.abs().max()
        return (img.cpu().numpy().astype(np.float32),
                labels.cpu().numpy().astype(np.int32))

    return draw(n_train), draw(n_test)


class Edge:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        cf, p = cell["config_file"], cell["params"]
        self.cfg = {k: cf[k] for k in RESNET_KEYS}
        self.spec = resnet.spec(self.cfg)
        self.cf, self.p, self.seed, self.device = cf, p, int(seed), device
        self.train, self.test = synthetic_cifar(
            cf["train_samples"], cf["test_samples"], self.cfg, seed, device)
        self.num_params = sum(math.prod(s) for s, _ in self.spec.values())

    def weights(self) -> harness.Tree:
        return harness.make_weights(self.spec, self.seed, torch.float32,
                                    self.device)

    def ltfl_config(self):
        from repro_torch.configs import LTFLConfig
        from repro_torch.configs.base import WirelessConfig
        return LTFLConfig(**{**self.cf["ltfl"], "wireless": WirelessConfig(
            **self.cf["wireless"])})

    def runner(self, params: harness.Tree):
        from repro_torch.configs import ResNetConfig
        from repro_torch.data import ArrayDataset
        from repro_torch.fed import LTFLScheme, ScanRunner
        from repro_torch.models import ResNet
        cf = self.cf
        model = ResNet(ResNetConfig(**{k: tuple(v) if isinstance(v, list)
                                       else v for k, v in self.cfg.items()}))
        shapes = {k: tuple(s.shape) for k, s in
                  model.param_specs().items()}
        if shapes != {k: s for k, (s, _) in self.spec.items()}:
            raise ValueError(f"the program's leaves {shapes} are not the "
                             "reference's")
        train = ArrayDataset({"images": self.train[0],
                              "labels": self.train[1]})
        test = ArrayDataset({"images": self.test[0], "labels": self.test[1]})
        return ScanRunner(
            model, params, self.ltfl_config(), train, test,
            LTFLScheme(recontrol_every=cf["recontrol_every"]),
            batch_size=cf["batch_size"], seed=self.seed,
            eval_every=cf["eval_every"], device=self.device, rng="host",
            control="host")

    def flops(self, rounds: int, evals: int) -> float:
        """The ResNet's forward and backward FLOPs of ``rounds`` rounds
        (every client's batch) and the forward FLOPs of ``evals``
        evaluations (4 batches of 256 test images each)."""
        c = self.cfg
        f = counts.resnet_forward_flops(
            c["image_size"], c["in_channels"], c["stem_channels"],
            c["group_channels"], c["blocks_per_group"], c["num_classes"])
        u, b = self.cf["ltfl"]["num_devices"], self.cf["batch_size"]
        return 3.0 * f * u * b * rounds + f * 4 * 256 * evals

    def quant_bytes_per_round(self) -> float:
        sizes = [math.prod(s) for s, _ in self.spec.values()]
        return counts.quant_bytes(sizes, self.cf["ltfl"]["num_devices"], 4)


def label_host_stages(runner) -> None:
    """Name the runner's host-side stages in a trace (one profiler span
    around each call), so that an idle gap on the device reads as the
    host stage that held it: the round's host inputs, Algorithm 1, the
    evaluation, the segment's absorption."""
    from torch.profiler import record_function
    for obj, attr, label in (
            (runner, "_host_round_inputs", "FedRunner._host_round_inputs"),
            (runner.scheme, "controls", "LTFLScheme.controls (Algorithm 1)"),
            (runner, "evaluate", "FedRunner.evaluate"),
            (runner, "_absorb_segment", "ScanRunner._absorb_segment")):
        def spanned(*a, fn=getattr(obj, attr), label=label, **kw):
            with record_function(label):
                return fn(*a, **kw)
        setattr(obj, attr, spanned)


def program_readings(runner, params: harness.Tree, lr: float,
                     rounds: int) -> dict:
    """The runner's first ``run(rounds)`` call, as the window makes it:
    each round's loss; the first round's gradient from the parameters'
    change over the call's first segment, which is round 0 alone (g =
    -(w1 - w0) / lr); the change over the whole call; and Algorithm 1's
    decision for the call (round 0's controls), read where the runner
    makes the round's host inputs."""
    first, decision = {}, []
    absorb, inputs = runner._absorb_segment, runner._host_round_inputs

    def absorbed(a, b, ctl, log):
        if (a, b) == (0, 1):
            first.update(harness.change_norms(runner.params, params))
        return absorb(a, b, ctl, log)

    def made(rnd):
        h = inputs(rnd)
        if not decision:
            decision.append(algorithm1.Decision(h.ctl.rho, h.ctl.delta,
                                                h.ctl.power))
        return h

    runner._absorb_segment, runner._host_round_inputs = absorbed, made
    try:
        runner.run(rounds)
    finally:                    # the class's own methods again
        del runner._absorb_segment, runner._host_round_inputs
    if not first:
        raise RuntimeError("the call's first segment is not round 0 alone")
    return {"loss": [r.train_loss for r in runner.history[:rounds]],
            "grad": {k: v / lr for k, v in first.items()},
            "change": harness.change_norms(runner.params, params),
            "decision": decision[0]}


def reference_readings(edge: Edge, rounds: int, tf32: bool = False,
                       alg1_dtype=np.float64) -> dict:
    """The plain reference over the first ``rounds`` rounds from freshly
    drawn weights: the host's draws and Algorithm 1 re-made from the seed
    (``refs.algorithm1``; Algorithm 1 in ``alg1_dtype``), the rounds in
    float32 (TF32 off as the port runs them; ``tf32`` for the
    control)."""
    dev = edge.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
    stream = algorithm1.HostStream(edge.cf, edge.seed, edge.num_params,
                                   alg1_dtype)
    images = torch.from_numpy(edge.train[0]).to(dev)
    labels = torch.from_numpy(edge.train[1]).to(dev)
    lr = torch.tensor(np.float32(edge.cf["ltfl"]["learning_rate"]),
                      device=dev)
    params = edge.weights()
    cur, losses, grad, decision = params, [], None, None
    for r in range(rounds):
        h = stream.round(r)
        d = h["decision"]
        if decision is None:
            decision = d
        idx = torch.from_numpy(h["batch_idx"]).to(dev)
        batches = [{"images": images[i], "labels": labels[i]} for i in idx]
        ctl = {"rho": d.rho, "delta": d.delta, "weights": h["weights"],
               "alpha": h["alpha"]}
        ctl = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
               for k, v in ctl.items()}
        new, loss, _ = ltfl.step(cur, batches, ctl, h["seed"], lr,
                                 lambda w, x: resnet.loss(w, x, edge.cfg),
                                 "magnitude")
        losses.append(float(loss))
        if grad is None:
            grad = {k: float(v) / float(lr) for k, v in
                    harness.change_norms(new, params).items()}
        cur = new
    return {"loss": losses, "grad": grad,
            "change": {k: float(v) for k, v in
                       harness.change_norms(cur, params).items()},
            "decision": decision}


def gaps(edge: Edge, prog: dict, ref: dict) -> Dict[str, float]:
    """The training numbers of ``compare.gaps`` and ``decision_gap``:
    the worst device's gap in Algorithm 1's rho, bits or power, each
    over its range (``algorithm1.decision_gaps``)."""
    found = compare.gaps(prog, ref)
    found["decision_gap"] = max(algorithm1.decision_gaps(
        prog["decision"], ref["decision"], edge.cf["ltfl"],
        edge.cf["wireless"]).values())
    return found


def run(cell: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> harness.Result:
    edge = Edge(cell, seed, device)
    params = edge.weights()
    runner = edge.runner(params)
    per_call = edge.p["rounds_per_call"]
    readings = program_readings(runner, params,
                                edge.cf["ltfl"]["learning_rate"], per_call)
    del params
    harness.sync(device)
    setup_s = time.perf_counter() - t_start
    e2e, ctx = {}, None
    if not trace:
        calls, elapsed = harness.window(lambda i: runner.run(per_call), 0,
                                        seconds, device)
        e2e = {"rounds_per_s": calls * per_call / elapsed,
               "setup_s": setup_s}
    else:
        calls = edge.p["trace_calls"]
        label_host_stages(runner)
        tr = tracing.capture(
            lambda: [runner.run(per_call) for _ in range(calls)],
            lambda: harness.sync(device))
        ev = edge.cf["eval_every"]
        evals = calls * len(range(0, per_call, ev)) if ev else 0
        ctx = {"trace": tr, "flops": edge.flops(calls * per_call, evals),
               "peak_flops": counts.f32_peak(),
               "quant_bytes": calls * per_call * edge.quant_bytes_per_round()}
    peak = harness.peak_bytes(device)
    prog_r = {**harness.to_host(readings), "decision": readings["decision"]}
    del runner, readings
    harness.free(device)
    found = gaps(edge, prog_r, reference_readings(edge, per_call))
    return harness.result(found, cell["params"]["limits"], calls * per_call,
                          peak, e2e, ctx)
