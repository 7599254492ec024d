"""Training launcher.

Held against ``repro.launch.train`` (the same arguments and defaults,
plus ``--device``). Two modes:

* ``--edge``: the paper's Section-6 CIFAR/ResNet federated run with the
  Algorithm-1 controller, channel simulation and delay/energy accounting.
  ``--width w`` builds groups (w, 2w, 4w, 4w), as the reference's
  launcher does; the default --train-samples (15,000) is below what the
  30 default devices draw (15,599 at seed 0), as in the reference, so
  pass more.
* datacenter (the default): the LTFL step with block pruning
  (``prune_kind="block"``, ``--prune-block``), the quantizer and the
  in-step packet drops (``--drop-prob``) for any architecture of
  ``repro_torch.configs`` (every family; the encoder-decoder's frames
  are split per client as the tokens are) on one card. ``--smoke`` runs its
  ``reduce_for_smoke`` variant. ``run_datacenter`` takes the
  ``ArchConfig`` itself, so a caller can cut depth and keep the widths.

Both run on ``cuda`` unless ``--device cpu`` and raise when no card is
present:

  PYTHONPATH=src python -m repro_torch.launch.train --edge --rounds 3 \\
      --train-samples 20000 --batch-size 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
      --smoke --device cpu --steps 2
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List, Optional


def run_edge(args) -> None:
    import torch

    from repro_torch.configs import LTFLConfig, ResNetConfig
    from repro_torch.data import ArrayDataset, synthetic_cifar
    from repro_torch.fed import ALL_SCHEMES, FedRunner, resolve_device
    from repro_torch.models import ResNet

    device = resolve_device(args.device)
    ltfl = LTFLConfig(num_devices=args.devices)
    imgs, labels = synthetic_cifar(args.train_samples, seed=0)
    timgs, tlabels = synthetic_cifar(args.test_samples, seed=1)
    train = ArrayDataset({"images": imgs, "labels": labels})
    test = ArrayDataset({"images": timgs, "labels": tlabels})
    model = ResNet(ResNetConfig(stem_channels=args.width,
                                group_channels=(args.width, args.width * 2,
                                                args.width * 4,
                                                args.width * 4)))
    gen = torch.Generator(device=device)
    gen.manual_seed(ltfl.seed)
    params = model.init(gen)
    scheme = ALL_SCHEMES[args.scheme]()
    runner = FedRunner(model, params, ltfl, train, test, scheme,
                       batch_size=args.batch_size,
                       non_iid_alpha=args.non_iid_alpha, seed=ltfl.seed,
                       device=device)
    runner.run(args.rounds, log_every=max(args.rounds // 20, 1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(runner.history_dict(), f, indent=2)
        print(f"history -> {args.out}")


class DatacenterRun:
    """The datacenter loop's state: the model, the step (block pruning at
    ``args.prune_block``), the parameters, one fixed batch and the
    controls, as the reference launcher builds them (parameters from
    seed 0, controls rho / delta / drop_prob / weights 500 for every
    client)."""

    def __init__(self, arch, args, device=None):
        import torch

        from repro_torch.core.ltfl_step import make_fl_train_step
        from repro_torch.fed import resolve_device
        from repro_torch.models import build_model, make_train_batch
        from repro_torch.optim import sgd

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the reference accumulates bf16 products in float32
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = False
        self.arch = arch
        self.model = build_model(arch)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        self.params = self.model.init(gen)
        self.opt = sgd(args.lr)
        self.opt_state = self.opt.init(self.params)
        c = args.clients
        self.step_fn = make_fl_train_step(self.model, self.opt, c,
                                          prune_block=args.prune_block,
                                          prune_kind="block")
        self.comp_state = self.step_fn.init_comp_state(self.params)
        batch = make_train_batch(arch, c * args.per_client_batch,
                                 args.seq_len, generator=gen)
        self.batch = {k: v.reshape(c, args.per_client_batch, *v.shape[1:])
                      for k, v in batch.items()}

        def full(v):
            return torch.full((c,), float(v), dtype=torch.float32,
                              device=self.device)

        self.controls = {"rho": full(args.rho), "delta": full(args.delta),
                         "drop_prob": full(args.drop_prob),
                         "weights": full(500.0)}

    def step(self, i: int) -> Dict[str, float]:
        """Step ``i`` (its seed is ``i``, as the reference's
        ``PRNGKey(i)``); returns the scalar metrics and the step's wall
        time in seconds, taken to a device synchronize."""
        import torch
        t0 = time.perf_counter()
        self.params, self.opt_state, self.comp_state, metrics = \
            self.step_fn(self.params, self.opt_state, self.comp_state,
                         self.batch, self.controls, i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        out = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
        out["seconds"] = seconds
        return out


def run_datacenter(arch, args, device=None,
                   on_step: Optional[Callable[[int, Dict[str, float]],
                                              None]] = None
                   ) -> "tuple[DatacenterRun, List[Dict[str, float]]]":
    """``args.steps`` datacenter steps of ``arch`` (an ``ArchConfig``)
    with the launcher's other arguments; prints one line per step and
    calls ``on_step(i, metrics)`` after each."""
    run = DatacenterRun(arch, args, device)
    n = sum(v.numel() for v in run.params.values())
    print(f"[datacenter] {arch.name}: {arch.n_layers} layers, d_model "
          f"{arch.d_model}, {n} parameters, {args.clients} clients x "
          f"batch {args.per_client_batch} x seq {args.seq_len}, "
          f"device {run.device}", flush=True)
    records = []
    for i in range(args.steps):
        m = run.step(i)
        print(f"step={i} " + " ".join(f"{k}={v:.4f}" for k, v in m.items()),
              flush=True)
        records.append(m)
        if on_step is not None:
            on_step(i, m)
    return run, records


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--edge", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    # edge mode
    ap.add_argument("--scheme", default="ltfl")
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--devices", type=int, default=30)
    ap.add_argument("--train-samples", type=int, default=15000)
    ap.add_argument("--test-samples", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--non-iid-alpha", type=float, default=0.0)
    ap.add_argument("--out", default="")
    # datacenter mode
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--per-client-batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--rho", type=float, default=0.25)
    ap.add_argument("--delta", type=int, default=8)
    ap.add_argument("--drop-prob", type=float, default=0.05)
    ap.add_argument("--prune-block", type=int, default=32)
    return ap


def main() -> None:
    args = build_parser().parse_args()
    if args.edge:
        run_edge(args)
        return
    from repro_torch import configs
    arch = configs.get_arch(args.arch)
    if args.smoke:
        arch = configs.reduce_for_smoke(arch)
    run_datacenter(arch, args, args.device)


if __name__ == "__main__":
    main()
