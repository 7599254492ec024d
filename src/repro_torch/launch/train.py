"""Training launcher, edge mode: the paper's Section-6 CIFAR/ResNet
federated run with the Algorithm-1 controller, channel simulation and
delay/energy accounting.

Held against ``repro.launch.train --edge`` (the same arguments and
defaults, plus ``--device``). Runs on ``cuda`` unless ``--device cpu``
and raises when no card is present. The datacenter mode is not ported
yet. ``--width w`` builds groups (w, 2w, 4w, 4w), as the reference's
launcher does; the default --train-samples (15,000) is below what the
30 default devices draw (15,599 at seed 0), as in the reference, so pass
more:

  PYTHONPATH=src python -m repro_torch.launch.train --edge --rounds 3 \\
      --train-samples 20000 --batch-size 50
"""
from __future__ import annotations

import argparse
import json
import os


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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--edge", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--scheme", default="ltfl")
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--devices", type=int, default=30)
    ap.add_argument("--train-samples", type=int, default=15000)
    ap.add_argument("--test-samples", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--non-iid-alpha", type=float, default=0.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not args.edge:
        raise SystemExit("only --edge is ported; the datacenter mode is "
                         "not yet")
    run_edge(args)


if __name__ == "__main__":
    main()
