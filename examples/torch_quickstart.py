"""Quickstart for the PyTorch port: the LTFL pipeline end to end.

The counterpart of ``examples/quickstart.py`` on ``repro_torch``:

1. the paper's world: 8 wireless devices with heterogeneous CPUs,
   distances and fading (Table 2), synthetic CIFAR-shaped data, the
   pre-activation ResNet;
2. Algorithm 1 (closed-form rho*/delta* + Bayesian-optimized power);
3. a few federated rounds with pruning, stochastic quantization and
   packet loss, printing accuracy / delay / energy.

Run on the card (the default) or on the CPU (~2 minutes):

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import LTFLConfig, ResNetConfig
from repro_torch.data import ArrayDataset, synthetic_cifar
from repro_torch.fed import FedRunner, LTFLScheme, resolve_device
from repro_torch.models import ResNet


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    device = resolve_device(args.device)
    ltfl = LTFLConfig(num_devices=8, bo_iters=8, alt_max_iters=3)

    imgs, labels = synthetic_cifar(4000, seed=0)
    timgs, tlabels = synthetic_cifar(1000, seed=1)
    train = ArrayDataset({"images": imgs, "labels": labels})
    test = ArrayDataset({"images": timgs, "labels": tlabels})

    model = ResNet(ResNetConfig(stem_channels=24,
                                group_channels=(24, 48, 96, 96)))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init(gen)

    runner = FedRunner(model, params, ltfl, train, test, LTFLScheme(),
                       batch_size=48, seed=0, device=device)
    runner.run(args.rounds, log_every=1)
    dec = runner.scheme._decision
    print("\n=== Algorithm 1 decision (per device) ===")
    print("rho*  :", [f"{r:.2f}" for r in dec.rho])
    print("delta*:", [int(d) for d in dec.delta])
    print("p*    :", [f"{p:.3f}" for p in dec.power])
    last = runner.history[-1]
    print(f"\nfinal: acc={last.test_acc:.3f} "
          f"cum_delay={last.cum_delay:.0f}s cum_energy={last.cum_energy:.1f}J")


if __name__ == "__main__":
    main()
