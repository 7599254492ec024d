"""A paper table as one sweep: lanes of ``ScanRunner.run_sweep``.

The counterpart of ``examples/paper_table_sweep.py`` on ``repro_torch``.
``run_sweep`` over a ``SweepSpec`` runs the scheme x channel-regime x
seed grid as lanes; lanes whose segments bake in the same constants form
a bucket, and a bucket runs as one round step over all its lanes'
clients (one quantizer launch per leaf per round for the bucket). The
channel regimes differ only in laned floats (power cap, budgets), so
they share each scheme's bucket. Each lane's history is its solo run's.

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python examples/torch_paper_table_sweep.py
    PYTHONPATH=src python examples/torch_paper_table_sweep.py --device cpu
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import LTFLConfig
from repro_torch.data import ArrayDataset, synthetic_cifar
from repro_torch.fed import (
    FedSGDScheme,
    LTFLScheme,
    STCScheme,
    ScanRunner,
    SweepSpec,
    resolve_device,
)
from repro_torch.models import MLP, MLPConfig


def ltfl_cfg(**wireless_kw) -> LTFLConfig:
    cfg = LTFLConfig(num_devices=8, samples_min=40, samples_max=60,
                     learning_rate=0.1, bo_iters=6, alt_max_iters=3)
    if wireless_kw:
        cfg = dataclasses.replace(
            cfg, wireless=dataclasses.replace(cfg.wireless, **wireless_kw))
    return cfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    device = resolve_device(args.device)

    imgs, labels = synthetic_cifar(1024, seed=0)
    timgs, tlabels = synthetic_cifar(256, seed=1)
    train = ArrayDataset({"images": imgs, "labels": labels})
    test = ArrayDataset({"images": timgs, "labels": tlabels})
    model = MLP(MLPConfig(hidden=(16,), downsample=4))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)

    # the table's axes: 3 schemes x 2 channel regimes x 2 seeds; "tight"
    # differs from "narrow" only in laned floats
    regimes = {
        "narrow": ltfl_cfg(),
        "tight": dataclasses.replace(ltfl_cfg(p_max=0.05),
                                     t_max=1000.0, e_max=5.0),
    }
    spec = SweepSpec.grid(
        schemes={"ltfl": LTFLScheme, "fedsgd": FedSGDScheme,
                 "stc": STCScheme},
        ltfls=regimes, seeds=(0, 1))

    parent = ScanRunner(model, params, regimes["narrow"], train, test,
                        FedSGDScheme(), batch_size=8, eval_every=0,
                        device=device)
    hists = parent.run_sweep(spec, args.rounds)

    n_buckets = len(parent._last_sweep_buckets)
    print(f"{len(spec.lanes)} lanes ran in {n_buckets} buckets "
          f"(regime + seed axes are free; one bucket per scheme)\n")
    print(f"{'cell':<16} {'loss':>7} {'delay s':>9} {'energy J':>9}")
    cells = {}
    for lane, hist in zip(spec.lanes, hists):
        cells.setdefault(lane.label.rsplit("/", 1)[0], []).append(hist[-1])
    for cell, finals in sorted(cells.items()):
        n = len(finals)
        print(f"{cell:<16} "
              f"{sum(r.train_loss for r in finals) / n:>7.4f} "
              f"{sum(r.cum_delay for r in finals) / n:>9.1f} "
              f"{sum(r.cum_energy for r in finals) / n:>9.2f}")


if __name__ == "__main__":
    main()
