"""Federated LM training with the scanned datacenter LTFL step.

The counterpart of ``examples/train_federated_lm.py`` on
``repro_torch``: a llama-family (granite-architecture) language model
with the full LTFL operator chain — per-client block pruning (the
``block_norms`` and ``apply_block_mask`` kernels), stochastic
quantization (the ``stochastic_quant`` kernel), packet drops, weighted
aggregation — on synthetic token data, ``--scan-rounds`` rounds per
``make_scanned_step`` segment: per segment the host draws the batch
indices and uploads the tokens once, and reads the loss only on log
steps.

The default model is small (~10M parameters); ``--hundred-m`` switches
to a ~100M-parameter config (d_model 768, 12 layers) with the same code
paths.

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python examples/torch_train_federated_lm.py --steps 60
    PYTHONPATH=src python examples/torch_train_federated_lm.py \\
        --device cpu --steps 4 --scan-rounds 2
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import save
from repro_torch.core.ltfl_step import make_fl_train_step
from repro_torch.data import synthetic_lm
from repro_torch.fed import make_scanned_step, resolve_device
from repro_torch.models import build_model
from repro_torch.optim import sgd


def build_cfg(hundred_m: bool):
    base = configs.get_arch("granite-8b")
    if hundred_m:
        return base.replace(n_layers=12, d_model=768, n_heads=12,
                            n_kv_heads=4, head_dim=64, d_ff=3072,
                            vocab_size=32768)
    return base.replace(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                        head_dim=64, d_ff=1024, vocab_size=4096)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--per-client-batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--scan-rounds", type=int, default=10,
                    help="federated rounds per segment (1 = the per-step "
                         "loop)")
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--ckpt", default="")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = build_cfg(args.hundred_m)
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init(gen)
    n_params = sum(v.numel() for v in params.values())
    print(f"model: {cfg.name} variant, {n_params / 1e6:.1f}M params, "
          f"device {device}")

    opt = sgd(0.3)
    opt_state = opt.init(params)
    C = args.clients
    step_fn = make_fl_train_step(model, opt, C, prune_block=64)
    comp_state = step_fn.init_comp_state(params)
    scan_fn = make_scanned_step(step_fn)

    toks = synthetic_lm(C * args.per_client_batch * 8, args.seq + 1,
                        cfg.vocab_size, seed=0)

    def full(v):
        return torch.full((C,), v, dtype=torch.float32, device=device)

    controls = {
        "rho": torch.linspace(0.0, 0.4, C, device=device),
        "delta": full(8.0),
        "drop_prob": full(0.05),
        "weights": full(500.0),
    }
    rng = np.random.default_rng(0)
    t0 = time.time()
    done = 0
    log_interval = max(args.steps // 10, 1)
    next_log = 0
    while done < args.steps:
        n = min(args.scan_rounds, args.steps - done)
        idx = np.stack([rng.choice(len(toks), C * args.per_client_batch,
                                   replace=False) for _ in range(n)])
        b = torch.from_numpy(toks[idx].astype(np.int64)).to(device).reshape(
            n, C, args.per_client_batch, -1)
        # model.loss shifts internally (predict t+1 from t)
        batch = {"tokens": b[..., :-1], "labels": b[..., :-1]}
        params, opt_state, comp_state, m = scan_fn(
            params, opt_state, comp_state, batch, controls,
            list(range(done, done + n)))
        done += n
        # ~10 log lines a run; reading the loss is the only host sync
        if done > next_log or done >= args.steps:
            next_log = done + log_interval
            print(f"step {done - 1:4d} loss={float(m['loss'][-1]):.4f} "
                  f"recv={int(m['clients_received'][-1])}/{C} "
                  f"({(time.time() - t0) / done:.2f}s/step, "
                  f"{n} rounds/segment)")
    if args.ckpt:
        path = save(args.ckpt, args.steps, {"params": params})
        print("checkpoint:", path)


if __name__ == "__main__":
    main()
