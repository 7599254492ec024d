"""Batched serving example on the PyTorch port: prefill a batch of prompts,
then decode tokens with the KV cache, for any assigned architecture
(the ``reduce_for_smoke`` config, random weights from seed 0).

The twin of examples/serve_batched.py: the same arguments and defaults,
plus ``--device`` (``cuda`` unless ``--device cpu``; raises when no card
is present). It runs ``repro_torch.launch.serve.generate``: the prefill,
the prompt cache spliced into a decode cache of prompt + gen positions
by the reference's rule, then greedy decode. The token rate counts all
generated tokens, the first one (from the prefill's logits) included,
over the time after the prefill, as the reference does.

Run:  PYTHONPATH=src python examples/torch_serve_batched.py --device cpu
      PYTHONPATH=src python examples/torch_serve_batched.py --arch zamba2-2.7b
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.fed import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models import build_model, make_train_batch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b",
                    choices=configs.list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = configs.reduce_for_smoke(configs.get_arch(args.arch))
    model = build_model(cfg, remat=False)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init(gen)
    print(f"serving reduced {cfg.name} ({cfg.n_layers}L d={cfg.d_model} "
          f"family={cfg.family}) on {device}")

    batch = make_train_batch(cfg, args.batch, args.prompt_len, gen)
    batch.pop("labels")
    res = generate(model, params, batch, args.gen)
    print(f"prefill {args.batch}x{args.prompt_len}: {res.prefill_s:.2f}s")
    dt = res.decode_s
    print(f"generated {args.gen} tokens/seq in {dt:.2f}s "
          f"({args.gen * args.batch / max(dt, 1e-9):.1f} tok/s)")
    for b in range(min(args.batch, 2)):
        print(f"request {b}: {res.tokens[b].tolist()}")


if __name__ == "__main__":
    main()
