"""Serving launcher: batched prefill + decode for any architecture the
port builds (the dense, MoE, VLM, SSM, hybrid and encoder-decoder
families).

Held against ``repro.launch.serve``: the same arguments and defaults,
plus ``--device`` (``cuda`` unless ``--device cpu``; raises when no card
is present). Parameters come from a seeded random init (seed 0), as the
reference's launcher does. ``generate`` is the launcher's loop, for
callers that hold a model and parameters: prefill the prompt, splice its
cache into a cache of prompt + gen positions (the reference's
``splice`` rule: only a cache whose sequence axis equals the prompt
length is copied, so a VLM prompt cache, which also holds the image
tokens, is not, and decode starts from a zero cache; a leaf of the
decode cache's own shape, a recurrent state or a cross cache, replaces
it), then greedy or
sampled decode, one token a step. With ``--temperature > 0`` step i
draws from a ``torch.Generator`` seeded ``100 + i`` (other draws than
the reference's ``PRNGKey(100 + i)``; only greedy decoding is a parity
target).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
      --smoke --device cpu --batch 4 --prompt-len 32 --gen 16
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, NamedTuple, Optional

import torch

Tree = Dict[str, torch.Tensor]


class Generation(NamedTuple):
    tokens: torch.Tensor       # (B, gen) int64: the prefill's, then decode's
    logits: torch.Tensor       # (B, gen, V): the logits each token came from
    prefill_s: float           # prefill + splice + first token, host clock
    decode_s: float            # the gen - 1 decode steps, host clock
    step_ms: List[float]       # each decode step by CUDA events (card only)
    cache: Tree                # after the last step; position P + gen - 1
                               # is still free


def splice(dst: torch.Tensor, src: torch.Tensor, prompt_len: int
           ) -> torch.Tensor:
    """The reference's rule: a prompt cache whose sequence axis (2) is the
    prompt length is copied into the front of ``dst``; one of ``dst``'s
    shape replaces it; any other leaves ``dst`` as it is."""
    if dst.dim() >= 3 and src.dim() == dst.dim() \
            and src.shape[2] == prompt_len and dst.shape[2] >= prompt_len:
        dst[:, :, :prompt_len] = src
        return dst
    return src.to(dst.dtype) if dst.shape == src.shape else dst


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params: Tree, batch: Dict[str, torch.Tensor], gen: int,
             temperature: float = 0.0) -> Generation:
    """Prefill ``batch`` (tokens (B, P), plus image_embeds for a VLM or
    frames for the encoder-decoder family) and
    decode ``gen - 1`` more tokens at positions P, P + 1, ..."""
    tokens = batch["tokens"]
    device = tokens.device
    B, prompt_len = tokens.shape
    events = []
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, prompt_cache = model.prefill(params, batch)
        cache = model.init_cache(B, prompt_len + gen, device)
        cache = {k: splice(cache[k], prompt_cache[k], prompt_len)
                 for k in cache}
        del prompt_cache
        last = logits[:, -1, :]
        del logits
        tok = torch.argmax(last, dim=-1)
        _sync(device)
        prefill_s = time.perf_counter() - t0

        out, out_logits = [tok], [last]
        if device.type == "cuda":
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        t0 = time.perf_counter()
        for i in range(gen - 1):
            pos = torch.full((B,), prompt_len + i, dtype=torch.int64,
                             device=device)
            logits, cache = model.decode_step(params, tok, pos, cache)
            if temperature > 0:
                g = torch.Generator(device=device)
                g.manual_seed(100 + i)
                probs = torch.softmax(logits.to(torch.float32) / temperature,
                                      dim=-1)
                tok = torch.multinomial(probs, 1, generator=g)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            out.append(tok)
            out_logits.append(logits)
            if device.type == "cuda":
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        _sync(device)
        decode_s = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return Generation(torch.stack(out, dim=1), torch.stack(out_logits, 1),
                      prefill_s, decode_s, step_ms, cache)


def main(argv: Optional[List[str]] = None) -> None:
    from repro_torch import configs
    from repro_torch.fed import resolve_device
    from repro_torch.models import build_model, make_train_batch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        # the reference accumulates bf16 products in float32
        torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction = False
    arch = configs.get_arch(args.arch)
    if args.smoke:
        arch = configs.reduce_for_smoke(arch)
    model = build_model(arch, remat=False)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init(gen)
    gen.manual_seed(0)
    batch = make_train_batch(arch, args.batch, args.prompt_len, gen)
    batch.pop("labels")

    res = generate(model, params, batch, args.gen, args.temperature)
    print(f"prefill {args.batch}x{args.prompt_len}: {res.prefill_s:.2f}s")
    steps = args.gen - 1
    print(f"decoded {steps} steps in {res.decode_s:.2f}s "
          f"({steps * args.batch / max(res.decode_s, 1e-9):.1f} tok/s)")
    print("generated ids[0]:", res.tokens[0].tolist())


if __name__ == "__main__":
    main()
