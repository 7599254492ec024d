"""The one-card (no tensor-parallel context) outputs of the language
models, saved for a bitwise comparison between two source trees: the
forward logits, the loss and its gradients, the prefill's logits and
cache, and three decode steps of zamba2-2.7b, whisper-medium,
granite-8b, deepseek-v2-lite-16b, phi-3-vision-4.2b and rwkv6-7b at
``reduce_for_smoke`` widths (zamba2 at 4 layers, whisper with a
vocabulary of 510), in float32 and bfloat16 (deepseek float32 only),
with remat on and off, and Mamba2's ``mamba_seq`` (``CHUNK`` 0 and 4,
with its gradients) and ``mamba_step``. Seeded; CPU.

  python3 tools/plain_paths_digest.py run SRC OUT.pt   # SRC: a src/ dir
  python3 tools/plain_paths_digest.py compare A.pt B.pt

``run`` imports ``repro_torch`` from ``SRC`` (a checkout of another
commit, say), so two trees give two files; ``compare`` counts the
outputs that differ in a bit, dtype or shape.
"""
import sys

FAMILIES = (("zamba2-2.7b", {"n_layers": 4}),
            ("whisper-medium", {"vocab_size": 510}), ("granite-8b", {}),
            ("deepseek-v2-lite-16b", {}), ("phi-3-vision-4.2b", {}),
            ("rwkv6-7b", {}))
B, S, STEPS = 2, 12, 3


def _family(name, extra, dtype, remat):
    import torch

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import build_model
    cfg = reduce_for_smoke(get_arch(name)).replace(**extra)
    model = build_model(cfg, remat=remat)
    g = torch.Generator()
    g.manual_seed(1)
    params = {k: v.to(dtype) for k, v in model.init(g).items()}
    g.manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "encdec":
        batch["frames"] = 0.02 * torch.randn(
            (B, cfg.encoder_seq, cfg.d_model), generator=g)
    if cfg.family == "vlm":
        batch["image_embeds"] = 0.02 * torch.randn(
            (B, cfg.num_image_tokens, cfg.d_model), generator=g)
    out = {}
    out["grads"], out["loss"] = torch.func.grad_and_value(model.loss)(
        params, batch)
    out["logits"] = model.forward(params, batch)[0]
    with torch.no_grad():
        out["prefill"] = model.prefill(
            params, {k: v for k, v in batch.items() if k != "labels"})
        cache = model.init_cache(B, 32)
        for k, v in out["prefill"][1].items():
            axes = model.cache_axes()[k]
            if "seq" in axes:
                i = axes.index("seq")
                cache[k][(slice(None),) * i + (slice(0, v.shape[i]),)] = v
            else:
                cache[k] = v.clone()
        pos = torch.full((B,), S + (cfg.num_image_tokens
                                    if cfg.family == "vlm" else 0))
        steps = []
        for t in range(STEPS):
            logits, cache = model.decode_step(params, toks[:, t], pos,
                                              cache)
            steps.append(logits)
            pos = pos + 1
        out["decode"] = (steps, {k: v.clone() for k, v in cache.items()})
    return out


def run(src: str, path: str) -> None:
    sys.path.insert(0, src)
    import torch

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import build_model, mamba2
    res = {}
    for name, extra in FAMILIES:
        for dtype in ((torch.float32,) if "deepseek" in name
                      else (torch.float32, torch.bfloat16)):
            for remat in (True, False):
                res[f"{name}-{dtype}-{remat}"] = _family(name, extra, dtype,
                                                         remat)
    cfg = reduce_for_smoke(get_arch("zamba2-2.7b"))
    g = torch.Generator()
    g.manual_seed(3)
    p = {k[len("segments.mamba."):]: v[0, 0].float()
         for k, v in build_model(cfg).init(g).items()
         if k.startswith("segments.mamba.")}
    s, _, H, conv_dim = mamba2.mamba_dims(cfg)
    u = torch.randn(B, 8, cfg.d_model, generator=g)
    ssm = torch.randn(B, H, s.head_dim, s.state_dim, generator=g)
    conv = torch.randn(B, s.conv_width - 1, conv_dim, generator=g)
    saved = mamba2.CHUNK
    try:
        for chunk in (0, 4):
            mamba2.CHUNK = chunk
            res[f"mamba_seq-{chunk}"] = mamba2.mamba_seq(cfg, p, u, ssm,
                                                         conv)
            res[f"mamba_seq_grad-{chunk}"] = torch.func.grad(
                lambda p, u: mamba2.mamba_seq(cfg, p, u, ssm,
                                              conv)[0].sum(),
                argnums=(0, 1))(p, u)
    finally:
        mamba2.CHUNK = saved
    res["mamba_step"] = mamba2.mamba_step(cfg, p, u[:, 0], ssm, conv)
    torch.save(res, path)
    print(f"{len(res)} runs saved to {path}")


def compare(a_path: str, b_path: str) -> int:
    import torch
    from torch.utils._pytree import tree_flatten
    a, b = torch.load(a_path), torch.load(b_path)
    if a.keys() != b.keys():
        print("the runs differ")
        return 1
    n = bad = 0
    for k in a:
        la, lb = tree_flatten(a[k])[0], tree_flatten(b[k])[0]
        if len(la) != len(lb):
            print(f"{k}: {len(la)} outputs against {len(lb)}")
            bad += 1
            continue
        for x, y in zip(la, lb):
            n += 1
            if not (x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x, y)):
                bad += 1
                print(f"{k}: {x.dtype} {tuple(x.shape)} against {y.dtype} "
                      f"{tuple(y.shape)}")
    print(f"{bad} of {n} outputs of {len(a)} runs differ")
    return int(bad > 0)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "run":
        run(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
