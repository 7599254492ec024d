"""A dense decoder language model in plain PyTorch (granite-8b's family).

Pre-norm blocks: RMSNorm (eps 1e-6, computed in float32), grouped-query
attention with rotary position embeddings (rotate-half, base
``rope_theta``) and a causal softmax in float32, a SwiGLU MLP; a final
RMSNorm and an untied head; the loss is the mean next-token
cross-entropy in float32. Weights and activations are in the
parameters' dtype (bfloat16 as served), each product accumulated in
float32 by the library.

The parameter layout is the one both sides share, as a checkpoint
format would be: stacked layers under ``layers.*`` with a leading layer
axis, weights stored (in, out). ``fp8=True`` rounds both operands of
every projection and of the head to float8 e4m3 with a per-tensor scale
(the output check's control: the precision below the configuration's).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Tree = Dict[str, torch.Tensor]
NEG_INF = -1e30
E4M3_MAX = 448.0


def spec(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Every leaf's shape and init ("normal": std 1/sqrt(fan in),
    "embed": std 0.02, "ones"), in leaf order."""
    d, h, kv = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd, f, n, v = cfg["head_dim"], cfg["d_ff"], cfg["n_layers"], \
        cfg["vocab_size"]
    return {
        "embed.head": ((d, v), "normal"),
        "embed.tok": ((v, d), "embed"),
        "final_norm.gamma": ((d,), "ones"),
        "layers.attn.wk": ((n, d, kv * hd), "normal"),
        "layers.attn.wo": ((n, h * hd, d), "normal"),
        "layers.attn.wq": ((n, d, h * hd), "normal"),
        "layers.attn.wv": ((n, d, kv * hd), "normal"),
        "layers.ffn.wi_gate": ((n, d, f), "normal"),
        "layers.ffn.wi_up": ((n, d, f), "normal"),
        "layers.ffn.wo": ((n, f, d), "normal"),
        "layers.ln1.gamma": ((n, d), "ones"),
        "layers.ln2.gamma": ((n, d), "ones"),
    }


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-tensor scale; the gradient
    passes straight through."""
    amax = x.detach().abs().amax().to(torch.float32).clamp(min=1e-30)
    s = E4M3_MAX / amax
    q = ((x.detach().to(torch.float32) * s).to(torch.float8_e4m3fn)
         .to(torch.float32) / s).to(x.dtype)
    return x + (q - x).detach()


def _mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    return _fp8(a) @ _fp8(b) if fp8 else a @ b


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (out * gamma.to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, hd) rotated by its positions 0 .. S-1."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                       device=x.device),
                            torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs[None, :]
    c = torch.cos(ang)[:, None, :].to(x.dtype)
    sn = torch.sin(ang)[:, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1)


def loss(params: Tree, batch: Dict[str, torch.Tensor], cfg: dict,
         fp8: bool = False) -> torch.Tensor:
    tokens = batch["tokens"]
    b, s = tokens.shape
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    x = params["embed.tok"][tokens]
    causal = torch.triu(torch.full((s, s), NEG_INF, dtype=torch.float32,
                                   device=x.device), diagonal=1)
    for i in range(cfg["n_layers"]):
        def w(name):
            return params[f"layers.{name}"][i]
        a = rms_norm(x, w("ln1.gamma"))
        q = rope(_mm(a, w("attn.wq"), fp8).reshape(b, s, h, hd),
                 cfg["rope_theta"])
        k = rope(_mm(a, w("attn.wk"), fp8).reshape(b, s, kv, hd),
                 cfg["rope_theta"])
        v = _mm(a, w("attn.wv"), fp8).reshape(b, s, kv, hd)
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) \
            / math.sqrt(hd) + causal
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h * hd)
        x = x + _mm(o, w("attn.wo"), fp8)
        m = rms_norm(x, w("ln2.gamma"))
        x = x + _mm(F.silu(_mm(m, w("ffn.wi_gate"), fp8))
                    * _mm(m, w("ffn.wi_up"), fp8), w("ffn.wo"), fp8)
    logits = _mm(rms_norm(x, params["final_norm.gamma"]),
                 params["embed.head"], fp8)
    lf = logits[:, :-1, :].to(torch.float32)
    gold = torch.gather(lf, -1, batch["labels"][:, 1:, None]
                        .to(torch.int64))[..., 0]
    return torch.mean(torch.logsumexp(lf, dim=-1) - gold)
