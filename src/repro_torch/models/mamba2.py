"""Mamba2 (SSD) block: a selective state space with a scalar decay per head.

Held against ``repro.models.mamba2``: ``mamba_dims``, ``mamba_specs``,
``_split_proj``, ``_causal_conv_seq``, ``_causal_conv_step``,
``_chunked_ssd``, ``mamba_seq`` and ``mamba_step``, with the reference's
``CHUNK`` module switch. Recurrence per head (state h (P, N), P the head
width, N the state size):

    a_t = exp(dt_t * A)            A = -exp(a_log) < 0
    h_t = a_t * h_{t-1} + (dt_t * x_t) B_t^T
    y_t = h_t C_t + D * x_t

x, B and C pass through a causal depthwise convolution of width
``conv_width``; B and C are shared by the heads (one group).

``CHUNK = 0`` (the default, as in the reference) runs the recurrence one
step at a time (``common.time_scan`` for the reference's ``lax.scan``);
``CHUNK > 0`` with the sequence a multiple of it takes the chunk-parallel
form, another order of float32 operations. Dtypes follow the reference:
the recurrence is float32, ``a_log`` and ``dt_bias`` are upcast before
``exp`` and ``softplus``, the convolution runs in the activations' dtype
and its state comes back in it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.models.common import (
    ParamSpec,
    rms_norm,
    shard_hint,
    time_scan,
)

Tree = Dict[str, torch.Tensor]

# when > 0, mamba_seq uses the chunk-parallel SSD form with this
# intra-chunk length (Mamba2's scalar decay per head makes it exact
# algebra; another float32 summation order)
CHUNK = 0


def mamba_dims(cfg: ArchConfig):
    s = cfg.ssm or SSMConfig()
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    return s, d_in, n_heads, conv_dim


def mamba_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    s, d_in, n_heads, conv_dim = mamba_dims(cfg)
    proj_out = 2 * d_in + 2 * s.n_groups * s.state_dim + n_heads  # z,x,B,C,dt
    return {
        "in_proj": ParamSpec((d, proj_out), ("embed", "ssm_fused"), "normal"),
        "conv_w": ParamSpec((s.conv_width, conv_dim), ("conv", "ssm_fused"),
                            "normal", scale=1.0),
        "conv_b": ParamSpec((conv_dim,), ("ssm_fused",), "zeros"),
        "a_log": ParamSpec((n_heads,), ("heads",), "zeros"),
        "dt_bias": ParamSpec((n_heads,), ("heads",), "zeros"),
        "d_skip": ParamSpec((n_heads,), ("heads",), "ones"),
        "out_norm": ParamSpec((d_in,), ("ssm_fused",), "ones"),
        "out_proj": ParamSpec((d_in, d), ("ssm_fused", "embed"), "normal"),
    }


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    s, d_in, _, _ = mamba_dims(cfg)
    gn = s.n_groups * s.state_dim
    z = proj[..., :d_in]
    x = proj[..., d_in:2 * d_in]
    B = proj[..., 2 * d_in:2 * d_in + gn]
    C = proj[..., 2 * d_in + gn:2 * d_in + 2 * gn]
    dt = proj[..., 2 * d_in + 2 * gn:]
    return z, x, B, C, dt


def _causal_conv_seq(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                     init_state: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal convolution. x (B,S,C); w (K,C); init_state
    (B,K-1,C). Returns (y (B,S,C), the last K-1 inputs (B,K-1,C))."""
    K = w.shape[0]
    xp = torch.cat([init_state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else init_state
    return y + b, new_state


def _causal_conv_step(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                      state: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,C); state (B,K-1,C) holds the previous inputs."""
    K = w.shape[0]
    xs = torch.cat([state.to(x.dtype), x[:, None, :]], dim=1)
    y = torch.einsum("bkc,kc->bc", xs, w) + b
    return y, xs[:, -(K - 1):, :] if K > 1 else state


def _chunked_ssd(xdt: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
                 a: torch.Tensor, ssm_state: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel form of h_t = a_t h_{t-1} + (dt_t x_t) B_t^T,
    y_t = h_t C_t. xdt (B,S,H,P) = x * dt; Bc/Cc (B,S,N); a (B,S,H) in
    (0, 1]; ssm_state (B,H,P,N). Returns (y (B,S,H,P), new state)."""
    B_, S, H, P = xdt.shape
    c = CHUNK
    if S % c:
        raise ValueError(f"sequence {S} is not a multiple of CHUNK {c}")
    nc = S // c
    xs = xdt.reshape(B_, nc, c, H, P).transpose(0, 1)
    Bs = Bc.reshape(B_, nc, c, -1).transpose(0, 1)
    Cs = Cc.reshape(B_, nc, c, -1).transpose(0, 1)
    as_ = a.reshape(B_, nc, c, H).transpose(0, 1)
    # i <= t (diagonal included)
    tril = torch.tril(torch.ones(c, c, dtype=torch.float32,
                                 device=xdt.device))

    def chunk(h0, i):
        x, Bm, Cm, av = xs[i], Bs[i], Cs[i], as_[i]  # (B,c,H,P) (B,c,N) (B,c,H)
        A = torch.cumprod(av, dim=1)                 # prod_{j<=t} a_j
        A_safe = torch.clamp(A, min=1e-30)
        # inter-chunk: A_t * (C_t . h0)
        ch0 = torch.einsum("bcn,bhpn->bchp", Cm, h0)
        y = A[..., None] * ch0
        # intra-chunk: sum_{i<=t} (A_t/A_i)(C_t.B_i)(x_i dt_i)
        G = torch.einsum("bcn,bin->bci", Cm, Bm)
        R = A_safe[:, :, None, :] / A_safe[:, None, :, :]   # (B,t,i,H)
        R = R * tril[None, :, :, None]
        y = y + torch.einsum("btih,bti,bihp->bthp", R, G, x)
        # state: h_c = A_c h0 + sum_i (A_c/A_i) (x_i dt_i) B_i^T
        A_c = A[:, -1]                               # (B,H)
        w = A_c[:, None, :] / A_safe                 # (B,c,H)
        h_new = A_c[..., None, None] * h0 + torch.einsum(
            "bch,bchp,bcn->bhpn", w, x, Bm)
        return h_new, y

    ssm_state, ys = time_scan(chunk, ssm_state, nc)     # ys (nc,B,c,H,P)
    return ys.transpose(0, 1).reshape(B_, S, H, P), ssm_state


def mamba_seq(cfg: ArchConfig, p: Tree, u: torch.Tensor,
              ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """u (B,S,D); ssm_state (B,H,P,N) float32; conv_state (B,K-1,conv_dim).

    Returns (y (B,S,D), new ssm_state, new conv_state)."""
    s, d_in, H, _ = mamba_dims(cfg)
    B_, S, _ = u.shape
    P, N = s.head_dim, s.state_dim

    proj = u @ p["in_proj"]
    z, x, Bc, Cc, dt = _split_proj(cfg, proj)
    xbc = torch.cat([x, Bc, Cc], dim=-1)
    xbc, new_conv = _causal_conv_seq(p["conv_w"], p["conv_b"], xbc,
                                     conv_state)
    xbc = F.silu(xbc)
    x = xbc[..., :d_in].reshape(B_, S, H, P)
    Bc = xbc[..., d_in:d_in + s.n_groups * N]                  # (B,S,N) g=1
    Cc = xbc[..., d_in + s.n_groups * N:]

    A = -torch.exp(p["a_log"].to(torch.float32))               # (H,)
    dt = F.softplus(dt.to(torch.float32)
                    + p["dt_bias"].to(torch.float32))          # (B,S,H)
    a = torch.exp(dt * A)                                      # (B,S,H)
    xdt = x.to(torch.float32) * dt[..., None]                  # (B,S,H,P)
    Bf, Cf = Bc.to(torch.float32), Cc.to(torch.float32)

    if CHUNK and S % CHUNK == 0:
        y, ssm_state = _chunked_ssd(xdt, Bf, Cf, a,
                                    ssm_state.to(torch.float32))
    else:
        def step(h, t):
            dBx = torch.einsum("bhp,bn->bhpn", xdt[:, t], Bf[:, t])
            h = a[:, t, :, None, None] * h + dBx
            return h, torch.einsum("bhpn,bn->bhp", h, Cf[:, t])

        ssm_state, y = time_scan(step, ssm_state.to(torch.float32), S)
        y = y.transpose(0, 1)                                  # (B,S,H,P)
    y = y + p["d_skip"].to(torch.float32)[None, None, :, None] \
        * x.to(torch.float32)
    y = y.reshape(B_, S, d_in).to(u.dtype)
    y = rms_norm(y, p["out_norm"]) * F.silu(z)
    out = y @ p["out_proj"]
    return (shard_hint(out, ("batch", "act_seq", "act_embed")), ssm_state,
            new_conv)


def mamba_step(cfg: ArchConfig, p: Tree, u: torch.Tensor,
               ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """One token: u (B,D). Returns (y (B,D), new ssm_state, new
    conv_state)."""
    s, d_in, H, _ = mamba_dims(cfg)
    B_ = u.shape[0]
    P, N = s.head_dim, s.state_dim
    proj = u @ p["in_proj"]
    z, x, Bc, Cc, dt = _split_proj(cfg, proj)
    xbc = torch.cat([x, Bc, Cc], dim=-1)
    xbc, new_conv = _causal_conv_step(p["conv_w"], p["conv_b"], xbc,
                                      conv_state)
    xbc = F.silu(xbc)
    x = xbc[..., :d_in].reshape(B_, H, P).to(torch.float32)
    Bc = xbc[..., d_in:d_in + s.n_groups * N].to(torch.float32)
    Cc = xbc[..., d_in + s.n_groups * N:].to(torch.float32)

    A = -torch.exp(p["a_log"].to(torch.float32))
    dt = F.softplus(dt.to(torch.float32)
                    + p["dt_bias"].to(torch.float32))          # (B,H)
    a = torch.exp(dt * A)
    dBx = torch.einsum("bhp,bn->bhpn", x * dt[..., None], Bc)
    ssm_state = a[..., None, None] * ssm_state + dBx
    y = torch.einsum("bhpn,bn->bhp", ssm_state, Cc)
    y = y + p["d_skip"][None, :, None].to(torch.float32) * x
    y = y.reshape(B_, d_in).to(u.dtype)
    y = rms_norm(y, p["out_norm"]) * F.silu(z)
    return y @ p["out_proj"], ssm_state, new_conv
