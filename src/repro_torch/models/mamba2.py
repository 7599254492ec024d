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

Under tensor parallelism (``models.tensor_parallel``, whose module
docstring gives the layout) the block input is a ``tp.Enter`` of the
residual stream: in_proj's column shard and the convolution's channel
shard are gathered whole as activations, the rank runs the recurrence of
its heads, and the states it takes and returns are its part (the rank's
heads, the convolution's channels of its shard). One body serves both
cases: outside a context every helper is the identity.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.common import (
    ParamSpec,
    shard_hint,
    time_scan,
)
from repro_torch.models.layers import _entered

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


def _shards(cfg: ArchConfig, p: Tree) -> Tuple[int, int, bool]:
    """(lo, n, sharded): this rank's heads [lo, lo + n) and whether
    in_proj, the convolution and the per-head leaves are its 'model'
    shards (all heads and whole weights outside tensor parallelism)."""
    s, d_in, H, conv_dim = mamba_dims(cfg)
    n = p["a_log"].shape[-1]
    sharded = n != H
    size = H // n                    # the shards the heads were split into
    widths = {"in_proj": (p["in_proj"].shape[-1] * size,
                          2 * d_in + 2 * s.n_groups * s.state_dim + H),
              "conv_w": (p["conv_w"].shape[-1] * size, conv_dim),
              "conv_b": (p["conv_b"].shape[-1] * size, conv_dim),
              "dt_bias": (p["dt_bias"].shape[-1], n),
              "d_skip": (p["d_skip"].shape[-1], n),
              "out_norm": (p["out_norm"].shape[-1], n * s.head_dim),
              "out_proj": (p["out_proj"].shape[-2], n * s.head_dim)}
    apart = sorted(k for k, (got, want) in widths.items() if got != want)
    if apart or H % n:
        raise NotImplementedError(
            f"{cfg.name}: the Mamba2 leaves {apart} are not laid out as "
            f"{n} of its {H} heads")
    return (tp.active().rank * n if sharded else 0), n, sharded


def _mixer_inputs(cfg: ArchConfig, p: Tree, xe: "tp.Enter", conv):
    """The block input h (the rank's rows of the sequence, or a token),
    and the rank's heads' z, x, dt and the shared B and C, from the
    projection (gathered whole from its column shards) and ``conv(w, b,
    xbc)``, the causal convolution on the rank's channels of x | B | C
    (all of them outside tensor parallelism), whose output is gathered
    whole. Also returns the convolution's new state, the rank's heads and
    whether they are its shard. A gathered tensor is copied out of at
    once, so that no view keeps a whole copy alive for the backward
    pass."""
    s, d_in, _, _ = mamba_dims(cfg)
    lo, n, sharded = _shards(cfg, p)
    P, gn = s.head_dim, s.n_groups * s.state_dim
    heads = slice(lo * P, (lo + n) * P)
    width = p["conv_w"].shape[-1]
    c_lo = d_in + (tp.active().rank * width if sharded else 0)
    h = xe.part()
    proj = h @ p["in_proj"]
    if sharded:
        proj = tp.gather_sum(proj, -1)
    z, _, _, _, dt = _split_proj(cfg, proj)
    z, dt = _own(z[..., heads], sharded), _own(dt[..., lo:lo + n], sharded)
    xbc, new_conv = conv(p["conv_w"], p["conv_b"],
                         _own(proj[..., c_lo:c_lo + width], sharded))
    del proj
    xbc = F.silu(xbc)
    if sharded:
        xbc = tp.gather_sum(xbc, -1)
    return (h, z, _own(xbc[..., heads], sharded), dt,
            _own(xbc[..., d_in:d_in + gn], sharded),
            _own(xbc[..., d_in + gn:], sharded), new_conv, n, sharded)


def _own(t: torch.Tensor, copy: bool) -> torch.Tensor:
    """A slice of a gathered tensor as a tensor of its own (``copy``), or
    as it is."""
    return t.contiguous() if copy else t


def _mixer_out(cfg: ArchConfig, p: Tree, y: torch.Tensor, z: torch.Tensor,
               sharded: bool) -> torch.Tensor:
    """``(out_norm(y) * silu(z)) @ out_proj`` back in the residual stream:
    y over the rank's heads, normalized over all of d_in."""
    _, d_in, _, _ = mamba_dims(cfg)
    y = tp.rms_norm(y, p["out_norm"], d_in) * F.silu(z)
    return tp.row(y, p["out_proj"], d_in, sharded)


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


def mamba_seq(cfg: ArchConfig, p: Tree, u, ssm_state: torch.Tensor,
              conv_state: torch.Tensor):
    """u (B,S,D) the block input (under tensor parallelism its
    ``tp.Enter``: the whole sequence is read); ssm_state (B,H,P,N)
    float32 over the rank's heads; conv_state (B,K-1,channels) over the
    rank's convolution channels.

    Returns (y (B,S,D) in the residual stream's layout, new ssm_state,
    new conv_state)."""
    s, _, _, _ = mamba_dims(cfg)
    u, z, x, dt, Bc, Cc, new_conv, H, sharded = _mixer_inputs(
        cfg, p, _entered(u),
        lambda w, b, xbc: _causal_conv_seq(w, b, xbc, conv_state))
    B_, S, _ = u.shape
    P = s.head_dim
    x = x.reshape(B_, S, H, P)

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
    y = y.reshape(B_, S, H * P).to(u.dtype)
    out = _mixer_out(cfg, p, y, z, sharded)
    return (shard_hint(out, ("batch", "act_seq", "act_embed")), ssm_state,
            new_conv)


def mamba_step(cfg: ArchConfig, p: Tree, u, ssm_state: torch.Tensor,
               conv_state: torch.Tensor):
    """One token: u (B,D) (or its ``tp.Enter``), the states as
    ``mamba_seq``'s. Returns (y (B,D), new ssm_state, new conv_state)."""
    s, _, _, _ = mamba_dims(cfg)
    u, z, x, dt, Bc, Cc, new_conv, H, sharded = _mixer_inputs(
        cfg, p, _entered(u),
        lambda w, b, xbc: _causal_conv_step(w, b, xbc, conv_state))
    B_ = u.shape[0]
    P = s.head_dim
    x = x.reshape(B_, H, P).to(torch.float32)
    Bc = Bc.to(torch.float32)
    Cc = Cc.to(torch.float32)

    A = -torch.exp(p["a_log"].to(torch.float32))
    dt = F.softplus(dt.to(torch.float32)
                    + p["dt_bias"].to(torch.float32))          # (B,H)
    a = torch.exp(dt * A)
    dBx = torch.einsum("bhp,bn->bhpn", x * dt[..., None], Bc)
    ssm_state = a[..., None, None] * ssm_state + dBx
    y = torch.einsum("bhpn,bn->bhp", ssm_state, Cc)
    y = y + p["d_skip"][None, :, None].to(torch.float32) * x
    y = y.reshape(B_, H * P).to(u.dtype)
    return _mixer_out(cfg, p, y, z, sharded), ssm_state, new_conv

