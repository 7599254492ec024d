"""RWKV6 "Finch": the attention-free LM with a data-dependent decay
(arXiv:2404.05892).

Held against ``repro.models.rwkv6``: ``DECAY_LORA``, the time-mix,
channel-mix and layer specs, ``_shift``, ``_decay``, the ``CHUNK``
module switch with ``_chunked_recurrence``, ``time_mix_seq``,
``time_mix_step``, ``channel_mix_seq``, ``channel_mix_step`` and
``RWKVLM`` (``param_specs``, ``init``, ``forward``, ``loss``,
``cache_struct``, ``init_cache``, ``decode_step``, ``prefill``).

Time-mix recurrence per head (state S (hd, hd)):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

with the decay w_t = exp(-exp(w0 + tanh(x W_a) W_b)) in float32. The
channel mix is the squared-ReLU receptance FFN; token shift mixes each
token with the one before by learned static ratios ``mu``.

Parameters are a flat dict in the reference's leaf order
(``embed.head``, ``embed.tok``, ``final_norm.gamma``, ``layers.cm.mu``,
..., ``layers.tm.wv``); the ``layers.*`` leaves carry the stacked layer
axis and a Python loop over layers replaces the reference's ``lax.scan``
(with ``remat``, the default, each layer under ``models.common.remat``,
as the reference checkpoints its scan body). ``CHUNK = 0`` (the
default, as in the reference) runs the recurrence one token at a time.

The cache is the stacked recurrent state, O(1) in the sequence:
``state`` (L, B, H, hd, hd) float32, ``tm_prev`` and ``cm_prev``
(L, B, D) bfloat16. ``decode_step`` writes the new state into the cache
it is given and returns that same dict (a leaf whose dtype the step's
output does not share is replaced by a new one of the output's dtype, as
the reference's scan stacks its outputs; the step reads the old one).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (
    ParamSpec,
    cross_entropy_loss,
    init_params,
    prefixed,
    abstract_params,
    remat,
    rms_norm,
    shard_hint,
    stack_specs,
    store_layer,
    subtree,
    time_scan,
    unstack,
)
from repro_torch.models.convert import in_leaf_order
from repro_torch.models.layers import embed_tokens, embedding_specs, lm_head

Tree = Dict[str, torch.Tensor]
DECAY_LORA = 64

# when > 0, the training path's recurrence takes the chunk-parallel form
# with this intra-chunk length (another float32 summation order);
# 0 => the sequential recurrence
CHUNK = 0


def time_mix_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    h, hd = cfg.n_heads, cfg.head_dim
    return {
        "mu": ParamSpec((4, d), (None, "embed"), "uniform", scale=0.5),
        "wr": ParamSpec((d, d), ("embed", "heads_fused"), "normal"),
        "wk": ParamSpec((d, d), ("embed", "heads_fused"), "normal"),
        "wv": ParamSpec((d, d), ("embed", "heads_fused"), "normal"),
        "wg": ParamSpec((d, d), ("embed", "heads_fused"), "normal"),
        "wo": ParamSpec((d, d), ("heads_fused", "embed"), "normal"),
        # data-dependent decay LoRA (w0 + tanh(x A) B)
        "w0": ParamSpec((d,), ("embed",), "zeros"),
        "wa": ParamSpec((d, DECAY_LORA), ("embed", None), "normal"),
        "wb": ParamSpec((DECAY_LORA, d), (None, "embed"), "normal",
                         scale=0.1),
        "u": ParamSpec((h, hd), ("heads", "head_dim"), "uniform",
                        scale=0.5),
        "ln_x": ParamSpec((d,), ("embed",), "ones"),
    }


def channel_mix_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu": ParamSpec((2, d), (None, "embed"), "uniform", scale=0.5),
        "wk": ParamSpec((d, f), ("embed", "d_ff"), "normal"),
        "wv": ParamSpec((f, d), ("d_ff", "embed"), "normal"),
        "wr": ParamSpec((d, d), ("embed", "embed_out"), "normal"),
    }


def layer_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    return {"ln1.gamma": ParamSpec((d,), ("embed",), "ones"),
            "ln2.gamma": ParamSpec((d,), ("embed",), "ones"),
            **prefixed("tm.", time_mix_specs(cfg)),
            **prefixed("cm.", channel_mix_specs(cfg))}


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift over the sequence: rows become [prev, x_0, ...,
    x_{S-2}] (in the promoted dtype, as the reference's concatenate)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _decay(p: Tree, x: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay in (0, 1): exp(-exp(w0 + tanh(x A) B)), the
    sum in the parameters' dtype, the exponentials in float32."""
    loraw = torch.tanh(x @ p["wa"]) @ p["wb"]
    return torch.exp(-torch.exp((p["w0"] + loraw).to(torch.float32)))


def _chunked_recurrence(rt, kt, vt, wt, u, state):
    """Chunk-parallel RWKV6 recurrence. rt/kt/vt/wt (B,S,H,K) float32
    (wt in (0, 1)); state (B,H,K,V). With the chunk's entry state S0 and
    A_t = prod_{j<=t} w_j per channel:

        o_t = (r_t . A_{t-1}) S0 + sum_{i<t} (r_t . A_{t-1}/A_i . k_i) v_i
              + (r_t . u . k_t) v_t
        S_c = diag(A_c) S0 + sum_i diag(A_c / A_i) k_i v_i^T

    Returns (new state, o (B,S,H,K))."""
    B, S, H, K = rt.shape
    c = CHUNK
    if S % c:
        raise ValueError(f"sequence {S} is not a multiple of CHUNK {c}")
    nc = S // c

    def to_chunks(x):
        return x.reshape(B, nc, c, H, K).transpose(0, 1)   # (nc,B,c,H,K)

    rs, ks, vs, ws = map(to_chunks, (rt, kt, vt, wt))
    eye = torch.eye(c, dtype=torch.float32, device=rt.device)
    tri = torch.tril(torch.ones(c, c, dtype=torch.float32,
                                device=rt.device), diagonal=-1)  # i < t

    def chunk(S0, i):
        r, k, v, w = rs[i], ks[i], vs[i], ws[i]            # (B,c,H,K)
        A = torch.cumprod(w, dim=1)
        A_prev = torch.cat([torch.ones_like(A[:, :1]), A[:, :-1]], dim=1)
        r_dec = r * A_prev                                 # r_t . A_{t-1}
        k_dec = k / torch.clamp(A, min=1e-30)              # k_i / A_i
        inter = torch.einsum("bchk,bhkv->bchv", r_dec, S0)
        M = torch.einsum("bchk,bihk->bhci", r_dec, k_dec) * tri[None, None]
        diag = torch.einsum("bchk,bchk->bhc", r, u[None, None] * k)
        M = M + diag[..., None] * eye[None, None]
        o = inter + torch.einsum("bhci,bihv->bchv", M, v)
        A_c = A[:, -1]                                     # (B,H,K)
        S_new = A_c[..., None] * S0 + torch.einsum(
            "bchk,bchv->bhkv", k_dec * A_c[:, None], v)
        return S_new, o

    state, os_ = time_scan(chunk, state, nc)               # (nc,B,c,H,K)
    return state, os_.transpose(0, 1).reshape(B, S, H, K)


def time_mix_seq(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                 prev_x: torch.Tensor, state: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence time mix. x (B,S,D); prev_x (B,D) the last token
    before the sequence; state (B,H,hd,hd). Returns (out (B,S,D), the
    new prev_x, the new state)."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    xs = _shift(x, prev_x)
    mu = p["mu"]
    xr = x + (xs - x) * mu[0]
    xk = x + (xs - x) * mu[1]
    xv = x + (xs - x) * mu[2]
    xw = x + (xs - x) * mu[3]
    r = (xr @ p["wr"]).reshape(B, S, H, hd).to(torch.float32)
    k = (xk @ p["wk"]).reshape(B, S, H, hd).to(torch.float32)
    v = (xv @ p["wv"]).reshape(B, S, H, hd).to(torch.float32)
    g = F.silu(xv @ p["wg"])
    w = _decay(p, xw).reshape(B, S, H, hd)                     # f32 in (0,1)
    u = p["u"].to(torch.float32)

    if CHUNK and S % CHUNK == 0:
        state, o = _chunked_recurrence(r, k, v, w, u,
                                       state.to(torch.float32))
    else:
        def step(S_state, t):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]     # (B,H,hd,hd)
            o = torch.einsum("bhi,bhij->bhj", r[:, t],
                             S_state + u[None, :, :, None] * kv)
            return w[:, t, :, :, None] * S_state + kv, o

        state, o = time_scan(step, state.to(torch.float32), S)
        o = o.transpose(0, 1)                                  # (B,S,H,hd)
    o = o.reshape(B, S, D).to(x.dtype)
    o = rms_norm(o, p["ln_x"]) * g
    out = o @ p["wo"]
    return (shard_hint(out, ("batch", "act_seq", "act_embed")), x[:, -1, :],
            state)


def time_mix_step(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                  prev_x: torch.Tensor, state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token: x (B,D); state (B,H,hd,hd) float32."""
    B, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    mu = p["mu"]
    xr = x + (prev_x - x) * mu[0]
    xk = x + (prev_x - x) * mu[1]
    xv = x + (prev_x - x) * mu[2]
    xw = x + (prev_x - x) * mu[3]
    r = (xr @ p["wr"]).reshape(B, H, hd).to(torch.float32)
    k = (xk @ p["wk"]).reshape(B, H, hd).to(torch.float32)
    v = (xv @ p["wv"]).reshape(B, H, hd).to(torch.float32)
    g = F.silu(xv @ p["wg"])
    w = _decay(p, xw).reshape(B, H, hd)
    u = p["u"].to(torch.float32)
    kv = k[..., :, None] * v[..., None, :]
    o = torch.einsum("bhi,bhij->bhj", r, state + u[None, :, :, None] * kv)
    new_state = w[..., :, None] * state + kv
    o = o.reshape(B, D).to(x.dtype)
    o = rms_norm(o, p["ln_x"]) * g
    return o @ p["wo"], x, new_state


def channel_mix_seq(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                    prev_x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    xs = _shift(x, prev_x)
    mu = p["mu"]
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    k = torch.square(F.relu(xk @ p["wk"]))
    k = shard_hint(k, ("batch", "seq", "act_ff"))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x[:, -1, :]


def channel_mix_step(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                     prev_x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    mu = p["mu"]
    xk = x + (prev_x - x) * mu[0]
    xr = x + (prev_x - x) * mu[1]
    k = torch.square(F.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x


class RWKVLM:
    def __init__(self, cfg: ArchConfig, remat: bool = True):
        if cfg.family != "ssm" or not cfg.name.startswith("rwkv"):
            raise ValueError(f"{cfg.name}: RWKVLM builds the rwkv configs "
                             "of the ssm family")
        self.cfg = cfg
        self.remat = remat

    def param_specs(self) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        return in_leaf_order({
            **prefixed("embed.", embedding_specs(cfg)),
            "final_norm.gamma": ParamSpec((cfg.d_model,), ("embed",),
                                        "ones"),
            **prefixed("layers.", stack_specs(cfg.n_layers,
                                              layer_specs(cfg))),
        })

    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None) -> Tree:
        return init_params(self.param_specs(), generator, device)

    def abstract_params(self) -> Tree:
        return abstract_params(self.param_specs())

    # -------------------------------------------------------------- #
    def _layer_seq(self, lp: Tree, x: torch.Tensor, st: Tree
                   ) -> Tuple[torch.Tensor, Tree]:
        cfg = self.cfg
        h = rms_norm(x, lp["ln1.gamma"])
        tm_out, tm_prev, tm_state = time_mix_seq(
            cfg, subtree(lp, "tm."), h, st["tm_prev"], st["state"])
        x = x + tm_out
        h2 = rms_norm(x, lp["ln2.gamma"])
        cm_out, cm_prev = channel_mix_seq(cfg, subtree(lp, "cm."), h2,
                                          st["cm_prev"])
        x = x + cm_out
        return x, {"state": tm_state, "tm_prev": tm_prev,
                   "cm_prev": cm_prev}

    def _zero_layer_state(self, B: int, device) -> Tree:
        cfg = self.cfg
        return {
            "state": torch.zeros((B, cfg.n_heads, cfg.head_dim,
                                  cfg.head_dim), dtype=torch.float32,
                                 device=device),
            "tm_prev": torch.zeros((B, cfg.d_model), dtype=torch.bfloat16,
                                   device=device),
            "cm_prev": torch.zeros((B, cfg.d_model), dtype=torch.bfloat16,
                                   device=device),
        }

    def _train_layer(self, lp: Tree, x: torch.Tensor
                     ) -> Tuple[torch.Tensor]:
        """One layer of the training forward from zero states."""
        x, _ = self._layer_seq(lp, x,
                               self._zero_layer_state(x.shape[0], x.device))
        return (x,)

    def _head(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["final_norm.gamma"])
        return lm_head(self.cfg, subtree(params, "embed."), x)

    def forward(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, S, V), a float32 zero: no auxiliary loss)."""
        x = embed_tokens(self.cfg, subtree(params, "embed."),
                         batch["tokens"])
        for lp in unstack(params, "layers.", self.cfg.n_layers):
            if self.remat:
                x, = remat(self._train_layer, lp, x)
            else:
                x, = self._train_layer(lp, x)
        return self._head(params, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    def loss(self, params: Tree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        logits, _ = self.forward(params, batch)
        return cross_entropy_loss(logits[:, :-1, :], batch["labels"][:, 1:])

    # -------------------------------------------------------------- #
    # decode: the cache is the stacked recurrent state, O(1) in seq
    # -------------------------------------------------------------- #
    def cache_struct(self, batch_size: int, cache_len: int
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        cfg = self.cfg
        L, B = cfg.n_layers, batch_size
        return {
            "state": ((L, B, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                      torch.float32),
            "tm_prev": ((L, B, cfg.d_model), torch.bfloat16),
            "cm_prev": ((L, B, cfg.d_model), torch.bfloat16),
        }

    def cache_axes(self) -> Dict[str, tuple]:
        return {
            "state": ("layers", "batch", "heads", "head_dim", None),
            "tm_prev": ("layers", "batch", "act_embed"),
            "cm_prev": ("layers", "batch", "act_embed"),
        }

    def init_cache(self, batch_size: int, cache_len: int,
                   device: Optional[torch.device] = None) -> Tree:
        return {k: torch.zeros(sh, dtype=dt, device=device)
                for k, (sh, dt) in self.cache_struct(batch_size,
                                                     cache_len).items()}

    def abstract_cache(self, batch_size: int, cache_len: int) -> Tree:
        return self.init_cache(batch_size, cache_len, torch.device("meta"))

    def decode_step(self, params: Tree, token: torch.Tensor,
                    pos: torch.Tensor, cache: Tree
                    ) -> Tuple[torch.Tensor, Tree]:
        """token (B,) int; pos (B,) (unused: the state carries position);
        returns (logits (B, V), cache), the same dict, updated."""
        cfg = self.cfg
        src = dict(cache)                  # the leaves the step reads
        x = params["embed.tok"][token]
        for i, lp in enumerate(unstack(params, "layers.", self.cfg.n_layers)):
            h = rms_norm(x, lp["ln1.gamma"])
            tm_out, tm_prev, state = time_mix_step(
                cfg, subtree(lp, "tm."), h,
                src["tm_prev"][i].to(h.dtype), src["state"][i])
            y = x + tm_out
            h2 = rms_norm(y, lp["ln2.gamma"])
            cm_out, cm_prev = channel_mix_step(
                cfg, subtree(lp, "cm."), h2, src["cm_prev"][i].to(h2.dtype))
            x = y + cm_out
            store_layer(cache, "state", i, state)
            store_layer(cache, "tm_prev", i, tm_prev.to(torch.bfloat16))
            store_layer(cache, "cm_prev", i, cm_prev.to(torch.bfloat16))
        return self._head(params, x), cache

    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Tree]:
        """Forward over the prompt: (logits (B, S, V), the recurrent state
        after it, stacked (L, ...), in the dtypes the layers produce)."""
        x = embed_tokens(self.cfg, subtree(params, "embed."),
                         batch["tokens"])
        zero_st = self._zero_layer_state(x.shape[0], x.device)
        cache: Tree = {}
        for i, lp in enumerate(unstack(params, "layers.", self.cfg.n_layers)):
            x, st = self._layer_seq(lp, x, zero_st)
            for k, v in st.items():
                store_layer(cache, k, i, v, self.cfg.n_layers)
        return self._head(params, x), cache
